"""What one call costs, counted while it runs: the port's counterpart of
the reference's ``roofline/hlo_parse.py``.

The reference compiles each step and reads the compiled HLO: the FLOPs of
every dot and convolution (``while`` bodies times their trip counts), the
bytes every instruction moves, the bytes of every collective, and XLA's
own ``memory_analysis()``.  PyTorch has no HLO, so :func:`trace_cost`
runs the call itself under two dispatch modes and counts every operator
that goes through the dispatcher:

* ``torch.utils.flop_counter.FlopCounterMode`` counts the FLOPs of every
  matrix product, convolution and attention operator, forward and
  backward, 2 per multiply-add, as the HLO parser counts dots;
* :class:`LiveBytesMode` follows every storage an operator allocates, from
  its first output until its last tensor dies, and keeps the most bytes
  alive at once; it also sums the bytes each operator reads and writes.

The call may run on ``meta`` tensors, which carry shapes and dtypes and
allocate nothing, or on real ones (the card, the CPU): the same program
gives the same counts either way.  On ``meta`` tensors an operator's
output shapes, strides and dtypes depend on nothing but its inputs' and
its other arguments, so :class:`LiveBytesMode` computes them once per
distinct signature and makes fresh ``meta`` outputs after that (a flash
loop repeats a few signatures thousands of times; the outputs still count
as allocations).

What the count cannot see:

* **The partitioner.**  Nothing splits the program over a mesh, so a
  trace is one program at one batch.  Compute that a mesh would leave
  replicated (the reference's attention heads that do not divide a
  16-way ``model`` axis) does not show up: the dry-run's per-device FLOPs
  are the global FLOPs divided by the device count.  Collective bytes are
  not traced at all (``roofline.analytic.analytic_collective_bytes``
  models them).
* **Fusion.**  Elementwise operators count no FLOPs (the HLO parser counts
  none either), and each one's output is a storage of its own and is
  read back by the next, where a compiler would fuse them: the live bytes
  and the bytes moved are those of PyTorch's eager program, upper bounds
  on what a fused one holds and moves.
* **The caching allocator.**  Live bytes are tensor storages, not the
  allocator's rounded, cached blocks; ``torch.cuda.max_memory_allocated``
  on the card is the measured counterpart.
* **Arguments.**  Storages that exist before the call (parameters, cache,
  optimizer state, batch) are not counted as live bytes, nor is an
  in-place update of one; storages the call allocates are, its outputs
  included.
"""

from __future__ import annotations

import dataclasses
import weakref
from typing import Any, Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

__all__ = ["TraceCost", "LiveBytesMode", "trace_cost"]


@dataclasses.dataclass
class TraceCost:
    flops: int  # 2 per multiply-add of every product, forward and backward
    flops_by_op: Dict[str, int]  # the same, by aten operator
    peak_live_bytes: int  # the most bytes of storages the call allocated, alive at once
    bytes_accessed: int  # bytes every non-view operator read and wrote
    op_count: int  # aten operators dispatched
    memo_hits: int = 0  # of those, ``meta`` calls answered from the memo without running
    result: Any = dataclasses.field(default=None, repr=False)  # what the call returned


def _leaves(obj, out: list) -> list:
    """The non-container leaves of an operator's arguments or outputs."""
    if isinstance(obj, (list, tuple)):
        for o in obj:
            _leaves(o, out)
    elif isinstance(obj, dict):
        for o in obj.values():
            _leaves(o, out)
    else:
        out.append(obj)
    return out


class _Meta(tuple):
    """(shape, stride, dtype) of one ``meta`` output, as memoised."""


def _template(out):
    if isinstance(out, torch.Tensor):
        return _Meta((tuple(out.shape), out.stride(), out.dtype))
    if type(out) in (tuple, list):
        return type(out)(_template(o) for o in out)
    return out


def _rebuild(tpl):
    if isinstance(tpl, _Meta):
        return torch.empty_strided(tpl[0], tpl[1], dtype=tpl[2], device="meta")
    if type(tpl) in (tuple, list):
        return type(tpl)(_rebuild(t) for t in tpl)
    return tpl


def _memo_key(func, leaves):
    """A hashable signature of a call with no tensor off ``meta``, or None
    where the call's outputs need not follow from it alone (a factory's
    outputs are memoised only where they too lie on ``meta``)."""
    parts = [func]
    for x in leaves:
        if isinstance(x, torch.Tensor):
            if x.device.type != "meta":
                return None
            parts.append((tuple(x.shape), x.stride(), x.dtype))
        else:
            parts.append((type(x), x))  # 1, 1.0 and True promote differently
    key = tuple(parts)
    try:
        hash(key)
    except TypeError:
        return None
    return key


class LiveBytesMode(TorchDispatchMode):
    """Counts dispatched operators, the bytes each one reads and writes, and
    the bytes of the storages they allocate while those storages live.
    Storages of tensors listed in ``existing`` (the call's arguments) are
    never counted as live."""

    def __init__(self, existing=()):
        super().__init__()
        self.skip = {t.untyped_storage()._cdata for t in existing}
        self.live: Dict[int, tuple] = {}  # storage key -> (nbytes, weakref holding the callback)
        self.live_bytes = 0
        self.peak_bytes = 0
        self.bytes_accessed = 0
        self.op_count = 0
        self.memo_hits = 0
        self._memo: Dict[tuple, Any] = {}  # signature -> output template
        self._pure: Dict[Any, bool] = {}  # operator -> neither a view nor mutating

    def _freed(self, key: int) -> None:
        nbytes, _ = self.live.pop(key)
        self.live_bytes -= nbytes

    def _is_pure(self, func) -> bool:
        pure = self._pure.get(func)
        if pure is None:
            schema = func._schema
            pure = not schema.is_mutable and not any(r.alias_info for r in schema.returns)
            self._pure[func] = pure
        return pure

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        self.op_count += 1
        leaves = _leaves((args, kwargs), [])
        in_tensors = [t for t in leaves if isinstance(t, torch.Tensor)]
        key = _memo_key(func, leaves) if self._is_pure(func) else None
        tpl = self._memo.get(key) if key is not None else None
        if tpl is not None:
            self.memo_hits += 1
            out = _rebuild(tpl)
            out_tensors = [t for t in _leaves(out, []) if isinstance(t, torch.Tensor)]
            aliased = False  # only calls that allocate every output are memoised
        else:
            out = func(*args, **kwargs)
            out_tensors = [t for t in _leaves(out, []) if isinstance(t, torch.Tensor)]
            # a view, an in-place update, or an operator that returns its input
            # (``_unsafe_view``): some output shares an input's storage
            in_storages = {t.untyped_storage()._cdata for t in in_tensors}
            aliased = any(t.untyped_storage()._cdata in in_storages for t in out_tensors)
            if (key is not None and not aliased
                    and all(t.device.type == "meta" for t in out_tensors)):
                self._memo[key] = _template(out)
        if not aliased or func._schema.is_mutable:  # a view moves no bytes
            self.bytes_accessed += sum(t.numel() * t.element_size()
                                       for t in in_tensors + out_tensors)
        for t in out_tensors:
            st = t.untyped_storage()
            skey = st._cdata
            if skey in self.skip or skey in self.live:
                continue
            nbytes = st.nbytes()
            self.live[skey] = (nbytes, weakref.ref(st, lambda _, k=skey: self._freed(k)))
            self.live_bytes += nbytes
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        return out


def trace_cost(fn, *args, **kwargs) -> TraceCost:
    """Run ``fn(*args, **kwargs)`` under a FLOP counter and a live-bytes
    tracker; works on ``meta`` tensors and on real ones alike."""
    existing = [t for t in _leaves((args, kwargs), []) if isinstance(t, torch.Tensor)]
    flop_mode = FlopCounterMode(display=False)
    live = LiveBytesMode(existing)
    with live, flop_mode:  # the FLOP counter on top: it sees every operator first
        result = fn(*args, **kwargs)
    by_op = {str(op): int(n) for op, n in flop_mode.get_flop_counts().get("Global", {}).items()}
    return TraceCost(flops=int(flop_mode.get_total_flops()), flops_by_op=by_op,
                     peak_live_bytes=live.peak_bytes, bytes_accessed=live.bytes_accessed,
                     op_count=live.op_count, memo_hits=live.memo_hits, result=result)
