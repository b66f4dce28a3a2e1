"""Logical-axis partitioning — the port of ``repro.distributed.partitioning``.

Model code never names mesh axes; it tags tensors with *logical* axes
(``'batch'``, ``'embed'``, ``'heads'``, ``'expert'``, ...).  A rule table
maps logical axes onto the physical mesh:

    single pod : (data=16, model=16)
    multi-pod  : (pod=2, data=16, model=16)

Design.  The rules are data, resolved exactly as the reference resolves
them, and a spec is a plain tuple whose entries are ``None``, a mesh axis
name or a tuple of them: it compares equal, entry by entry, to
``tuple(jax.sharding.PartitionSpec(...))``.  What differs is execution.
The port's mesh is one process driving a grid of devices, one stream per
position (``launch.mesh``; positions may repeat a device), so there is no
compiler to hand a sharding constraint to:

* :func:`pshard` is an identity on the tensor.  Under an active mesh it
  resolves the tensor's spec, which checks that the tags match its rank;
  it moves nothing.  Off a mesh it returns its argument untouched.
* :func:`make_shardings` returns :class:`NamedSharding` records — a frozen
  ``(mesh, spec)`` pair — and :func:`place` / :func:`gather` turn a tensor
  into per-position shards on the mesh's devices (a :class:`Sharded`) and
  back.  Positions on the tensor's own device hold views, so placing on a
  mesh of one device copies nothing.

DTensor is not used: its placements need one process per device, which the
one-process mesh of sharded serving rules out.

Rule sets:
  * BASE_RULES      — DP over (pod, data); TP over model (heads/mlp/vocab/
                      experts); everything else replicated.
  * FSDP extension  — ``'embed' -> 'data'`` (ZeRO-3 weight and optimizer
                      sharding for the large archs, ``cfg.fsdp``).
  * ``'kv_seq' -> 'data'`` — sequence-sharded KV caches for long-context
    decode.
  * SR_RULES        — the SR serving mesh: frame rows over ``bands``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Callable, Dict, Optional, Sequence, Tuple, Union

import torch

__all__ = [
    "BASE_RULES",
    "SR_RULES",
    "fsdp_rules",
    "serve_rules",
    "long_context_rules",
    "sr_rules",
    "axis_rules",
    "current_mesh",
    "logical_to_spec",
    "shape_aware_spec",
    "pshard",
    "NamedSharding",
    "Sharded",
    "make_shardings",
    "map_with_axes",
    "place",
    "gather",
]

MeshAxes = Union[None, str, Tuple[str, ...]]
Spec = Tuple[MeshAxes, ...]  # the counterpart of a PartitionSpec

# Logical axis -> mesh axes. 'pod' exists only in the multi-pod mesh; rules
# referencing missing mesh axes are filtered per-mesh in logical_to_spec.
BASE_RULES: Dict[str, MeshAxes] = {
    "batch": ("pod", "data"),  # DP: global batch over pods x data
    "vocab": "model",  # TP: embedding/logit vocab dim
    "heads": "model",  # TP: attention query heads
    "kv_heads": "model",  # TP: KV heads
    "mlp": "model",  # TP: FFN hidden
    "expert": "model",  # EP: MoE experts
    "expert_mlp": "model",  # expert hidden dim; -> 'data' in serve rules
    "ssm_heads": "model",  # TP: SSM heads
    "ssm_pdim": "model",  # SSD per-head dim fallback
    "embed": None,  # replicated unless FSDP
    "kv_lora": None,  # MLA compressed dim (small; replicated)
    "seq": None,  # activations: sequence
    "act_seq": "model",  # residual stream between blocks (sequence parallel)
    "kv_seq": None,  # KV-cache sequence (set to 'data' for long decode)
    "layers": None,  # the stacked-layer axis
    "head_dim": "model",  # fallback TP when head counts don't divide the axis
    "norm": None,
    "frontend": None,
}


def fsdp_rules(base: Optional[Dict[str, MeshAxes]] = None) -> Dict[str, MeshAxes]:
    """ZeRO-3: shard the weight 'embed' dim across the data axis too."""
    rules = dict(base or BASE_RULES)
    rules["embed"] = "data"
    return rules


def serve_rules(base: Optional[Dict[str, MeshAxes]] = None) -> Dict[str, MeshAxes]:
    """Inference: no optimizer state, so no FSDP; expert weights shard
    their hidden dim across 'data' instead."""
    rules = dict(base or BASE_RULES)
    rules["expert_mlp"] = "data"
    return rules


def long_context_rules(base: Optional[Dict[str, MeshAxes]] = None) -> Dict[str, MeshAxes]:
    """Sequence-shard KV caches across 'data' (long decode, batch 1)."""
    rules = dict(base or BASE_RULES)
    rules["kv_seq"] = "data"
    return rules


# SR serving mesh (engine.sharding): frame batches are (N, H, W, C).  The
# batch dim rides the 'replica' axis only at the routing layer, and row
# bands shard over 'bands'; width and channels stay replicated (the tilted
# decomposition is row-wise, so the halo is row-only).
SR_RULES: Dict[str, MeshAxes] = {
    "sr_batch": "replica",
    "sr_rows": "bands",
    "sr_cols": None,
    "sr_chan": None,
}


def sr_rules() -> Dict[str, MeshAxes]:
    """Rule table for the SR serving mesh (fresh copy, safe to mutate)."""
    return dict(SR_RULES)


class _Ctx(threading.local):
    mesh = None
    rules: Optional[Dict[str, MeshAxes]] = None


_CTX = _Ctx()


@contextlib.contextmanager
def axis_rules(mesh, rules: Optional[Dict[str, MeshAxes]] = None):
    """Activate a mesh + rule table for this thread (pshard, make_shardings,
    the data pipeline's placement)."""
    prev = (_CTX.mesh, _CTX.rules)
    _CTX.mesh, _CTX.rules = mesh, dict(rules or BASE_RULES)
    try:
        yield
    finally:
        _CTX.mesh, _CTX.rules = prev


def current_mesh():
    return _CTX.mesh


def _mesh_sizes(mesh) -> Dict[str, int]:
    return dict(zip(mesh.axis_names, mesh.shape)) if mesh is not None else {}


def _candidates(entry: MeshAxes) -> Tuple[str, ...]:
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _entry(kept: Sequence[str]) -> MeshAxes:
    if not kept:
        return None
    return kept[0] if len(kept) == 1 else tuple(kept)


def logical_to_spec(axes: Sequence[Optional[str]], mesh=None,
                    rules: Optional[Dict[str, MeshAxes]] = None) -> Spec:
    """Resolve logical axes to a spec valid for the given mesh.

    Mesh axes not present in the mesh (e.g. 'pod' on the single-pod mesh)
    are dropped; a mesh axis may appear at most once, first logical axis
    wins (later claims fall back to replication).
    """
    mesh = mesh or _CTX.mesh
    rules = rules or _CTX.rules or BASE_RULES
    names = set(_mesh_sizes(mesh))
    used = set()
    spec = []
    for ax in axes:
        entry = rules.get(ax) if ax is not None else None
        if entry is None:
            spec.append(None)
            continue
        cand = tuple(a for a in _candidates(entry) if a in names and a not in used)
        used.update(cand)
        spec.append(_entry(cand))
    return tuple(spec)


def shape_aware_spec(axes: Sequence[Optional[str]], shape: Sequence[int], mesh=None,
                     rules: Optional[Dict[str, MeshAxes]] = None) -> Spec:
    """Like :func:`logical_to_spec` but drops mesh axes that do not divide
    the corresponding dimension (e.g. 8 KV heads on a 16-way model axis ->
    replicated)."""
    mesh = mesh or _CTX.mesh
    rules = rules or _CTX.rules or BASE_RULES
    sizes = _mesh_sizes(mesh)
    used = set()
    spec = []
    for ax, dim in zip(axes, shape):
        entry = rules.get(ax) if ax is not None else None
        if entry is None:
            spec.append(None)
            continue
        kept, prod = [], 1
        for a in _candidates(entry):
            if a in sizes and a not in used and dim % (prod * sizes[a]) == 0:
                kept.append(a)
                prod *= sizes[a]
        used.update(kept)
        spec.append(_entry(kept))
    return tuple(spec)


def pshard(x: torch.Tensor, *axes: Optional[str]) -> torch.Tensor:
    """Tag an activation with logical axes.  Returns ``x`` itself; under an
    active mesh the tags must match its rank (ValueError otherwise)."""
    if _CTX.mesh is not None:
        if len(axes) != x.ndim:
            raise ValueError(f"pshard: {len(axes)} logical axes {axes} for a tensor of "
                             f"shape {tuple(x.shape)}")
        shape_aware_spec(axes, x.shape)
    return x


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh: the counterpart of ``jax.sharding.NamedSharding``."""

    mesh: object
    spec: Spec


@dataclasses.dataclass(frozen=True, eq=False)
class Sharded:
    """A tensor laid out on a mesh: ``shards[i]`` is flat position ``i``'s
    block, on that position's device (positions that share a block and a
    device share the tensor)."""

    sharding: NamedSharding
    shape: torch.Size
    shards: Tuple[torch.Tensor, ...]

    @property
    def dtype(self) -> torch.dtype:
        return self.shards[0].dtype


def map_with_axes(fn: Callable, axes_tree, tree):
    """``fn(axes, leaf)`` over a logical-axes tree (tuples at its leaves)
    and a tree of the same nested-dict structure."""
    if isinstance(axes_tree, dict):
        return {k: map_with_axes(fn, axes_tree[k], tree[k]) for k in sorted(axes_tree)}
    return fn(axes_tree, tree)


def make_shardings(axes_tree, shapes_tree, mesh=None, rules=None):
    """(logical axes, anything with ``.shape``) trees -> :class:`NamedSharding`
    tree, each spec resolved by :func:`shape_aware_spec`."""
    mesh = mesh or _CTX.mesh
    if mesh is None:
        raise ValueError("make_shardings requires a mesh (context or argument)")
    return map_with_axes(
        lambda axes, s: NamedSharding(mesh, shape_aware_spec(axes, s.shape, mesh, rules)),
        axes_tree, shapes_tree)


def _block_slices(shape: Sequence[int], sharding: NamedSharding):
    """Per flat position, the tuple of slices of its block of ``shape``."""
    mesh, spec = sharding.mesh, sharding.spec
    if len(spec) > len(shape):
        raise ValueError(f"spec {spec} has more entries than shape {tuple(shape)}")
    sizes = mesh.axis_sizes
    entries = tuple(spec) + (None,) * (len(shape) - len(spec))
    for dim, entry in zip(shape, entries):
        count = 1 if entry is None else math.prod(sizes[a] for a in _candidates(entry))
        if dim % count:
            raise ValueError(f"dimension {dim} of {tuple(shape)} does not split over "
                             f"{entry} ({count} ways) of spec {spec}")
    out = []
    for pos in range(mesh.size):
        coords = mesh.coords(pos)
        slices = []
        for dim, entry in zip(shape, entries):
            idx, count = 0, 1
            for a in (() if entry is None else _candidates(entry)):
                idx, count = idx * sizes[a] + coords[a], count * sizes[a]
            step = dim // count
            slices.append(slice(idx * step, (idx + 1) * step))
        out.append(tuple(slices))
    return out


def place(t: torch.Tensor, sharding: NamedSharding) -> Sharded:
    """``t`` split into the blocks ``sharding`` gives each mesh position, on
    that position's device (a view where it is ``t``'s own device)."""
    blocks = _block_slices(t.shape, sharding)
    shards = tuple(t[sl].to(dev) for sl, dev in zip(blocks, sharding.mesh.devices))
    return Sharded(sharding=sharding, shape=t.shape, shards=shards)


def gather(x: Sharded, device=None) -> torch.Tensor:
    """The whole tensor of ``x`` on ``device`` (default the mesh's first
    position's device), each block copied once."""
    device = torch.device(device) if device is not None else x.sharding.mesh.devices[0]
    out = torch.empty(x.shape, dtype=x.dtype, device=device)
    done = set()
    for sl, shard in zip(_block_slices(x.shape, x.sharding), x.shards):
        key = tuple((s.start, s.stop) for s in sl)
        if key not in done:
            out[sl] = shard.to(device)
            done.add(key)
    return out
