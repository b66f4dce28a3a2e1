"""Batched plan executor — one call per frame batch, any backend.

* ``reference`` — the full-image layerwise oracle over the frame batch.
* ``tilted``    — the plain PyTorch tilted sweep over a flat
  ``(N * num_bands, R, W, C)`` band axis.
* ``kernel``    — the hand-written CUDA kernel (K1) on the card, its plain
  version on the CPU; the same flat band axis becomes the kernel's grid
  (one CTA per band), so a batch of frames is ONE kernel launch
  (``kernels.ops.tilted_fused_frames``).

All backends share the anchor + pixel-shuffle epilogue and the plan's
numerics policy (fp32 / bf16 / int8 dequant-on-read weights).

Weight preparation has two homes: :func:`prepare_stack` builds a
device-resident :class:`PreparedStack` ONCE per weight stack and
:func:`build_stack_executor` binds it into the serving callable (this is
what ``SRSession`` serves through); :func:`run` / :func:`build_executor`
keep the self-contained signature (raw float layers in, preparation inside
the call).  PyTorch runs eagerly, so the per-(plan, bucket, dtype) callable
the session caches takes the place of a compiled program.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.fusion import (
    ConvLayer,
    conv_stack_reference,
    halo_slabs,
    tilted_fused_bands,
)
from repro_torch.core.quant import dequantize_layers, quantize_layers
from repro_torch.engine.plan import SRPlan
from repro_torch.models.abpn import depth_to_space, make_anchor

__all__ = [
    "OutputSpec",
    "prepare_layers",
    "prepare_stack",
    "PreparedStack",
    "build_band_executor",
    "build_executor",
    "build_stack_executor",
    "compute_dtype_for",
    "default_device",
    "executor_artifacts",
    "output_spec",
    "run",
    "sr_epilogue",
    "sr_features",
]


def default_device(device=None) -> torch.device:
    """The device an entry point runs on: ``device`` if given, else the
    CUDA card.  With no ``device`` and no CUDA this raises — entry points
    never carry on on the CPU unless the caller asks for it."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device and none is available; pass "
            "device='cpu' explicitly to run the plain versions on the CPU"
        )
    return torch.device("cuda", torch.cuda.current_device())


def prepare_layers(layers: Sequence[ConvLayer], precision: str) -> List[ConvLayer]:
    """Apply the plan's numerics policy to a float conv stack.

    ``fp32`` passes through; ``bf16`` casts weights/biases (activations are
    cast at the executor boundary); ``int8`` round-trips the weights through
    symmetric per-channel quantisation and computes in fp32
    (dequant-on-read).
    """
    if precision == "fp32":
        return list(layers)
    if precision == "bf16":
        return [l.to(dtype=torch.bfloat16) for l in layers]
    if precision == "int8":
        return dequantize_layers(quantize_layers(layers))
    raise ValueError(f"unknown precision {precision!r}")


@dataclasses.dataclass
class PreparedStack:
    """A weight stack with the plan's numerics + backend packing applied.

    Built ONCE per (weight stack, precision, backend) by
    :func:`prepare_stack`; ``packed`` is only populated for the ``kernel``
    backend (the launch's padded storage form).
    """

    layers: tuple  # Tuple[ConvLayer, ...], numerics applied
    packed: Optional[object]  # kernels.ops.PackedLayers | None
    precision: str
    backend: str

    def _tensors(self):
        for l in self.layers:
            yield l.w
            yield l.b
        if self.packed is not None:
            yield self.packed.w
            yield self.packed.b

    def nbytes(self) -> int:
        """Device bytes this stack holds (prepared + packed forms)."""
        return sum(t.numel() * t.element_size() for t in self._tensors())


def compute_dtype_for(precision: str) -> torch.dtype:
    """The on-chip compute dtype a precision policy implies (int8 stores
    quantised weights but computes dequantised in fp32)."""
    return torch.bfloat16 if precision == "bf16" else torch.float32


def prepare_stack(plan: SRPlan, layers: Sequence[ConvLayer]) -> PreparedStack:
    """Apply ``plan``'s numerics policy — and, for the ``kernel`` backend,
    the launch's weight pad/pack — producing a :class:`PreparedStack` on
    the layers' device."""
    prepared = tuple(prepare_layers(layers, plan.precision))
    packed = None
    if plan.backend == "kernel":
        from repro_torch.kernels import ops

        packed = ops.pack_stack(prepared, dtype=compute_dtype_for(plan.precision))
    return PreparedStack(
        layers=prepared, packed=packed, precision=plan.precision, backend=plan.backend
    )


# ----------------------------------------------------------------------
# Backend feature executors: (N, H, W, C0) -> (N, H, W, ChL)
# ----------------------------------------------------------------------
def _features_reference(plan: SRPlan, layers, frames: torch.Tensor) -> torch.Tensor:
    return conv_stack_reference(frames, layers)


def _features_tilted(plan: SRPlan, layers, frames: torch.Tensor) -> torch.Tensor:
    N, H, W, C0 = frames.shape
    R, L = plan.band_rows, plan.num_layers
    policy = plan.vertical_policy
    if policy in ("zero", "replicate"):
        bands = frames.reshape(N * plan.num_bands, R, W, C0)
        out = tilted_fused_bands(bands, layers, plan.tile_cols, row_pad=policy)
        return out.reshape(N, H, W, out.shape[-1])
    # halo: every band is the (R + 2L)-row slab of the zero-padded frame
    # starting at its own row offset, with its phantom rows masked per layer
    slabs, bounds = halo_slabs(frames, R, L)
    out = tilted_fused_bands(slabs, layers, plan.tile_cols, "zero", bounds)
    out = out[:, L : L + R]  # crop the recompute margin
    return out.reshape(N, H, W, out.shape[-1])


def _features_kernel(plan: SRPlan, layers, frames: torch.Tensor, packed=None) -> torch.Tensor:
    from repro_torch.kernels import ops

    # frames arrive already cast, so the compute dtype rides in on the
    # input dtype; ``packed`` (from a PreparedStack) skips the weight pack
    return ops.tilted_fused_frames(
        frames,
        layers,
        band_rows=plan.band_rows,
        tile_cols=plan.tile_cols,
        vertical_policy=plan.vertical_policy,
        compute_dtype=frames.dtype,
        packed=packed,
    )


_BACKENDS = {
    "reference": _features_reference,
    "tilted": _features_tilted,
}


def sr_features(plan: SRPlan, layers, frames: torch.Tensor, packed=None) -> torch.Tensor:
    """Run the plan's conv-stack backend over a frame batch (no epilogue).
    ``layers`` are assumed already numerics-prepared."""
    if plan.backend == "kernel":
        return _features_kernel(plan, layers, frames, packed)
    return _BACKENDS[plan.backend](plan, layers, frames)


def _execute_stack(plan: SRPlan, stack: PreparedStack, frames: torch.Tensor) -> torch.Tensor:
    """The per-batch computation over an already-prepared weight stack:
    the conv datapath + epilogue, nothing else."""
    if frames.ndim != 4:
        raise ValueError(
            f"expected a frame batch (N, H, W, C), got shape {tuple(frames.shape)}"
        )
    in_dtype = frames.dtype
    x = frames.to(compute_dtype_for(plan.precision))
    feats = sr_features(plan, stack.layers, x, packed=stack.packed)
    return sr_epilogue(plan, x, feats, in_dtype)


def sr_epilogue(plan: SRPlan, x: torch.Tensor, feats: torch.Tensor, in_dtype) -> torch.Tensor:
    """ABPN's residual epilogue: anchor add, pixel shuffle, clip, cast.

    Row-block local: ``depth_to_space`` maps LR row ``y`` to HR rows
    ``[y*s, y*s+s)``.
    """
    out = feats + make_anchor(x, plan.scale)
    hr = depth_to_space(out, plan.scale)
    if plan.clip:
        hr = torch.clamp(hr, 0.0, 1.0)
    return hr.to(in_dtype)


def _execute(plan: SRPlan, layers, frames: torch.Tensor) -> torch.Tensor:
    """``(plan, layers, frames) -> HR batch`` with weight preparation inside."""
    return _execute_stack(plan, prepare_stack(plan, layers), frames)


def _on_device(layers, device):
    return tuple(l.to(device=device) for l in layers)


def _frames_on(frames, device) -> torch.Tensor:
    if isinstance(frames, np.ndarray):
        frames = torch.from_numpy(frames)
    return frames.to(device)


def build_executor(
    plan: SRPlan, layers: Sequence[ConvLayer], device=None
) -> Callable[[torch.Tensor], torch.Tensor]:
    """Bind plan + weights into ``frames (N,H,W,C) -> HR (N,sH,sW,C)`` on
    ``device`` (default: the CUDA card; raises without one)."""
    plan.check_invariants()
    dev = default_device(device)
    bound = _on_device(layers, dev)
    return lambda frames: _execute(plan, bound, _frames_on(frames, dev))


def build_stack_executor(
    plan: SRPlan,
    stack: PreparedStack,
    *,
    donate_frames: bool = False,
) -> Callable[[torch.Tensor], torch.Tensor]:
    """The serving executor: bind plan + a :class:`PreparedStack` into
    ``frames (N,H,W,C) -> HR (N,sH,sW,C)`` on the stack's device.

    ``donate_frames`` is accepted for interface parity and is a no-op:
    eager PyTorch frees the frame slab when its last reference goes, so
    there is no buffer donation to request.
    """
    plan.check_invariants()
    return functools.partial(_execute_stack, plan, stack)


def _band_features(plan: SRPlan, stack: PreparedStack, slabs: torch.Tensor,
                   bounds: torch.Tensor) -> torch.Tensor:
    """Conv-stack features over an explicit band-slab stack.

    ``slabs`` is (k, rows, W, C0) with rows = R + 2L under ``halo`` (the
    ``core.fusion.halo_slabs`` geometry, ``bounds`` carrying each slab's
    valid-row interval) and rows = R otherwise.  Per band this runs the
    SAME per-band computation as the full-frame path — the tilted backend
    the same ``tilted_fused_bands`` sweep, the kernel backend the same K1
    launch over a band axis — and neither depends on how many bands share
    the call, so each output band is bit-identical to the same band of a
    full-frame run.  The reference backend has no band decomposition
    (:func:`build_band_executor` refuses it).
    """
    R, L = plan.band_rows, plan.num_layers
    policy = plan.vertical_policy
    if plan.backend == "kernel":
        from repro_torch.kernels import ops

        return ops.tilted_fused_band_stack(
            slabs,
            tile_cols=plan.tile_cols,
            vertical_policy=policy,
            row_bounds=bounds if policy == "halo" else None,
            compute_dtype=slabs.dtype,
            packed=stack.packed,
        )
    if policy in ("zero", "replicate"):
        return tilted_fused_bands(slabs, stack.layers, plan.tile_cols, row_pad=policy)
    out = tilted_fused_bands(slabs, stack.layers, plan.tile_cols, "zero", bounds)
    return out[:, L : L + R]  # crop the recompute margin


def _execute_band_stack(plan: SRPlan, stack: PreparedStack, slabs: torch.Tensor,
                        bounds: torch.Tensor) -> torch.Tensor:
    """Partial-band serving: (k, rows, W, C) input slabs plus (k, 2) int32
    valid-row bounds (read under ``halo`` only) -> (k, R*s, W*s, C) HR
    bands.  The epilogue is row-block local (:func:`sr_epilogue`), so
    running it on each band's own LR rows reproduces the full-frame
    epilogue's bytes for those rows exactly."""
    if slabs.ndim != 4:
        raise ValueError(
            f"expected a band-slab batch (k, rows, W, C), got {tuple(slabs.shape)}"
        )
    in_dtype = slabs.dtype
    x = slabs.to(compute_dtype_for(plan.precision))
    feats = _band_features(plan, stack, x, bounds)
    if plan.vertical_policy == "halo":
        L = plan.num_layers
        x = x[:, L : L + plan.band_rows]  # each slab's own (anchor) rows
    return sr_epilogue(plan, x, feats, in_dtype)


def build_band_executor(
    plan: SRPlan, stack: PreparedStack
) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
    """The partial-band executor ``(slabs, bounds) -> HR bands`` over a
    :class:`PreparedStack` (the temporal delta path's dispatch body)."""
    plan.check_invariants()
    if plan.backend == "reference":
        raise ValueError("reference backend cannot serve partial-band dispatches")
    return functools.partial(_execute_band_stack, plan, stack)


# ----------------------------------------------------------------------
# What one serving call runs (the program audit's input)
# ----------------------------------------------------------------------
# Runtime calls that make the host wait for the card.
SYNC_CALLS = frozenset({"cudaDeviceSynchronize", "cudaStreamSynchronize",
                        "cudaEventSynchronize", "cudaMemcpy", "cudaMemcpy2D"})
_CALL_MARK = "repro_torch::executor_call"


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (list, tuple)):
        for t in tree:
            yield from _tensors(t)
    elif isinstance(tree, dict):
        for t in tree.values():
            yield from _tensors(t)


def _record_ops(fn) -> List[dict]:
    """The aten ops one call of ``fn`` dispatches, in order: ``op``
    (``aten.<name>``), ``dtypes`` (of its tensor outputs), ``to_host`` (a
    tensor on an accelerator in, a tensor on the CPU out) and ``from_host``
    (a tensor on the CPU in, a tensor on an accelerator out)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    ops: List[dict] = []

    class _Recorder(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            ins = {t.device.type for t in _tensors((args, kwargs or {}))}
            outs = list(_tensors(out))
            out_devs = {t.device.type for t in outs}
            ops.append({
                "op": str(func.overloadpacket),
                "dtypes": [str(t.dtype).replace("torch.", "") for t in outs],
                "to_host": bool(ins - {"cpu"}) and "cpu" in out_devs,
                "from_host": "cpu" in ins and bool(out_devs - {"cpu"}),
            })
            return out

    with _Recorder():
        fn()
    return ops


_PROFILE_TRIES = 3


def _profile_call(fn, device: torch.device) -> dict:
    """What ``torch.profiler`` records for one call of ``fn`` on the card:
    ``kernels`` (device kernel names), ``memcpy`` (device copy kinds, e.g.
    ``Memcpy DtoH (Device -> Pageable)``) and ``syncs`` (the runtime calls
    in :data:`SYNC_CALLS` the call made).

    The card is idle when the window opens, so every device event in it is
    the call's; of the runtime calls, only those inside the call's own
    ``record_function`` span count — the profiler's, and the synchronize
    that closes the window, fall outside it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    # Now and then the profiler delivers no device event for a window (the
    # card's activity records are lost, not absent); the call is repeatable,
    # so a window is tried up to _PROFILE_TRIES times before that is an error.
    for _ in range(_PROFILE_TRIES):
        torch.cuda.synchronize(device)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            with record_function(_CALL_MARK):
                fn()
            torch.cuda.synchronize(device)
        events = list(prof.events())
        marks = [e for e in events if e.name == _CALL_MARK and e.device_type == DeviceType.CPU]
        if len(marks) != 1:
            raise RuntimeError(f"the profiler recorded {len(marks)} spans of the call, not 1")
        lo, hi = marks[0].time_range.start, marks[0].time_range.end
        # the call's own span is projected onto the device as well: not a kernel
        device_events = [e.name for e in events
                         if e.device_type == DeviceType.CUDA and e.name != _CALL_MARK]
        if device_events:
            break
    else:
        raise RuntimeError(f"torch.profiler recorded no device activity for the call in "
                           f"{_PROFILE_TRIES} windows")
    return {
        "kernels": [n for n in device_events if not n.startswith(("Memcpy", "Memset"))],
        "memcpy": [n for n in device_events if n.startswith("Memcpy")],
        "syncs": [e.name for e in events if e.device_type == DeviceType.CPU
                  and e.name in SYNC_CALLS
                  and lo <= e.time_range.start and e.time_range.end <= hi],
    }


def executor_artifacts(
    plan: SRPlan,
    stack: Optional[PreparedStack],
    batch: int,
    dtype=torch.float32,
    *,
    layers: Optional[Sequence[ConvLayer]] = None,
    compiled: bool = True,
) -> dict:
    """What one call of the serving executor (``_execute_stack``) runs for a
    ``(batch, *lr_shape)`` batch of ``dtype`` — what
    ``repro_torch.analysis.program_audit`` scans for forbidden patterns
    (quant ops, host transfers and waits, silent upcasts, builds):

    * ``ops`` — the aten ops of one call, recorded with a
      ``TorchDispatchMode``, with their output dtypes.  On the card K1 and
      K2 are ctypes launches, so they do not appear here.
    * ``kernels`` — with ``compiled=True`` and the stack on the card, the
      device kernels, memcpy kinds and synchronizing runtime calls that
      ``torch.profiler`` records for one more call; else ``None``.
    * ``builds`` — on the card, the kernel libraries the first call loaded
      (``(kernel, compiled by nvcc)``): a warmed executor loads none; on
      the CPU ``None``.

    Pass ``stack`` to audit exactly what serving runs; pass ``layers`` with
    ``stack=None`` to prepare the stack here.  The input is a zero batch on
    the stack's device.
    """
    if stack is None:
        if layers is None:
            raise ValueError("need a PreparedStack or raw layers")
        stack = prepare_stack(plan, layers)
    device = stack.layers[0].w.device
    frames = torch.zeros((int(batch), *plan.lr_shape), dtype=dtype, device=device)

    def call():
        return _execute_stack(plan, stack, frames)

    on_card = device.type == "cuda"
    if on_card:
        from repro_torch.kernels import _build

        before = len(_build.load_log())
    ops = _record_ops(call)
    return {
        "plan": plan,
        "batch": int(batch),
        "dtype": str(dtype).replace("torch.", ""),
        "ops": ops,
        "kernels": _profile_call(call, device) if compiled and on_card else None,
        "builds": _build.load_log()[before:] if on_card else None,
    }


@dataclasses.dataclass(frozen=True)
class OutputSpec:
    """Shape and dtype an executor emits for a batch."""

    shape: Tuple[int, ...]
    dtype: torch.dtype


def output_spec(plan: SRPlan, layers: Sequence[ConvLayer], batch: int, dtype) -> OutputSpec:
    """The shape/dtype the executor emits for a ``(batch, *lr_shape)`` input
    of ``dtype``: the HR shape of the plan, in the input dtype (the epilogue
    casts back).  Computed from the plan; nothing runs."""
    return OutputSpec(shape=(int(batch), *plan.hr_shape), dtype=dtype)


def run(plan: SRPlan, layers: Sequence[ConvLayer], frames, device=None) -> torch.Tensor:
    """One-shot convenience: run a frame batch through the plan on
    ``device`` (default: the CUDA card; raises without one).  ``frames`` is
    a tensor or numpy array ``(N, H, W, C)``; the result stays on the
    device."""
    dev = default_device(device)
    return _execute(plan, _on_device(layers, dev), _frames_on(frames, dev))
