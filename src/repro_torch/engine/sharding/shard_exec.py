"""Band-sharded executor: the tilted band loop, one shard per mesh position.

Each position on the ``bands`` mesh axis owns a contiguous block of
``num_bands / band_shards`` whole bands (``H / S`` rows) of every frame.
For the ``zero``/``replicate`` vertical policies bands are independent and
the shards run with no communication at all.  For ``halo`` the only
cross-shard coupling is the L-row margin at the two shard edges: each
shard takes its neighbours' margins so that it can reconstruct exactly the
``(R + 2L)``-row slabs ``core.fusion.halo_slabs`` would have cut from the
zero-padded full frame:

  * a shard's extended rows ``cat([up, local, down])`` equal
    ``padded[s*H_local : s*H_local + H_local + 2L]`` of the L-zero-padded
    frame — the edge shards, which have no neighbour, take ZEROS, exactly
    the global zero padding;
  * local band ``b``'s slab is ``ext[b*R : b*R + R + 2L]`` and its global
    valid-row bounds are the same clip formulas ``halo_slabs`` uses with
    the global band index ``shard * bands_per_shard + b``, made on the
    shard's device.

Bit-exactness vs the single-device executor therefore holds by
construction: identical slab values, identical per-band bounds, identical
band kernel (the tilted sweep, or K1, which computes every band on its
own), identical epilogue (``executor.sr_epilogue``, row-block local).

One process drives every shard, as the JAX package's ``shard_map`` does.
On CUDA each position runs on the stream its mesh gave it: the executor
forks every shard stream from the caller's current stream, scatters the
row blocks (a view on a repeated device, a device-to-device copy
elsewhere), runs each shard — K1 once per shard, under the ``kernel``
backend — and joins the streams back into the caller's before it gathers
the HR row blocks there, so an event the caller records afterwards marks
the end of the whole call.  Every tensor that crosses streams is recorded
on the stream that reads it.  Nothing here waits on the host.

The row split comes from :func:`frame_spec`, the frame batch's spec
resolved through ``distributed.partitioning``'s ``SR_RULES`` (rows over
``bands``), as the reference's ``shard_map`` reads its ``in_specs``; the
scatter above is how the port carries that spec out.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Mapping, Sequence, Union

import torch

from repro_torch.core.fusion import tilted_fused_bands
from repro_torch.distributed.partitioning import Spec, logical_to_spec, sr_rules
from repro_torch.engine.executor import (
    PreparedStack,
    _stack_on,
    compute_dtype_for,
    sr_epilogue,
    sr_features,
)
from repro_torch.engine.sharding.mesh_plan import ShardedPlan
from repro_torch.launch.mesh import SR_BAND_AXIS, SRMesh

__all__ = [
    "build_sharded_executor",
    "frame_spec",
    "halo_exchange_bytes_per_frame",
    "stack_on",
]

# Logical axes of a frame batch (N, H, W, C), resolved against SR_RULES.
FRAME_AXES = ("sr_batch", "sr_rows", "sr_cols", "sr_chan")


def frame_spec(mesh: SRMesh) -> Spec:
    """The spec of a frame batch on ``mesh`` (rows over ``bands``)."""
    return logical_to_spec(FRAME_AXES, mesh, sr_rules())


def halo_exchange_bytes_per_frame(plan, band_shards: int) -> int:
    """Bytes moved across shard edges per frame (both directions).

    ``zero``/``replicate`` shard without communication; ``halo`` exchanges
    the L-row margin at each of the ``S - 1`` internal edges, in both
    directions, in the compute dtype.
    """
    if band_shards <= 1 or plan.vertical_policy != "halo":
        return 0
    itemsize = compute_dtype_for(plan.precision).itemsize
    edge_rows = plan.num_layers * plan.width * plan.in_channels
    return 2 * (band_shards - 1) * edge_rows * itemsize


def stack_on(stack: PreparedStack, device: torch.device) -> PreparedStack:
    """``stack`` on ``device`` (the stack itself when it is already there)."""
    if stack.layers[0].w.device == device:
        return stack
    return _stack_on(stack, device)


def _stream(stream):
    return contextlib.nullcontext() if stream is None else torch.cuda.stream(stream)


def _halo_features_local(plan, local, stack: PreparedStack, x: torch.Tensor,
                         up: torch.Tensor, down: torch.Tensor, shard: int) -> torch.Tensor:
    """Per-shard halo-policy features: re-slab, run, crop.

    ``x`` is this shard's ``(N, H/S, W, C0)`` row block in compute dtype,
    ``up``/``down`` its neighbours' L-row margins (zeros at the frame's
    edges); returns ``(N, H/S, W, ChL)`` features identical to the matching
    rows of the single-device halo path.
    """
    N, Hl, W, C0 = x.shape
    R, L = plan.band_rows, plan.num_layers
    Bl = local.num_bands
    slab = R + 2 * L
    ext = torch.cat([up, x, down], dim=1)  # padded[s*Hl : s*Hl+Hl+2L]
    slabs = torch.stack([ext[:, b * R : b * R + slab] for b in range(Bl)], dim=1)
    slabs = slabs.reshape(N * Bl, slab, W, C0)

    # Global valid-row bounds, same clip formulas as halo_slabs but with the
    # global band index, made on the shard's device; flat order n*Bl + b
    # matches the reshape above.
    g = shard * Bl + torch.arange(Bl, dtype=torch.int32, device=x.device)
    lo = (L - g * R).clamp(0, slab)
    hi = (L + plan.height - g * R).clamp(0, slab)
    bounds = torch.stack([lo, hi], dim=1).repeat(N, 1).to(torch.int32)

    if plan.backend == "kernel":
        from repro_torch.kernels import ops

        out = ops._tilted_fused_bands(
            slabs,
            stack.packed,
            tile_cols=plan.tile_cols,
            add_anchor=False,
            anchor_repeats=plan.scale * plan.scale,
            row_policy="zero",
            row_bounds=bounds,
            compute_dtype=x.dtype,
        )
    else:
        out = tilted_fused_bands(slabs, stack.layers, plan.tile_cols, "zero", bounds)
    out = out[:, L : L + R]  # crop the recompute margin
    return out.reshape(N, Hl, W, out.shape[-1])


def _stacks_for(stack, devices: Sequence[torch.device]) -> Dict[torch.device, PreparedStack]:
    if isinstance(stack, PreparedStack):
        return {d: stack_on(stack, d) for d in devices}
    missing = [d for d in devices if d not in stack]
    if missing:
        raise ValueError(f"no prepared stack for mesh devices {missing}")
    return {d: stack[d] for d in devices}


def build_sharded_executor(
    splan: ShardedPlan,
    stack: Union[PreparedStack, Mapping[torch.device, PreparedStack]],
    mesh: SRMesh,
):
    """Bind ``splan`` + prepared weights into a band-sharded frame-batch
    callable over ``mesh``.

    ``mesh`` must carry a ``bands`` axis of size ``spec.band_shards`` and no
    other axis longer than one (a replica's
    :func:`repro_torch.launch.mesh.band_submesh`, or any 1-D bands mesh).
    ``stack`` is one :class:`PreparedStack` (copied once to every other
    device of the mesh, here) or a mapping from each of the mesh's
    distinct devices to its own.  The callable takes an ``(N, H, W, C)``
    batch on the mesh's first device and returns the HR batch there.
    """
    spec = splan.spec
    sizes = mesh.axis_sizes
    if sizes.get(SR_BAND_AXIS) != spec.band_shards:
        raise ValueError(
            f"mesh bands axis {sizes.get(SR_BAND_AXIS)} != plan's "
            f"band_shards {spec.band_shards}"
        )
    if mesh.size != spec.band_shards:
        raise ValueError(
            f"mesh {mesh.axis_sizes} has axes besides {SR_BAND_AXIS!r}; pass "
            "one replica's band_submesh"
        )
    plan, local = splan.plan, splan.local_plan
    plan.check_invariants()
    devices, streams = mesh.devices, mesh.streams
    stacks = _stacks_for(stack, mesh.distinct_devices())
    rows_axis = frame_spec(mesh)[1]  # the mesh axis the frame rows split over
    S, L = sizes[rows_axis], plan.num_layers
    halo = S > 1 and plan.vertical_policy == "halo"
    home = devices[0]

    def fn(frames: torch.Tensor) -> torch.Tensor:
        if frames.ndim != 4:
            raise ValueError(
                f"expected a frame batch (N, H, W, C), got shape {tuple(frames.shape)}"
            )
        in_dtype = frames.dtype
        x = frames.to(home).to(compute_dtype_for(plan.precision))
        N, H, W, C0 = x.shape
        Hl = H // S
        caller = torch.cuda.current_stream(home) if home.type == "cuda" else None

        # scatter: fork every shard stream from the caller's, then place
        # each row block on its position (a view on the caller's device)
        blocks, ready = [], []
        for s in range(S):
            dev, st = devices[s], streams[s]
            if st is not None:
                st.wait_stream(caller)
            with _stream(st):
                blk = x[:, s * Hl : (s + 1) * Hl]
                if dev != home:
                    blk = blk.to(dev, non_blocking=True)
                elif st is not None:
                    x.record_stream(st)
                if st is not None:
                    ready.append(torch.cuda.Event())
                    ready[-1].record(st)
            blocks.append(blk)

        def margin(s: int, t: int, rows: slice) -> torch.Tensor:
            """Shard ``t``'s ``rows`` on shard ``s``'s device and stream
            (zeros past the frame's edge, as the global padding)."""
            dev, st = devices[s], streams[s]
            if not 0 <= t < S:
                return torch.zeros((N, L, W, C0), dtype=x.dtype, device=dev)
            if st is not None:
                st.wait_event(ready[t])
            part = blocks[t][:, rows]
            if devices[t] != dev:
                with _stream(streams[t]):  # the copy runs on the sender's stream
                    return part.to(dev, non_blocking=True)
            if st is not None:
                blocks[t].record_stream(st)
            return part

        outs = []
        for s in range(S):
            dev, st = devices[s], streams[s]
            stk = stacks[dev]
            with _stream(st):
                blk = blocks[s]
                if halo:
                    up = margin(s, s - 1, slice(Hl - L, Hl))
                    down = margin(s, s + 1, slice(0, L))
                    feats = _halo_features_local(plan, local, stk, blk, up, down, s)
                else:
                    # bands are shard-local (or there is one shard): the
                    # ordinary backend over the local row block IS the
                    # global computation
                    feats = sr_features(local, stk.layers, blk, packed=stk.packed)
                hr = sr_epilogue(local, blk, feats, in_dtype)
                if dev != home:
                    hr = hr.to(home, non_blocking=True)  # on this shard's stream
                elif st is not None:
                    hr.record_stream(caller)
            outs.append(hr)

        # join: the caller's stream waits for every shard, then gathers
        if caller is not None:
            for st in streams:
                caller.wait_stream(st)
        return outs[0] if S == 1 else torch.cat(outs, dim=1)

    fn.donates_frames = False
    fn.mesh = mesh
    fn.sharded_plan = splan
    return fn
