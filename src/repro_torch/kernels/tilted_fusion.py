"""Tilted layer fusion on an NVIDIA Hopper card (K1): wrapper, plain version,
buffer accounting.

The kernel (``csrc/tilted_fusion.cu``, CUDA C++ for ``sm_90a``, its
products on the tensor cores through ``mma.sync``: fp32 as 3xTF32, bf16 as
m16n8k16 with fp32 accumulation) computes what the JAX package's Pallas
kernel
``src/repro/kernels/tilted_fusion.py::tilted_fusion_kernel`` computes: per
band, a sequential sweep over K column tiles; in each tile the whole L-layer
stack of SAME 3x3 convs (fp32 accumulation, bias, optional ReLU), phantom
columns (and, under ``row_bounds``, phantom rows) zeroed after every layer,
each layer's output rounded to the compute dtype, the last two columns of
every feature map carried to tile k+1 in the overlap queue, an optional
anchor added to the last layer, and the output tilted by L-1 columns.
Beyond the TPU kernel, for residual blocks (RLFN): an activated layer may
take a leaky slope in place of ReLU (``slopes``), and a residual tensor may
be added to the last layer's output (``residual``); the card builds both
at Chp 64 alone (:data:`EPI_CHP`).

* :func:`tilted_fusion_call` — the wrapper.  A CUDA tensor launches the
  kernel (or raises); a CPU tensor runs :func:`tilted_fusion_plain`; a
  ``meta`` tensor computes nothing.  There is no other path.
  ``tilted_fusion_call.launches`` counts kernel launches.
* :func:`tilted_fusion_plain` — the plain PyTorch version: the same tile
  loop, with the overlap queue and residual ring held as the TPU kernel
  holds them and rounding at the same points.  It is the CPU path and the
  oracle the kernel is held against on the card.
* :func:`launch_chp` — the built instance a stack packed to Chp channels
  runs on (:data:`SUPPORTED_CHP`: 16, 32 narrow; 48, 64, 96, 128 wide);
  the wrapper zero-pads the weights to it and cuts the result back.
* :func:`hidden_chp` — a mixed launch: where the caller says the feature
  maps F_0..F_{L-1} fit 32 channels (``hidden_channels``) and only the
  last layer is wider, the narrow Chp 32 instance runs the hidden layers
  and the last layer in output groups of at most 32 (ABPN x4: 28 hidden
  channels, 48 outputs), on the same packed stack.
* :func:`segment_plan` / :func:`launch_plan` — how many column segments
  each band's sweep is cut into, so that many CTAs sweep one band at once.
  A segment restarted at tile ``k0`` first re-runs :func:`warmup_tiles`
  tiles before it, so the output is bit-identical for every segment count.
* :func:`route` — where a narrow launch keeps a tile's feature maps: in
  shared memory (the on-chip route, every band whose two maps fit: ABPN's
  60- and 74-row bands) or in device-memory slabs (taller bands).
* :func:`kernel_buffers` — the Hopper kernel's own workspace and shared
  memory, per CTA and per launch (:func:`workspace_shapes`,
  :func:`packed_weight_bytes`, :func:`shared_bytes`).
* :func:`launch_cost` — the FLOPs and device-memory bytes a launch issues
  for a :class:`SegmentPlan`.  On ``meta`` tensors the wrapper checks its
  arguments and returns an empty result of the right shape, and
  :func:`record_launches` collects what it was given, so a traced call
  (``engine.executor.plan_cost``) can count K1 with :func:`launch_cost`.
"""

from __future__ import annotations

import contextlib
import contextvars
import ctypes
import functools
import numbers
import re
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build

__all__ = [
    "tilted_fusion_call",
    "tilted_fusion_plain",
    "round_up_channels",
    "workspace_shapes",
    "packed_weight_bytes",
    "shared_bytes",
    "block_rows",
    "kernel_buffers",
    "Route",
    "route",
    "onchip_shared_bytes",
    "SegmentPlan",
    "SHARED_SM_TILE_COST",
    "warmup_tiles",
    "segment_plan",
    "blocks_per_sm",
    "launch_plan",
    "Launch",
    "record_launches",
    "launch_cost",
    "THREADS",
    "MAX_TILE_COLS",
    "SUPPORTED_CHP",
    "launch_chp",
    "hidden_chp",
    "EPI_CHP",
    "output_groups",
    "n_group",
    "WideSchedule",
    "wide_schedule",
    "window_pixels",
    "max_tile_cols",
]

THREADS = 256  # CTA size (kThreads in the source)
BLOCK_PIXELS = 256  # output pixels of a row block: 8 warps x 2 m16 fragments (kBlockPix)
WINDOW_PIXELS = 320  # a row block's input window in shared memory: (30 + 2) x (8 + 2) (kWinPix)
# The template instances of the kernel (K1_INSTANCES in the source): Chp 16
# and 32 are "narrow" (a warp computes all Chp outputs, a weight stage holds
# a layer), the others "wide" (outputs in n-groups, a stage holds a slice
# of one n-group's taps: wide_schedule).  launch_chp pads a stack up to the
# next.
SUPPORTED_CHP = (16, 32, 48, 64, 96, 128)
# A mixed launch runs its hidden layers on the Chp 32 instance and its last
# layer in output groups of OUT_GROUP (kGroup in the source).
MIXED_HIDDEN_CHP = 32
OUT_GROUP = 32
# The one width whose instance takes a leaky slope or a residual (kEpiChp in
# the source): RLFN's 52-channel segments pad to it.
EPI_CHP = 64
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def round_up_channels(n: int, multiple: int = 8) -> int:
    """The channel-padding rule: round up to a multiple of 8.  ``ops``
    packing and :func:`kernel_buffers` both go through this."""
    return -(-int(n) // multiple) * multiple


def _mma_k(dtype) -> int:
    """The k of the kernel's MMA: m16n8k8 TF32 for fp32 (3xTF32), m16n8k16
    for bf16."""
    return 16 if dtype == torch.bfloat16 else 8


def launch_chp(chp: int, dtype=torch.float32) -> int:
    """The Chp of the instance a stack packed to ``chp`` channels launches:
    the smallest of :data:`SUPPORTED_CHP` at or above ``chp`` rounded up to
    8 (8 -> 16, 24 -> 32, 40 -> 48, 56 -> 64, 72..96 -> 96, 104..128 ->
    128).  The wrapper zero-pads the weights and bias to it; the padded
    channels carry exact zeros.  The same instances exist for every dtype.
    Raises ``ValueError`` above 128."""
    want = round_up_channels(chp)
    for c in SUPPORTED_CHP:
        if c >= want:
            return c
    raise ValueError(f"padded channel count {chp} exceeds the kernel's widest instance, "
                     f"{SUPPORTED_CHP[-1]}")


def hidden_chp(chp: int, hidden_channels: Optional[int] = None, c0p: int = 0,
               dtype=torch.float32) -> Optional[int]:
    """The Chp the hidden layers of a launch run at where it is mixed, else
    ``None``.  A stack packed to ``chp`` channels whose feature maps F_0..F_{L-1}
    have at most ``max(hidden_channels, c0p)`` channels is mixed where those
    pad to at most 32 (:func:`launch_chp`; 16 or fewer pad to 32 as well)
    and ``chp`` pads past 32: it runs on the Chp 32 instance, its last layer
    in :func:`output_groups`.  ``hidden_channels=None`` means Chp: every
    layer at the instance of ``chp``, narrow or wide."""
    lc = launch_chp(chp, dtype)
    if hidden_channels is None:
        return None
    hid = launch_chp(max(int(hidden_channels), int(c0p)), dtype)
    return MIXED_HIDDEN_CHP if hid <= MIXED_HIDDEN_CHP < lc else None


def output_groups(out_ch: int) -> List[int]:
    """The outputs of each step of a mixed launch's last layer: groups of
    :data:`OUT_GROUP`, the last one the rest (48 -> [32, 16]).  The
    source's ``group_width``."""
    out_ch = int(out_ch)
    return [min(OUT_GROUP, out_ch - g) for g in range(0, out_ch, OUT_GROUP)]


def _wide(chp: int) -> bool:
    return int(chp) > 32


class WideSchedule(NamedTuple):
    """How a wide instance (Chp > 32) walks a layer: the source's
    ``WideSched``."""

    ng: int  # outputs a warp computes in one pass over a row block (an n-group)
    taps: int  # taps of one weight slice (1, 3 or 9), copied together
    halves: int  # 2: a one-tap slice holds half the tap's k-steps (fp32)
    ctas: int  # resident CTAs an SM the instance is compiled for


@functools.lru_cache(maxsize=None)
def _wide_schedules() -> dict:
    """(dtype, Chp) -> :class:`WideSchedule` of every wide instance, read
    from ``wide_sched`` in the CUDA source, the one table the kernel and
    this accounting share (chosen on the card by ``tools/k1_ablation.py
    --wide``, PERF.md)."""
    text = (_build.CSRC / "tilted_fusion.cu").read_text()
    rows = re.findall(r"if \((!?)f32 && chp == (\d+)\) return \{([\d, ]+)\};", text)
    return {(torch.bfloat16 if neg else torch.float32, int(chp)):
            WideSchedule(*(int(v) for v in fields.split(","))) for neg, chp, fields in rows}


def wide_schedule(chp: int, dtype=torch.float32) -> Optional[WideSchedule]:
    """The :class:`WideSchedule` of the ``<dtype, chp>`` instance, or
    ``None`` on a narrow one (Chp <= 32: a warp computes all Chp outputs,
    a stage holds a whole layer).  Raises ``ValueError`` on a wide width
    no instance is built for."""
    if not _wide(chp):
        return None
    key = (torch.bfloat16 if dtype == torch.bfloat16 else torch.float32, int(chp))
    try:
        return _wide_schedules()[key]
    except KeyError:
        raise ValueError(f"no wide instance of the kernel is built for Chp {chp} "
                         f"(instances: {SUPPORTED_CHP})") from None


def n_group(chp: int, dtype=torch.float32) -> int:
    """Outputs a warp computes at once (``kNG``): all Chp on a narrow
    instance; on a wide one its :func:`wide_schedule`'s ``ng``."""
    sched = wide_schedule(chp, dtype)
    return sched.ng if sched else int(chp)


def window_pixels(chp: int, dtype=torch.float32) -> int:
    """Pixels of one row block's input window in shared memory
    (``kWinPix``) of the ``<dtype, chp>`` instance: :data:`WINDOW_PIXELS`
    on every instance (a narrow one holds two such windows, a wide one
    one)."""
    return WINDOW_PIXELS


def block_rows(tile_cols: int, chp: int = 32, dtype=torch.float32) -> int:
    """Output rows of a full row block (``block_rows`` in the source): at
    most :data:`BLOCK_PIXELS` pixels, with the (rows + 2) x (C + 2) window
    inside the instance's :func:`window_pixels`; 0 where a tile is too
    wide for it."""
    C = int(tile_cols)
    return max(0, min(BLOCK_PIXELS // C, window_pixels(chp, dtype) // (C + 2) - 2))


def max_tile_cols(chp: int, dtype=torch.float32) -> int:
    """The widest ``tile_cols`` the ``<dtype, chp>`` instance takes: a
    3-row window of it fits :func:`window_pixels` (104 for every instance,
    so every one takes ``SRPlan``'s default of 8)."""
    # block_rows(C) >= 1 takes C <= BLOCK_PIXELS and (C + 2) * 3 <= the window
    return min(BLOCK_PIXELS, window_pixels(chp, dtype) // 3 - 2)


MAX_TILE_COLS = max_tile_cols(32)  # 104, the Chp <= 32 instances'


def _row_blocks(band_rows: int, tile_cols: int) -> List[int]:
    """The rows of each row block of a tile, top to bottom."""
    R, nr = int(band_rows), block_rows(tile_cols)
    return [min(nr, R - r0) for r0 in range(0, R, nr)]


def _lane_words(nout: int, dtype) -> int:
    """B words a lane holds for one (tap, k-step) of a wide slice over
    ``nout`` outputs (fp32: hi and lo words of 2 registers per n8 block;
    bf16: 2 registers of bf16 pairs)."""
    return (4 if dtype != torch.bfloat16 else 2) * (int(nout) // 8)


def _stage_words(nout: int, ksteps: int, dtype, onchip: bool = True) -> int:
    """32-bit words of one step's packed stage of a narrow instance over
    ``nout`` outputs (a layer's Chp, or a mixed last layer's output group):
    the bias as fp32, then the B fragments of 9 taps x ``ksteps`` k-steps for
    32 lanes, 2 words a lane an n8 block on the on-chip route (fp32
    unsplit: the MMAs split it into TF32 hi and lo at use; bf16 pairs), and
    on the device-memory route fp32 pre-split, 4 words (:func:`_lane_words`)."""
    lane = 2 * (int(nout) // 8) if onchip else _lane_words(nout, dtype)
    return nout + 9 * ksteps * 32 * lane


def _slice_words(chp: int, ksteps: int, dtype) -> int:
    """32-bit words of one (tap, n-group) slice of a wide instance: the B
    fragments of ``ksteps`` k-steps over the group's outputs for 32 lanes
    (the bias is read from the launch's own)."""
    return ksteps * 32 * _lane_words(n_group(chp, dtype), dtype)


def _ksteps(cin: int, dtype) -> int:
    return -(-int(cin) // _mma_k(dtype))


def packed_weight_bytes(num_layers: int, chp: int, c0p: int, dtype,
                        hidden_chp: Optional[int] = None, onchip: bool = True) -> int:
    """Bytes of the packed weights at the head of a launch's workspace
    (``packed_bytes`` in the source) for the instance of width ``chp``:
    layer 0 with ``ceil(c0p / k)`` k-steps a tap, every other layer with
    ``Chp / k``; a stage a layer on a narrow instance, 9 slices an n-group
    on a wide one.  A mixed launch (``hidden_chp``, :func:`hidden_chp`): a
    stage a hidden layer at ``hidden_chp``, and a stage each of the last
    layer's :func:`output_groups` of ``chp`` outputs, k-steps of
    ``hidden_chp``.  A narrow instance's stages hold fp32 B unsplit on the
    on-chip route (``onchip``) and pre-split on the device-memory route
    (:func:`route`)."""
    ks0, ks = _ksteps(c0p, dtype), _ksteps(hidden_chp or chp, dtype)
    L = int(num_layers)
    if hidden_chp:
        words = sum(_stage_words(hidden_chp, ks0 if l == 0 else ks, dtype, onchip)
                    for l in range(L - 1))
        words += sum(_stage_words(n, ks0 if L == 1 else ks, dtype, onchip)
                     for n in output_groups(chp))
        return 4 * words
    if _wide(chp):
        slices = 9 * (int(chp) // n_group(chp, dtype))
        return 4 * slices * (_slice_words(chp, ks0, dtype)
                             + (int(num_layers) - 1) * _slice_words(chp, ks, dtype))
    return 4 * (_stage_words(chp, ks0, dtype, onchip)
                + (int(num_layers) - 1) * _stage_words(chp, ks, dtype, onchip))


def _pixel_bytes(chp: int, dtype) -> int:
    """A window (or map) pixel: a whole number of 128 data bytes, or 64,
    stored as they are (swizzled), other pixels padded by 16 bytes."""
    data = int(chp) * dtype.itemsize
    return data if data % 128 == 0 or data == 64 else data + 16


SMEM_PER_CTA = 232_448  # the most dynamic shared memory one CTA takes (sm_90)
SMEM_PER_SM = 233_472  # an SM's, of which 1 KB a resident CTA is reserved


class Route(NamedTuple):
    """Where a launch keeps a tile's feature maps (:func:`route`)."""

    onchip: bool  # in shared memory (the on-chip route), else in device-memory slabs
    shared_bytes: int  # dynamic shared memory of one CTA

    @property
    def name(self) -> str:
        return "onchip" if self.onchip else "device"


def onchip_shared_bytes(band_rows: int, tile_cols: int, chp: int, dtype) -> int:
    """Shared memory of the on-chip route of the narrow ``<dtype, chp>``
    instance (``onchip_smem`` in the source): two maps of R x (C + 2)
    pixels, each rounded up to 128 bytes, one weight stage, and 32 bytes
    (16 zero bytes the MMAs read above and below a band under ``zero``, the
    stage's mbarrier)."""
    maps = -(-int(band_rows) * (int(tile_cols) + 2) * _pixel_bytes(chp, dtype) // 128) * 128
    return 2 * maps + 4 * _stage_words(chp, _ksteps(chp, dtype), dtype) + 32


def route(band_rows: Optional[int], tile_cols: int, chp: int, dtype=torch.float32,
          hidden_chp: Optional[int] = None) -> Route:
    """The route a launch of the instance of ``chp`` padded channels (a
    mixed launch's: ``hidden_chp``'s) takes for bands of ``band_rows`` rows
    and tiles of ``tile_cols`` columns.  The wrapper picks it here and
    passes it to the launch, which checks that it fits (``onchip_fits`` in
    the source) and fails where it does not.

    A narrow instance keeps a tile's two feature maps in shared memory where
    they fit beside a weight stage; the budget is one CTA's 232,448 B in
    fp32 (one CTA an SM) and half an SM less 1 KB in bf16 (two): at tile 8
    up to 76 rows in fp32 and 75 in bf16.  Taller bands (the planner's
    one-band fallback) take the device-memory route, whose slabs, windows
    and shared memory do not depend on R; so do the wide instances.
    ``band_rows=None`` asks for the device-memory route."""
    inst = hidden_chp or launch_chp(chp, dtype)
    if not _wide(inst) and band_rows is not None and 1 <= int(band_rows) <= 1024:
        budget = SMEM_PER_CTA if dtype != torch.bfloat16 else SMEM_PER_SM // 2 - 1024
        smem = onchip_shared_bytes(band_rows, tile_cols, inst, dtype)
        if smem <= budget:
            return Route(True, smem)
    return Route(False, shared_bytes(inst, dtype))


def shared_bytes(chp: int, dtype=torch.float32, hidden_chp: Optional[int] = None,
                 band_rows: Optional[int] = None, tile_cols: int = 8) -> int:
    """Dynamic shared memory of one CTA of the ``<dtype, chp>`` instance.
    With ``band_rows``, that of the :func:`route` a launch over bands of
    that height takes.  Without, the device-memory route's (``kSmemBytes``,
    which does not depend on R): on a narrow instance (Chp <= 32) two
    pre-split weight stages and two windows, on a wide one two slices (each
    :func:`wide_schedule`'s ``taps`` (tap, n-group) slices, or half of one)
    and one window, of :func:`window_pixels` pixels of ``chp`` channels.  A
    mixed launch (``hidden_chp``) runs on the ``hidden_chp`` instance: its
    stages and windows, or maps."""
    if band_rows is not None:
        return route(band_rows, tile_cols, chp, dtype, hidden_chp).shared_bytes
    if hidden_chp:
        return shared_bytes(hidden_chp, dtype)
    ks = _ksteps(chp, dtype)
    win = window_pixels(chp, dtype) * _pixel_bytes(chp, dtype)
    sched = wide_schedule(chp, dtype)
    if sched:
        steps = sched.taps * -(-ks // sched.halves)  # k-steps of a slice
        return 2 * 4 * _slice_words(chp, steps, dtype) + win
    return 2 * 4 * _stage_words(chp, ks, dtype, onchip=False) + 2 * win


def workspace_shapes(num_layers: int, band_rows: int, tile_cols: int, chp: int,
                     onchip: bool = False):
    """The per-CTA device-memory workspace of the kernel — ``(slabs,
    overlap_queue)``: two pixel-major ping-pong slabs ``(2, R, C, Chp)``
    (a layer's C fresh output columns; ``None`` on the on-chip route, whose
    maps live in shared memory) and the overlap queue ``(2, L-1, R, 2,
    Chp)``, double-buffered by tile parity, for F_1..F_{L-1} (F_0's carried
    columns are read from the input stream) — as plain tuples.  The
    wrapper allocates exactly this per CTA, after the packed weights
    (:func:`packed_weight_bytes`); the kernel's ``workspace_elems`` (or
    ``onchip_workspace_elems``) indexes it."""
    slabs = None if onchip else (2, band_rows, tile_cols, chp)
    overlap = (2, num_layers - 1, band_rows, 2, chp)
    return slabs, overlap


def _elems(shape) -> int:
    if shape is None:
        return 0
    n = 1
    for d in shape:
        n *= int(d)
    return n


def kernel_buffers(*, channels, band_rows: int, tile_cols: int, chp: int = None,
                   bands: int = 1, segments: int = 1, dtype=torch.float32) -> dict:
    """What one CTA (one segment of one band) of the Hopper kernel holds, in
    ELEMENTS of the compute dtype unless a key says bytes, and the workspace
    of a launch of ``bands`` x ``segments`` CTAs.

    * ``route`` — where the tile's feature maps live (:func:`route`):
      ``"onchip"``, in shared memory (every band whose two maps fit beside
      a weight stage: ABPN's 60- and 74-row bands, at tile 8 up to 76 rows
      in fp32 and 75 in bf16), or ``"device"``, in slabs in device memory
      (taller bands, and the wide instances).
    * ``slabs`` — the two ping-pong feature maps (R, C fresh columns, Chp;
      ``memory`` says where): in shared memory on the on-chip route (as
      ``maps``, R x (C + 2) pixels with the carried columns), in device
      memory on the other.
    * ``overlap`` — the overlap queue, in device memory on both routes.
      ``slabs`` (where in device memory) and ``overlap`` are summed in
      ``workspace_elements``, what the wrapper allocates per CTA
      (:func:`workspace_shapes`); ``device_slab_elements`` is the slabs'
      share of it.  ``overlap``'s ``logical_elements`` is the algorithm's
      queue, L slots of 2 columns (the kernel reads F_0's slot from the
      input stream and keeps two parities of the others).  The TPU
      kernel's residual ring has no counterpart: the anchor is read from
      the input stream, which stays in device memory.
    * ``ctas`` / ``launch_workspace_elements`` — the CTAs of the launch and
      their workspace, ``bands * segments * workspace_elements``; the
      wrapper allocates ``packed_weight_bytes`` more, once a launch.
    * ``chp`` — the Chp of the instance the card launches for this stack
      (:func:`launch_chp` of the packed width ``packed_chp``), which sizes
      everything below; ``instance`` is the same, or ``None`` where no
      instance covers the stack (above Chp 128), and then ``chp`` is the
      packed width, nothing launches and ``packed_weight_bytes`` and
      ``shared_bytes``, an instance's own, are ``None``.
    * ``hidden_chp`` — the Chp of the slabs, the queue, the windows and
      the weight stages: ``chp``, or 32 where the launch is mixed
      (:func:`hidden_chp` of the feature maps F_0..F_{L-1},
      ``max(channels[:-1])``; ABPN x4's 28 hidden channels and 48 outputs).
      The serving path launches so (``ops.pack_stack`` records the hidden
      width).
    * ``shared_bytes`` — dynamic shared memory per CTA for ``dtype`` on the
      route (:func:`shared_bytes`): on the on-chip route the two maps and
      the stage (:func:`onchip_shared_bytes`); on the device-memory one
      two weight stages (narrow) or slices (wide) and the input windows of
      ``window_elements`` (``window_pixels * hidden_chp``) each, which do
      not depend on R.  ``max_tile_cols`` is the widest tile the instance
      takes.
    * ``stream_in_per_column`` / ``stream_out_per_column`` — the input
      stream read, and the tilted output written, per band column.
    * ``weights`` / ``bias`` — the packed stack, read from device memory.
    """
    channels = [int(c) for c in channels]
    L = len(channels) - 1
    if L < 1:
        raise ValueError(f"channels {channels!r} must list F_0..F_L, L >= 1")
    R, C = int(band_rows), int(tile_cols)
    chmax = max(channels)
    packed_chp = round_up_channels(chp if chp else chmax)
    instance = launch_chp(packed_chp, dtype) if packed_chp <= SUPPORTED_CHP[-1] else None
    chp = instance or packed_chp
    c0p = round_up_channels(channels[0])
    mixed = hidden_chp(chp, max(channels[:-1]), c0p, dtype) if instance else None
    hid = mixed or chp
    rt = route(R, C, chp, dtype, mixed) if instance else None
    onchip = bool(rt and rt.onchip)
    slabs, overlap = workspace_shapes(L, R, C, hid, onchip=onchip)
    maps = (2, R, C + 2, hid) if onchip else (2, R, C, hid)
    buffers = {
        "slabs": {"shape": maps, "elements": _elems(maps),
                  "memory": "shared" if onchip else "device"},
        "overlap": {
            "shape": overlap,
            "elements": _elems(overlap),
            "logical_elements": L * R * 2 * chmax,
        },
        "stream_in_per_column": {"shape": (R, 1, c0p), "elements": R * c0p},
        "stream_out_per_column": {"shape": (R, 1, chp), "elements": R * chp},
        "weights": {
            "shape": (L, 3, 3, chp, chp),
            "elements": L * 9 * chp * chp,
            "logical_elements": sum(9 * channels[i] * channels[i + 1] for i in range(L)),
        },
        "bias": {"shape": (L, chp), "elements": L * chp, "logical_elements": sum(channels[1:])},
    }
    per_cta = _elems(slabs) + buffers["overlap"]["elements"]
    ctas = int(bands) * int(segments)
    return {
        "num_layers": L,
        "band_rows": R,
        "tile_cols": C,
        "chp": chp,
        "hidden_chp": hid,
        "packed_chp": packed_chp,
        "instance": instance,
        "route": rt.name if rt else None,
        "c0p": c0p,
        "threads": THREADS,
        "buffers": buffers,
        "workspace_elements": per_cta,
        "device_slab_elements": _elems(slabs),
        "ctas": ctas,
        "launch_workspace_elements": ctas * per_cta,
        # an instance's own: none where no instance covers the stack
        "packed_weight_bytes": (packed_weight_bytes(L, chp, c0p, dtype, hidden_chp=mixed,
                                                    onchip=onchip) if instance else None),
        "window_pixels": window_pixels(hid, dtype),
        "window_elements": window_pixels(hid, dtype) * hid,
        "max_tile_cols": max_tile_cols(hid, dtype),
        "shared_bytes": rt.shared_bytes if rt else None,
    }


# ----------------------------------------------------------------------
# Column segments
# ----------------------------------------------------------------------
# The time per tile of a CTA that shares its SM with a second resident CTA,
# over the time of one alone on its SM: 0.0889-0.0903 against 0.0626-0.0642
# ms per tile of the longest CTA, 1.38-1.44, for the bf16 Chp 32 instance at
# 2 CTAs per SM on an H100 (chip_smoke.py's forced-segment sweep; PERF.md).
# The fp32 instance fits one CTA per SM, so its plans never share an SM.
SHARED_SM_TILE_COST = 1.4


class SegmentPlan(NamedTuple):
    """How a launch cuts each band's K tiles into segments, one CTA each."""

    bands: int
    tiles: int  # K
    segments: int  # S, segments per band (at most K)
    warmup: int  # w, warm-up tiles before a segment restarted at k0 >= w
    cost: float  # the model's makespan, in tiles of a CTA alone on its SM

    @property
    def ctas(self) -> int:
        return self.bands * self.segments

    def ranges(self) -> List[Tuple[int, int, int]]:
        """``(kw, k0, k1)`` per segment: its own tiles ``[k0, k1)``, with
        ``k0 = s * K // S``, and the tile ``kw`` its sweep starts at —
        ``k0 - w``, or 0 where ``k0 < w`` (the band-start state).  The
        kernel computes the same bounds from ``blockIdx``."""
        return _ranges(self.tiles, self.segments, self.warmup)


def warmup_tiles(num_layers: int, tile_cols: int) -> int:
    """``w = ceil((2L - 1) / C)``: the tiles a segment re-runs before its
    first own tile.  A wrong carried column of F_l spreads at most one
    column to the right per layer; after ``w * C >= 2L - 1`` columns none
    reaches a column that any layer carries into tile ``k0``."""
    return -(-(2 * int(num_layers) - 1) // int(tile_cols))


def _ranges(K: int, S: int, w: int) -> List[Tuple[int, int, int]]:
    out = []
    for s in range(S):
        k0, k1 = s * K // S, (s + 1) * K // S
        out.append((k0 - w if k0 >= w else 0, k0, k1))
    return out


def _cost(bands: int, K: int, S: int, w: int, sms: int, ctas_per_sm: int) -> float:
    """The makespan of ``bands * S`` CTAs, in tiles of a CTA alone on its
    SM: waves of ``sms * ctas_per_sm`` CTAs, each as long as the CTA that
    executes the most tiles (warm-up included), and a CTA that shares its
    SM runs :data:`SHARED_SM_TILE_COST` times slower than one alone."""
    ctas = bands * S
    longest = max(k1 - kw for kw, _, k1 in _ranges(K, S, w))
    if ctas <= sms:
        return float(longest)
    waves = -(-ctas // (sms * ctas_per_sm))
    return waves * longest * (SHARED_SM_TILE_COST if ctas_per_sm > 1 else 1.0)


@functools.lru_cache(maxsize=256)
def _best_segments(bands: int, K: int, w: int, sms: int, ctas_per_sm: int) -> int:
    return min(range(1, K + 1), key=lambda s: (_cost(bands, K, s, w, sms, ctas_per_sm), s))


def _check_segments(segments) -> None:
    if segments is not None and (isinstance(segments, bool)
                                 or not isinstance(segments, numbers.Integral) or segments < 1):
        raise ValueError(f"segments must be None (the automatic plan) or an integer >= 1, "
                         f"not {segments!r}")


def segment_plan(bands: int, tiles: int, tile_cols: int, num_layers: int, sms: int,
                 ctas_per_sm: int = 1, segments: Optional[int] = None) -> SegmentPlan:
    """The segment count for a launch of ``bands`` bands of ``tiles`` tiles
    on ``sms`` SMs that each hold ``ctas_per_sm`` resident CTAs.

    ``segments=None`` picks the S in ``1..K`` with the least model makespan
    (``SegmentPlan.cost``); ties go to fewer segments.  The search is
    cached per shape.  An integer forces S (clamped to K: a segment holds
    at least one tile).
    """
    _check_segments(segments)
    if int(sms) < 1 or int(ctas_per_sm) < 1:
        raise ValueError(f"sms and ctas_per_sm must be >= 1, not {sms}, {ctas_per_sm}")
    B, K, sms, per_sm = int(bands), int(tiles), int(sms), int(ctas_per_sm)
    w = warmup_tiles(num_layers, tile_cols)
    if segments is None:
        S = _best_segments(B, K, w, sms, per_sm) if B >= 1 and K >= 1 else 1
    else:
        S = min(int(segments), K) if K >= 1 else 1
    cost = _cost(B, K, S, w, sms, per_sm) if B >= 1 and K >= 1 else 0.0
    return SegmentPlan(bands=B, tiles=K, segments=S, warmup=w, cost=cost)


# ----------------------------------------------------------------------
# What a launch issues
# ----------------------------------------------------------------------
def _mma_pixels(band_rows: int, tile_cols: int, onchip: bool = False) -> int:
    """Output pixels a tile's MMAs cover: on the device-memory route each
    row block's pixels rounded up to whole m16 fragments (two rows at C =
    8, so an odd R runs one more row); on the on-chip route the tile's R x
    C pixels, in blocks of 256, rounded up once."""
    C = int(tile_cols)
    if onchip:
        return -(-int(band_rows) * C // 16) * 16
    return sum(-(-rows * C // 16) * 16 for rows in _row_blocks(band_rows, C))


def launch_cost(plan: SegmentPlan, *, band_rows: int, tile_cols: int, c0p: int, chp: int,
                num_layers: int, dtype, bounds: bool = False, replicate: bool = False,
                plain: bool = False, hidden_chp: Optional[int] = None,
                residual_elems: int = 0) -> dict:
    """The FLOPs and device-memory bytes of one launch over ``plan``, as
    ``csrc/tilted_fusion.cu`` issues them.  ``plain=True`` counts the FLOPs
    as :func:`tilted_fusion_plain` executes them; its bytes stay the
    kernel's below, which is not what the plain version's eager loop
    issues.  ``hidden_chp`` counts a mixed launch (:func:`hidden_chp`): its
    hidden layers at ``hidden_chp``, its last layer's ``chp`` outputs from
    ``hidden_chp`` inputs, one step an output group; the plain version
    ignores it.

    * ``flops`` — 2 per multiply-add the MMAs execute, as fp32-equivalent
      products (3xTF32 runs three TF32 products for each; a bound takes the
      TF32 rate over 3): every executed tile of every CTA, own tiles layers
      0..L-1, warm-up tiles ``[kw, k0)`` layers 0..L-2.  Each layer covers
      the tile's pixels in whole m16 fragments per row block
      (``ceil(R / 2) * 2`` rows at C = 8) for all its outputs (``chp``; a
      mixed launch's hidden layers ``hidden_chp``); layer 0 reads ``c0p``
      channels padded to the MMA's k (8 in fp32, 16 in bf16), the others
      ``chp`` (mixed: ``hidden_chp``).  The plain version pads layer 0 to
      ``chp`` channels and runs exactly ``R`` rows.
    * ``io_bytes`` (a) — the arguments and the result once each: the input
      stream, the first column, weights, bias, the row bounds (int32), the
      residual (``residual_elems`` elements a band) and the tilted output.
      A mixed launch's weights are the blocks its packing reads, each
      hidden layer's ``hidden_chp`` square and the last layer's
      ``hidden_chp x chp``, not the zeros around them.
    * ``workspace_bytes`` (b) — every other byte the launch reads or
      writes in device memory: the packed weight stages written once and
      read at every (tile, step) (a wide instance: every row block
      copies each n-group's 9 taps of B in slices of its schedule's
      ``taps`` (:func:`wide_schedule`) and reads the bias; a mixed
      launch's last layer is one step an output group, each with its own
      stage).
      On the on-chip route (:func:`route`): per CTA its row
      bounds; per tile F_0's R x (C + 2) stream columns (C + 1 at tile 0)
      and, for each layer after the first that the tile runs, the two
      carried columns from the queue (zero-filled, not read, at a sweep's
      first tile); per carried layer the queue's two columns stored.  On
      the device-memory route: per CTA its row bounds and the queue's start
      state; per step and row block the window's copies (the stream for
      layer 0, the slab and the carried columns for the others, a mixed
      launch's output groups each again; rows outside the band are
      zero-filled under ``zero`` and read again, clamped, under
      ``replicate``); per carried layer the slab and the queue's two
      columns stored.  Each element counts once per pass, whatever the
      loads a thread issues; L2 hits are not subtracted.  The anchor's
      reads (``add_anchor``, which the serving path never sets) are not
      counted.

    ``bytes`` is (a) + (b).  ``tiles`` counts executed tiles and
    ``warmup_tiles`` the warm-up ones among them, over every band.
    """
    R, C, L, chp, c0p = int(band_rows), int(tile_cols), int(num_layers), int(chp), int(c0p)
    mixed = int(hidden_chp) if hidden_chp and not plain else None
    hid = mixed or chp  # the width of the feature maps F_1..F_{L-1} and of K
    esize = dtype.itemsize
    kk = _mma_k(dtype)
    ks0, ks = _ksteps(c0p, dtype), _ksteps(hid, dtype)
    cin = [chp if plain else ks0 * kk] + [hid] * (L - 1)  # K of each layer's products
    cout = [hid] * (L - 1) + [chp]  # N of each layer's products
    onchip = route(R, C, chp, dtype, mixed).onchip
    pixels = R * C if plain else _mma_pixels(R, C, onchip)

    def tile_flops(layers):
        return 2 * pixels * 9 * sum(cin[l] * cout[l] for l in range(layers))

    # a step's window rows, summed over its row blocks: each block reads its
    # rows and one more above and below, those outside [0, R) only under
    # replicate
    blocks = len(_row_blocks(R, C))
    win_rows = R + 2 * blocks - (0 if replicate else 2)
    if _wide(chp) and not mixed:
        # every row block copies each n-group's 9 taps of B (whatever the
        # slices they come in), and its epilogues read the layer's bias
        slices = blocks * 9 * (chp // n_group(chp, dtype))
        stage0 = slices * 4 * _slice_words(chp, ks0, dtype) + blocks * chp * esize
        stage = slices * 4 * _slice_words(chp, ks, dtype) + blocks * chp * esize

        def stage_bytes(l, nout):
            return stage0 if l == 0 else stage
    else:
        def stage_bytes(l, nout):
            return 4 * _stage_words(nout, ks0 if l == 0 else ks, dtype, onchip)
    # the steps of an own tile as (layer, outputs): one a layer, a mixed
    # launch's last layer one an output group; a warm-up tile runs the
    # first L - 1
    steps = [(l, hid) for l in range(L - 1)] + [(L - 1, n) for n in (
        output_groups(chp) if mixed else [chp])]

    # bytes of one tile's steps beyond the output: each step's stage and
    # window (layer 0: C + 2 stream columns of c0p, C + 1 at tile 0, whose
    # column -1 is zero-filled; the others: the carried 2 and the slab's C
    # of hid) and, for a carried layer, its slab and queue columns stored
    carried_out = R * (C + 2) * hid * esize
    carried = R * 2 * hid * esize  # the queue's two columns of a layer

    def tile_bytes(k, layers, kw):
        out = 0
        for l, nout in steps[:L - 1] if layers < L else steps:
            out += stage_bytes(l, nout)
            if onchip:  # F_0 from the stream; the maps stay in shared memory
                out += R * (C + 1 if k == 0 else C + 2) * c0p * esize if l == 0 else 0
            else:
                cols, width = ((C + 1 if k == 0 else C + 2), c0p) if l == 0 else (C + 2, hid)
                out += win_rows * cols * width * esize
        if onchip:  # layers 1..layers-1's carried columns read, layers 0..L-2's stored
            return out + max(layers - 1, 0) * carried * (k != kw) + min(layers, L - 1) * carried
        return out + min(layers, L - 1) * carried_out

    flops = tiles = warm_tiles = issued = 0
    for kw, k0, k1 in plan.ranges():
        own, warm = k1 - k0, k0 - kw
        flops += own * tile_flops(L) + warm * tile_flops(L - 1)
        tiles += own + warm
        warm_tiles += warm
        if not onchip:
            issued += (L - 1) * R * 2 * hid * esize  # the queue's start state
        issued += sum(tile_bytes(k, L if k >= k0 else L - 1, kw) for k in range(kw, k1))
    B, K = plan.bands, plan.tiles
    stream = B * R * K * C
    weights = sum(9 * a * b + b for a, b in zip([hid] * L, cout)) * esize if mixed else \
        L * (9 * chp * chp + chp) * esize
    io_bytes = (stream * c0p + B * R * c0p + stream * chp) * esize + weights
    if bounds:
        io_bytes += 4 * 2 * B
    io_bytes += B * int(residual_elems) * esize
    # the packing kernel reads the weights and bias once and writes the
    # stages; the last layer's stores read the residual once
    issued = (B * issued + stream * chp * esize + weights
              + packed_weight_bytes(L, chp, c0p, dtype, hidden_chp=mixed, onchip=onchip)
              + (4 * 2 * B * plan.segments if bounds else 0) + B * int(residual_elems) * esize)
    return {
        "flops": B * flops,
        "io_bytes": io_bytes,
        "workspace_bytes": issued - io_bytes,
        "bytes": issued,
        "tiles": B * tiles,
        "warmup_tiles": B * warm_tiles,
    }


# ----------------------------------------------------------------------
# Plain version
# ----------------------------------------------------------------------
def _conv_tile_plain(f, w_l, b_l, row_policy: str):
    """3x3 conv of one (B, R, C+2, Chp) slab -> (B, R, C, Chp) in fp32 via
    9 shifted products, then the bias."""
    B, R, C2, chp = f.shape
    C = C2 - 2
    if row_policy == "replicate":
        frow = torch.cat([f[:, :1], f, f[:, -1:]], dim=1)
    else:
        frow = F.pad(f, (0, 0, 0, 0, 1, 1))
    frow = frow.float()
    acc = torch.zeros((B, R, C, chp), dtype=torch.float32, device=f.device)
    for dy in range(3):
        for dx in range(3):
            acc = acc + torch.matmul(frow[:, dy : dy + R, dx : dx + C], w_l[dy, dx])
    return acc + b_l


def _input_cols(ext: torch.Tensor, start: int, n: int) -> torch.Tensor:
    """Input columns ``[start, start + n)`` of a band batch, zero left of the
    image; ``ext`` is ``first_col ++ x_stream``, so its column a is input
    column a."""
    lo = max(start, 0)
    return F.pad(ext[:, :, lo : start + n], (0, 0, lo - start, 0))


def tilted_fusion_plain(
    x_stream: torch.Tensor,  # (B, R, K*C, C0p)
    first_col: torch.Tensor,  # (B, R, 1, C0p)
    w: torch.Tensor,  # (L, 3, 3, Chp, Chp)
    b: torch.Tensor,  # (L, Chp)
    *,
    width: int,
    tile_cols: int,
    relu_flags: Sequence[bool],
    add_anchor: bool,
    in_channels: int,
    anchor_repeats: int = 9,
    row_policy: str = "zero",
    row_bounds: torch.Tensor = None,
    compute_dtype=None,
    out_dtype=None,
    segments: Optional[int] = None,
    hidden_channels: Optional[int] = None,
    slopes: Optional[Sequence[float]] = None,
    residual: Optional[torch.Tensor] = None,
    residual_offset: int = 0,
) -> torch.Tensor:
    """Plain PyTorch version of K1: same arguments, same tilted
    ``(B, R, K*C, Chp)`` result.

    A loop over the K tiles carrying the overlap queue ``(L, B, R, 2, Chp)``
    and the residual ring ``(B, R, C+L, C0p)``; weights are read in the
    compute dtype and the bias in the compute dtype, both widened to fp32;
    products and sums are fp32; each layer's masked output is rounded to the
    compute dtype, and the anchor is a compute-dtype sum.

    ``segments`` sweeps each band as the kernel's CTAs do: segment by
    segment (``SegmentPlan.ranges``), each restarted with the true F_0
    columns, zeroed deeper queue slots and warm-up tiles that run layers
    0..L-2 and store nothing.  The result is the same for every count.
    ``None`` is the plan for one SM — a sequential loop is one — which is
    one segment.  ``hidden_channels`` is checked and not used: the whole
    padded stack, whose extra channels are zeros, is the same function.
    ``slopes`` and ``residual`` as :func:`tilted_fusion_call` takes them:
    an activated layer's output is ``v if v > 0 else v * slope``, and the
    residual is added to the last layer's rounded output in fp32 and the
    sum rounded again.
    """
    _check_args(x_stream, first_col, w, b, tile_cols, relu_flags, add_anchor,
                in_channels, anchor_repeats, row_policy, row_bounds, width, slopes,
                residual, residual_offset)
    _check_segments(segments)
    _check_hidden_channels(hidden_channels, w.shape[3])
    B, R, KC, c0p = x_stream.shape
    L, chp = w.shape[0], w.shape[3]
    C, W = tile_cols, width
    K = KC // C
    cdt = compute_dtype or x_stream.dtype
    out_dtype = out_dtype or x_stream.dtype
    dev = x_stream.device
    plan = segment_plan(B, K, C, L, sms=1, segments=segments)

    wf = w.to(cdt).float()
    bf = b.to(cdt).float()
    ext = torch.cat([first_col.to(cdt), x_stream.to(cdt)], dim=2)  # column a = input column a
    row_ok = None
    if row_bounds is not None:
        rb = row_bounds.to(dev)
        rows = torch.arange(R, device=dev)
        row_ok = ((rows >= rb[:, :1]) & (rows < rb[:, 1:]))[:, :, None, None]
    col_idx = torch.arange(C, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    out = torch.empty((B, R, KC, chp), dtype=out_dtype, device=dev)
    res_ext = None
    if residual is not None:
        # the residual at its rows of the band and, column a of the image at
        # tilted column a + L - 1, its channels padded to Chp: zero elsewhere
        rr, rc = residual.shape[1], residual.shape[3]
        res_ext = torch.zeros((B, R, KC, chp), dtype=torch.float32, device=dev)
        res_ext[:, residual_offset:residual_offset + rr, L - 1:L - 1 + W, :rc] = \
            residual.to(cdt).float()

    for kw, k0, k1 in plan.ranges():
        # the state before tile kw: F_0's carried columns kw*C-1, kw*C, the
        # deeper slots zero, and the ring's last C+L input columns
        overlap = torch.zeros((L, B, R, 2, chp), dtype=cdt, device=dev)
        overlap[0, :, :, :, :c0p] = _input_cols(ext, kw * C - 1, 2)
        ring = _input_cols(ext, kw * C - C - L + 1, C + L)
        for k in range(kw, k1):
            fresh = x_stream[:, :, k * C : (k + 1) * C].to(cdt)
            if add_anchor:
                ring = torch.cat([ring[:, :, C:], fresh], dim=2)
            f = torch.cat([overlap[0, :, :, :, :c0p], fresh], dim=2)
            overlap[0, :, :, :, :c0p] = f[:, :, -2:]
            f = F.pad(f, (0, chp - c0p))
            # a warm-up tile runs layers 0..L-2: layer L-1 carries nothing
            for l in range(L if k >= k0 else L - 1):
                g = _conv_tile_plain(f, wf[l], bf[l], row_policy)
                if relu_flags[l]:
                    slope = float(slopes[l]) if slopes is not None else 0.0
                    g = torch.where(g > 0, g, g * slope) if slope else torch.clamp_min(g, 0.0)
                abs_cols = k * C - l + col_idx
                col_ok = ((abs_cols >= 0) & (abs_cols < W))[None, None, :, None]
                g = torch.where(col_ok, g, zero)
                if row_ok is not None:
                    g = torch.where(row_ok, g, zero)
                g = g.to(cdt)
                if l < L - 1:
                    left = overlap[l + 1].clone()
                    overlap[l + 1] = g[:, :, -2:]
                    f = torch.cat([left, g], dim=2)
                else:
                    if add_anchor:
                        anchor = ring[:, :, :C, :in_channels]
                        anchor = torch.repeat_interleave(anchor, anchor_repeats, dim=-1)
                        anchor = F.pad(anchor, (0, chp - in_channels * anchor_repeats))
                        anchor = torch.where(col_ok, anchor,
                                             torch.zeros((), dtype=cdt, device=dev))
                        g = g + anchor
                    if res_ext is not None:
                        g = (g.float() + res_ext[:, :, k * C : (k + 1) * C]).to(cdt)
                    out[:, :, k * C : (k + 1) * C] = g.to(out_dtype)
    return out


# ----------------------------------------------------------------------
# The wrapper
# ----------------------------------------------------------------------
def _check_hidden_channels(hidden_channels, chp: int) -> None:
    if hidden_channels is not None and (
            isinstance(hidden_channels, bool) or not isinstance(hidden_channels, numbers.Integral)
            or not 1 <= hidden_channels <= chp):
        raise ValueError(f"hidden_channels must be None (Chp) or an integer in [1, Chp = {chp}], "
                         f"not {hidden_channels!r}")


def _check_args(x_stream, first_col, w, b, tile_cols, relu_flags, add_anchor,
                in_channels, anchor_repeats, row_policy, row_bounds, width=None, slopes=None,
                residual=None, residual_offset=0):
    if x_stream.ndim != 4 or first_col.ndim != 4 or w.ndim != 5 or b.ndim != 2:
        raise ValueError(
            "expected x_stream (B, R, K*C, C0p), first_col (B, R, 1, C0p), "
            "w (L, 3, 3, Chp, Chp), b (L, Chp)"
        )
    B, R, KC, c0p = x_stream.shape
    L, chp = w.shape[0], w.shape[3]
    if KC % tile_cols or tile_cols < 2:
        raise ValueError(f"stream width {KC} is not a multiple of tile_cols={tile_cols} >= 2")
    if tuple(first_col.shape) != (B, R, 1, c0p):
        raise ValueError(f"first_col shape {tuple(first_col.shape)} != {(B, R, 1, c0p)}")
    if tuple(w.shape) != (L, 3, 3, chp, chp) or tuple(b.shape) != (L, chp):
        raise ValueError(f"weights {tuple(w.shape)} / bias {tuple(b.shape)} are not packed")
    if c0p > chp:
        raise ValueError(f"input channels {c0p} exceed the padded channel count {chp}")
    if len(relu_flags) != L:
        raise ValueError(f"{len(relu_flags)} relu flags for {L} layers")
    if add_anchor and in_channels * anchor_repeats > chp:
        raise ValueError("anchor channels exceed padded channel count")
    if row_policy not in ("zero", "replicate"):
        raise ValueError(f"row_policy {row_policy!r} not in ('zero', 'replicate')")
    if row_bounds is not None and tuple(row_bounds.shape) != (B, 2):
        raise ValueError(f"row_bounds shape {tuple(row_bounds.shape)} != {(B, 2)}")
    if slopes is not None and len(slopes) != L:
        raise ValueError(f"{len(slopes)} slopes for {L} layers")
    if residual is not None:
        if (residual.ndim != 4 or residual.shape[0] != B or residual.shape[2] != width
                or not 1 <= residual.shape[3] <= chp):
            raise ValueError(f"residual shape {tuple(residual.shape)} is not (B = {B}, rows, "
                             f"W = {width}, at most Chp = {chp} channels)")
        if residual_offset < 0 or residual_offset + residual.shape[1] > R:
            raise ValueError(f"residual rows [{residual_offset}, "
                             f"{residual_offset + residual.shape[1]}) leave the band's {R}")


_lib_handle = None


def _lib() -> ctypes.CDLL:
    global _lib_handle
    if _lib_handle is None:
        lib = _build.load("tilted_fusion")
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.tilted_fusion_launch.argtypes = ([ci] + [vp] * 7 + [ci] * 17 + [vp] + [ci] * 3
                                             + [vp, vp])
        lib.tilted_fusion_launch.restype = ci
        lib.tilted_fusion_blocks_per_sm.argtypes = [ci] * 6 + [ctypes.POINTER(ci)]
        lib.tilted_fusion_blocks_per_sm.restype = ci
        lib.tilted_fusion_error_string.argtypes = [ci]
        lib.tilted_fusion_error_string.restype = ctypes.c_char_p
        _lib_handle = lib
    return _lib_handle


def _check_error(lib, err: int, what: str) -> None:
    if err != 0:
        msg = lib.tilted_fusion_error_string(err).decode()
        raise RuntimeError(f"tilted_fusion {what} failed: CUDA error {err} ({msg})")


@functools.lru_cache(maxsize=None)
def _blocks_per_sm(device_index: int, dtype_code: int, chp: int, out_ch: int, R: int,
                   C: int, onchip: bool) -> int:
    lib = _lib()
    blocks = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        _check_error(lib, lib.tilted_fusion_blocks_per_sm(dtype_code, chp, out_ch, R, C,
                                                          int(onchip), ctypes.byref(blocks)),
                     "occupancy query")
    if blocks.value < 1:
        raise RuntimeError(f"the <{dtype_code}, chp {chp} -> {out_ch}> kernel fits no CTA on an SM")
    return blocks.value


def blocks_per_sm(device, dtype, chp: int, hidden_chp: Optional[int] = None,
                  band_rows: Optional[int] = None, tile_cols: int = 8) -> int:
    """Resident CTAs per SM on a CUDA ``device`` of the instance a stack of
    ``chp`` padded channels launches (:func:`launch_chp`; a mixed launch's
    ``hidden_chp`` instance), on the :func:`route` a launch over bands of
    ``band_rows`` rows and tiles of ``tile_cols`` columns takes (``None``:
    the device-memory route), from
    ``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` (builds the kernel on
    first use)."""
    device = torch.device(device)
    if dtype not in _DTYPE_CODE:
        raise ValueError(f"the kernel computes in float32 or bfloat16, not {dtype}")
    index = device.index if device.index is not None else torch.cuda.current_device()
    out_ch = launch_chp(chp, dtype)
    rt = route(band_rows, tile_cols, chp, dtype, hidden_chp)
    return _blocks_per_sm(index, _DTYPE_CODE[dtype], hidden_chp or out_ch, out_ch,
                          int(band_rows or 0), int(tile_cols), rt.onchip)


def _plan_on(device: torch.device, bands: int, tiles: int, tile_cols: int, num_layers: int,
             dtype, chp: int, segments: Optional[int],
             hidden_chp: Optional[int] = None, band_rows: Optional[int] = None) -> SegmentPlan:
    sms, per_sm = 1, 1
    if device.type == "cuda":
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        per_sm = blocks_per_sm(device, dtype, chp, hidden_chp, band_rows, tile_cols)
    return segment_plan(bands, tiles, tile_cols, num_layers, sms, per_sm, segments=segments)


def launch_plan(x_stream: torch.Tensor, w: torch.Tensor, *, tile_cols: int,
                segments: Optional[int] = None, compute_dtype=None,
                hidden_channels: Optional[int] = None) -> SegmentPlan:
    """The :class:`SegmentPlan` of a launch on these inputs: on a CUDA
    tensor, for the card's SMs with :func:`blocks_per_sm` CTAs each of the
    instance that launches (``hidden_channels`` as
    :func:`tilted_fusion_call` takes it); on the CPU (the plain version's
    sequential loop), for one SM of one."""
    B, R, KC, c0p = x_stream.shape
    dtype = compute_dtype or x_stream.dtype
    return _plan_on(x_stream.device, B, KC // tile_cols, tile_cols, w.shape[0], dtype,
                    w.shape[3], segments, hidden_chp(w.shape[3], hidden_channels, c0p, dtype), R)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a copy of it where its address is not a multiple of 16."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _leaky(slopes, relu_flags) -> bool:
    """Whether an activated layer has a leaky slope (not plain ReLU)."""
    return slopes is not None and any(r and s for s, r in zip(slopes, relu_flags))


def _launch_kernel(x_stream, first_col, w, b, *, width, tile_cols, relu_flags,
                   add_anchor, in_channels, anchor_repeats, row_policy,
                   row_bounds, cdt, segments, hidden_channels, slopes, residual,
                   residual_offset):
    dev = x_stream.device
    if cdt not in _DTYPE_CODE:
        raise ValueError(f"the kernel computes in float32 or bfloat16, not {cdt}")
    B, R, KC, c0p = x_stream.shape
    L, chp = w.shape[0], w.shape[3]
    lc = launch_chp(chp, cdt)  # the outputs: Chp padded up to the next built width
    hid = hidden_chp(chp, hidden_channels, c0p, cdt)
    inst = hid or lc  # the instance: a mixed launch runs on its hidden width's
    if L > 31:
        raise ValueError(f"{L} layers exceed the kernel's 31-bit ReLU mask")
    epi = _leaky(slopes, relu_flags) or residual is not None
    if epi and (hid is not None or lc != EPI_CHP):
        raise ValueError(f"a leaky slope or a residual runs on the Chp {EPI_CHP} instance alone; "
                         f"this stack launches Chp {inst}" + (" mixed" if hid else ""))
    tensors = [x_stream, first_col, w, b] + ([row_bounds] if row_bounds is not None else []) + (
        [residual] if residual is not None else [])
    if any(t.device != dev for t in tensors):
        raise ValueError("all kernel inputs must be on the same CUDA device")
    C = tile_cols
    if C > max_tile_cols(inst, cdt):
        raise ValueError(f"tile_cols={C} exceeds the <{cdt}, chp {inst}> instance's "
                         f"{max_tile_cols(inst, cdt)}: a row block's window of "
                         f"{window_pixels(inst, cdt)} pixels holds no 3-row window")
    # the window's 16-byte copies need 16-byte aligned stream and first column
    x, first = (_aligned(t.to(cdt).contiguous()) for t in (x_stream, first_col))
    # zero weights and bias out to the instance's width: its extra channels
    # are exact zeros through every layer, and are cut from the result (a
    # stack packed to an instance's width is passed as it is, not copied;
    # a mixed launch's packing reads the blocks it needs from it)
    pad = lc - chp
    wc, bc = w.to(cdt), b.to(cdt)
    if pad:
        wc, bc = F.pad(wc, (0, pad, 0, pad)), F.pad(bc, (0, pad))
    wc, bc = wc.contiguous(), bc.contiguous()
    bounds = None if row_bounds is None else row_bounds.to(torch.int32).contiguous()
    lib = _lib()
    plan = launch_plan(x, wc, tile_cols=C, segments=segments, compute_dtype=cdt,
                       hidden_channels=hidden_channels)
    # the packed weights, then one workspace a CTA (both whole 16-byte runs):
    # the route's, no slabs where the maps stay in shared memory
    rt = route(R, C, lc, cdt, hid)
    ws_elems = sum(_elems(s) for s in workspace_shapes(L, R, C, inst, onchip=rt.onchip))
    head = packed_weight_bytes(L, lc, c0p, cdt, hidden_chp=hid, onchip=rt.onchip) // cdt.itemsize
    workspace = torch.empty((head + plan.ctas * ws_elems,), dtype=cdt, device=dev)
    tilted_fusion_call.last_launch = {"route": rt.name, "shared_bytes": rt.shared_bytes,
                                      "workspace_bytes": workspace.numel() * cdt.itemsize}
    out = torch.empty((B, R, KC, lc), dtype=cdt, device=dev)
    relu_mask = sum(1 << i for i, r in enumerate(relu_flags) if r)
    res = None if residual is None else _aligned(residual.to(cdt).contiguous())
    slope_arr = ((ctypes.c_float * L)(*(float(s) for s in slopes))
                 if _leaky(slopes, relu_flags) else None)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.tilted_fusion_launch(
            _DTYPE_CODE[cdt], x.data_ptr(), first.data_ptr(), wc.data_ptr(),
            bc.data_ptr(), None if bounds is None else bounds.data_ptr(),
            out.data_ptr(), workspace.data_ptr(),
            B, R, KC // C, C, c0p, inst, lc, L, int(width),
            relu_mask, int(bool(add_anchor)), int(in_channels), int(anchor_repeats),
            int(row_policy == "replicate"), plan.segments, plan.warmup, int(rt.onchip),
            None if res is None else res.data_ptr(),
            0 if res is None else res.shape[1], int(residual_offset),
            0 if res is None else res.shape[3],
            None if slope_arr is None else ctypes.cast(slope_arr, ctypes.c_void_p), stream,
        )
    _check_error(lib, err, "kernel launch")
    tilted_fusion_call.launches += 1
    return out if pad == 0 else out[..., :chp]


class Launch(NamedTuple):
    """The geometry of one call of :func:`tilted_fusion_call` on ``meta``
    tensors: what :func:`launch_cost` needs besides a :class:`SegmentPlan`."""

    bands: int
    band_rows: int
    tiles: int
    tile_cols: int
    c0p: int
    chp: int
    num_layers: int
    dtype: torch.dtype  # the compute dtype
    bounds: bool  # row bounds given (halo slabs)
    segments: Optional[int]  # as the caller forced it; None for the automatic plan
    replicate: bool = False  # row_policy "replicate"
    launch_chp: Optional[int] = None  # the instance's Chp where the card pads past chp
    hidden_chp: Optional[int] = None  # the hidden layers' Chp where the launch is mixed
    residual_elems: int = 0  # elements of the residual a band reads (0: none)

    @property
    def instance_chp(self) -> int:
        """The Chp of the card's output: :func:`launch_chp` of ``chp``,
        which a :func:`launch_cost` of the card counts (with
        ``hidden_chp`` for a mixed launch)."""
        return self.launch_chp or self.chp

    @property
    def out_bytes(self) -> int:
        """Bytes of the tilted result (one ``torch.empty`` on ``meta``)."""
        return (self.bands * self.band_rows * self.tiles * self.tile_cols * self.chp
                * self.dtype.itemsize)

    def plan(self, device) -> SegmentPlan:
        """The plan K1 runs this launch with on ``device``, as
        :func:`launch_plan` picks it for inputs there: the card's SMs and
        the built kernel's CTAs per SM (building it raises where it fails),
        or on the CPU the plain version's one SM of one."""
        return _plan_on(torch.device(device), self.bands, self.tiles, self.tile_cols,
                        self.num_layers, self.dtype, self.chp, self.segments, self.hidden_chp,
                        self.band_rows)

    @property
    def route(self) -> Route:
        """The :class:`Route` the card takes for this launch: where its
        feature maps live (:func:`route`)."""
        return route(self.band_rows, self.tile_cols, self.chp, self.dtype, self.hidden_chp)


_RECORDER: contextvars.ContextVar = contextvars.ContextVar("tilted_fusion_launches",
                                                          default=None)


@contextlib.contextmanager
def record_launches():
    """Collect, in the list this yields, a :class:`Launch` for every call
    of :func:`tilted_fusion_call` on ``meta`` tensors inside the block (in
    this thread or task)."""
    launches: List[Launch] = []
    token = _RECORDER.set(launches)
    try:
        yield launches
    finally:
        _RECORDER.reset(token)


def _meta_call(x_stream, w, *, tile_cols, row_bounds, row_policy, cdt,
               segments, hidden_channels, residual=None) -> torch.Tensor:
    """The result of a launch on ``meta`` tensors: its shape and dtype,
    nothing computed and no launch counted."""
    B, R, KC, c0p = x_stream.shape
    L, chp = w.shape[0], w.shape[3]
    lc = launch_chp(chp, cdt)  # raises where the card has no instance
    out = torch.empty((B, R, KC, chp), dtype=cdt, device="meta")
    launches = _RECORDER.get()
    if launches is not None:
        launches.append(Launch(bands=B, band_rows=R, tiles=KC // tile_cols,
                               tile_cols=tile_cols, c0p=c0p, chp=chp, num_layers=L, dtype=cdt,
                               bounds=row_bounds is not None, segments=segments,
                               replicate=row_policy == "replicate",
                               launch_chp=lc if lc != chp else None,
                               hidden_chp=hidden_chp(chp, hidden_channels, c0p, cdt),
                               residual_elems=(0 if residual is None
                                               else residual[0].numel())))
    return out


def tilted_fusion_call(
    x_stream: torch.Tensor,  # (B, R, K*C, C0p) fresh streams per band
    first_col: torch.Tensor,  # (B, R, 1, C0p)
    w: torch.Tensor,  # (L, 3, 3, Chp, Chp) zero-padded weights
    b: torch.Tensor,  # (L, Chp)
    *,
    width: int,
    tile_cols: int,
    relu_flags: Sequence[bool],
    add_anchor: bool,
    in_channels: int,
    anchor_repeats: int = 9,
    row_policy: str = "zero",
    row_bounds: torch.Tensor = None,  # (B, 2) int32 [valid_lo, valid_hi) per band
    compute_dtype=None,
    out_dtype=None,
    segments: Optional[int] = None,
    hidden_channels: Optional[int] = None,
    slopes: Optional[Sequence[float]] = None,
    residual: Optional[torch.Tensor] = None,  # (B, rows, width, <= Chp)
    residual_offset: int = 0,
) -> torch.Tensor:
    """K1 over a flat batch of bands -> tilted ``(B, R, K*C, Chp)``.

    ``row_policy`` selects the vertical boundary treatment inside every
    band (``zero`` | ``replicate``); ``row_bounds`` optionally marks each
    band's real-image row range — rows outside it are phantom and re-zeroed
    per layer (the halo-slab mechanism); ``compute_dtype`` (default: the
    input's) is the feature-map dtype, float32 or bfloat16 on the card;
    accumulation is always fp32.

    ``segments`` cuts each band's sweep into that many column segments,
    one CTA each (:func:`segment_plan`); ``None`` takes the plan that fills
    the card (:func:`launch_plan`).  The output does not depend on it.

    ``hidden_channels`` is the widest of the feature maps F_1..F_{L-1}
    (``ops.pack_stack`` records it from the layers' shapes); ``None`` means
    Chp.  Where F_0..F_{L-1} fit 32 channels and Chp does not, the card runs
    the mixed launch (:func:`hidden_chp`); the result is the same, bit for
    bit, as the Chp instance's on the same packed stack.  The plain version
    computes the whole padded stack, which is the same function.  It must
    lie in ``[1, Chp]``: a value narrower than the real feature maps would
    drop channels, so pass what ``pack_stack`` computed.

    ``slopes`` (one a layer, or ``None``) gives an activated layer a leaky
    slope in place of ReLU (0 is ReLU).  ``residual`` ``(B, rows, width,
    Cr)`` is added to the last layer's output after its activation, at
    band rows ``[residual_offset, residual_offset + rows)`` and the image's
    columns, channels ``[0, Cr)``: the rounded output plus the residual in
    fp32, rounded again.  A leaky slope or a residual launches the instance
    of :data:`EPI_CHP` channels, not mixed; any other raises on the card.

    A tensor on the CPU runs :func:`tilted_fusion_plain`; a CUDA tensor
    launches the kernel on the current stream (no synchronisation) or
    raises; a ``meta`` tensor gives the result's shape and dtype and
    nothing else (:func:`record_launches`).
    """
    _check_segments(segments)
    _check_hidden_channels(hidden_channels, w.shape[-1])
    args = dict(width=width, tile_cols=tile_cols, relu_flags=list(relu_flags),
                add_anchor=add_anchor, in_channels=in_channels,
                anchor_repeats=anchor_repeats, row_policy=row_policy,
                row_bounds=row_bounds, segments=segments, hidden_channels=hidden_channels,
                slopes=None if slopes is None else [float(s) for s in slopes],
                residual=residual, residual_offset=int(residual_offset))
    if x_stream.device.type == "cpu":
        return tilted_fusion_plain(x_stream, first_col, w, b, compute_dtype=compute_dtype,
                                   out_dtype=out_dtype, **args)
    if x_stream.device.type not in ("cuda", "meta"):
        raise ValueError(f"tilted_fusion_call runs on cuda, cpu or meta, not {x_stream.device}")
    _check_args(x_stream, first_col, w, b, tile_cols, relu_flags, add_anchor,
                in_channels, anchor_repeats, row_policy, row_bounds, width, slopes,
                residual, residual_offset)
    cdt = compute_dtype or x_stream.dtype
    if x_stream.device.type == "meta":
        out = _meta_call(x_stream, w, tile_cols=tile_cols, row_bounds=row_bounds,
                         row_policy=row_policy, cdt=cdt, segments=segments,
                         hidden_channels=hidden_channels, residual=residual)
    else:
        out = _launch_kernel(x_stream, first_col, w, b, cdt=cdt, **args)
    out_dtype = out_dtype or x_stream.dtype
    return out if out_dtype == cdt else out.to(out_dtype)


tilted_fusion_call.launches = 0  # kernel launches since import (or reset)
# the last launch's route and what it took: {"route", "shared_bytes",
# "workspace_bytes"}, or None before the first
tilted_fusion_call.last_launch = None
