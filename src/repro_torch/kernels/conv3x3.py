"""One SAME 3x3 conv layer on an NVIDIA Hopper card (K2): wrapper and plain
version.

The kernel (``csrc/conv3x3.cu``, CUDA C++ for ``sm_90a``) computes what the
JAX package's Pallas kernel ``src/repro/kernels/conv3x3.py::_kernel``
computes: one SAME-padded 3x3 conv over a ``(R, W, Ci)`` band with HWIO
weights ``(3, 3, Ci, Co)`` — input, weights and bias widened to fp32, fp32
accumulation of the 9 taps, the bias, an optional ReLU, and ONE rounding to
the input's dtype at the store.  It is the layer-by-layer baseline
datapath the paper compares tilted fusion against: every feature map makes
a round trip through device memory.

* :func:`conv3x3_call` — the wrapper.  A CUDA tensor launches the kernel
  (or raises); a CPU tensor runs :func:`conv3x3_plain`.  There is no other
  path.  ``conv3x3_call.launches`` counts kernel launches.  On the card a
  layer of Ci, Co <= 32 runs persistent CTAs over ``TILE_ROWS x TILE_COLS``
  output tiles on the tensor cores (bf16 products; fp32 through 3xTF32),
  with at most :func:`blocks_per_sm` CTAs on each SM (:func:`launch_grid`);
  a wider one (:func:`is_wide`, Ci and Co up to :data:`MAX_CHANNELS`) runs
  the wide instance: persistent CTAs of two warpgroups, every tile with all
  its outputs on ``wgmma``, Ci in k-chunks of 32, each (chunk, tap) with its
  own slice of weights, packed once a launch into a workspace the wrapper
  allocates and streamed through shared memory behind the MMAs one step
  (one, three or nine taps) at a time (:func:`wide_plan`,
  :func:`wide_copies`).
* :func:`conv3x3_plain` — the plain PyTorch version of the TPU kernel's
  dataflow: zero padding out to the column-tile grid, the ``(R+2, C+2, Ci)``
  slab of every C-column tile, 9 shifted fp32 products in the order dy then
  dx.  It is the CPU path and the oracle the kernel is held against on the
  card.
"""

from __future__ import annotations

import ctypes
import functools
import re
from pathlib import Path

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build

__all__ = [
    "conv3x3_call",
    "conv3x3_plain",
    "SUPPORTED_DTYPES",
    "MAX_CHANNELS",
    "NARROW_CHANNELS",
    "is_wide",
    "wide_plan",
    "wide_copies",
    "wide_occupancy",
    "TILE_ROWS",
    "TILE_COLS",
    "blocks_per_sm",
    "launch_grid",
    "smem_bytes",
]

SUPPORTED_DTYPES = (torch.float32, torch.bfloat16)  # storage dtypes on the card
MAX_CHANNELS = 128  # Ci and Co the kernel takes (kWideMaxChannels in the source)
NARROW_CHANNELS = 32  # up to here in both, the persistent instances (kMaxChannels)
TILE_ROWS, TILE_COLS = 8, 32  # a CTA's output tile on the card (kTileRows, kTileCols)
_DTYPE_CODE = {dt: i for i, dt in enumerate(SUPPORTED_DTYPES)}  # the launcher's dtype argument


def _check_args(x, w, b, tile_cols):
    if x.ndim != 3:
        raise ValueError(f"x must be (R, W, Ci), got shape {tuple(x.shape)}")
    ci = x.shape[2]
    if w.ndim != 4 or tuple(w.shape[:3]) != (3, 3, ci):
        raise ValueError(f"w must be (3, 3, {ci}, Co), got shape {tuple(w.shape)}")
    co = w.shape[3]
    if tuple(b.shape) != (co,):
        raise ValueError(f"b must be ({co},), got shape {tuple(b.shape)}")
    if not (x.dtype == w.dtype == b.dtype):
        raise ValueError(f"x, w and b must share one dtype, got {x.dtype}, {w.dtype}, {b.dtype}")
    if not (x.device == w.device == b.device):
        raise ValueError(f"x, w and b must be on one device, got {x.device}, {w.device}, {b.device}")
    if int(tile_cols) < 1:
        raise ValueError(f"tile_cols must be >= 1, got {tile_cols}")


# ----------------------------------------------------------------------
# Plain version
# ----------------------------------------------------------------------
def conv3x3_plain(
    x: torch.Tensor,  # (R, W, Ci)
    w: torch.Tensor,  # (3, 3, Ci, Co)
    b: torch.Tensor,  # (Co,)
    *,
    tile_cols: int = 8,
    relu: bool = True,
) -> torch.Tensor:
    """Plain PyTorch version of K2 -> ``(R, W, Co)`` in ``x.dtype``.

    Pads as the TPU launcher does (+-1 row, 1 column on the left, out to
    ``K*C + 1`` on the right), cuts the ``(R+2, C+2, Ci)`` slab of each of
    the K column tiles, widens slab and weights to fp32, accumulates the 9
    shifted ``(R*C, Ci) @ (Ci, Co)`` products over all tiles at once in
    the order dy then dx, adds the fp32 bias, applies the optional ReLU,
    casts once and crops to W.
    """
    _check_args(x, w, b, tile_cols)
    R, W, ci = x.shape
    co = w.shape[3]
    C = int(tile_cols)
    K = -(-W // C)
    xp = F.pad(x, (0, 0, 1, K * C + 1 - W, 1, 1))  # (R+2, K*C+2, Ci)
    # (R+2, K, Ci, C+2) -> (K, R+2, C+2, Ci): tile k's slab is columns
    # [k*C, k*C + C + 2) of the padded band
    slabs = xp.unfold(1, C + 2, C).permute(1, 0, 3, 2).float()
    wf = w.float()
    acc = torch.zeros((K, R, C, co), dtype=torch.float32, device=x.device)
    for dy in range(3):
        for dx in range(3):
            patch = slabs[:, dy : dy + R, dx : dx + C].reshape(K * R * C, ci)
            acc = acc + torch.matmul(patch, wf[dy, dx]).reshape(K, R, C, co)
    out = acc + b.float()
    if relu:
        out = torch.clamp_min(out, 0.0)
    out = out.to(x.dtype).permute(1, 0, 2, 3).reshape(R, K * C, co)
    return out[:, :W].contiguous()


# ----------------------------------------------------------------------
# The wrapper
# ----------------------------------------------------------------------
_lib_handle = None


def _lib() -> ctypes.CDLL:
    global _lib_handle
    if _lib_handle is None:
        lib = _build.load("conv3x3")
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.conv3x3_launch.argtypes = [ci] + [vp] * 4 + [ci] * 6 + [vp]
        lib.conv3x3_launch.restype = ci
        lib.conv3x3_blocks_per_sm.argtypes = [ci, ci, ctypes.POINTER(ci)]
        lib.conv3x3_blocks_per_sm.restype = ci
        lib.conv3x3_smem_bytes.argtypes = [ci, ci, ctypes.POINTER(ci)]
        lib.conv3x3_smem_bytes.restype = ci
        lib.conv3x3_wide_launch.argtypes = [ci] + [vp] * 5 + [ci] * 6 + [vp]
        lib.conv3x3_wide_launch.restype = ci
        lib.conv3x3_wide_workspace_bytes.argtypes = [ci, ci, ci]
        lib.conv3x3_wide_workspace_bytes.restype = ci
        lib.conv3x3_wide_occupancy.argtypes = [ci, ci, ci, ctypes.POINTER(ci),
                                               ctypes.POINTER(ci)]
        lib.conv3x3_wide_occupancy.restype = ci
        lib.conv3x3_error_string.argtypes = [ci]
        lib.conv3x3_error_string.restype = ctypes.c_char_p
        _lib_handle = lib
    return _lib_handle


def _check_error(lib, err, what):
    if err != 0:
        msg = lib.conv3x3_error_string(err).decode()
        raise RuntimeError(f"conv3x3 {what} failed: CUDA error {err} ({msg})")


def _dtype_code(dtype):
    if dtype not in SUPPORTED_DTYPES:
        raise ValueError(f"the kernel stores float32 or bfloat16, not {dtype}")
    return _DTYPE_CODE[dtype]


def is_wide(ci: int, co: int) -> bool:
    """Whether a ``ci -> co`` layer runs the wide instance (Ci or Co above
    :data:`NARROW_CHANNELS`; :func:`wide_plan`).  The others run the
    persistent instances, taps folded into K at Ci <= 3."""
    return int(ci) > NARROW_CHANNELS or int(co) > NARROW_CHANNELS


_SOURCE = Path(__file__).resolve().parent / "csrc" / "conv3x3.cu"
FOLD_MAX_CI = 3  # taps folded into K up to here (kFoldMaxCi)


@functools.lru_cache(maxsize=None)
def _wide_table() -> tuple:
    """The wide instances' plan as the CUDA source states it: ``({(element
    bytes, N): (og, mb, nh, pp, tp)}, ring bytes, most stages)`` from
    ``kWidePlan``, ``kWideRingBytes`` and ``kWideMaxStages``."""
    src = _SOURCE.read_text()
    body = re.search(r"kWidePlan\[\] = \{(.*?)\};", src, re.S).group(1)
    rows = {(int(r[0]), int(r[1])): tuple(map(int, r[2:])) for r in re.findall(
        r"\{\s*" + r",\s*".join([r"(\d+)"] * 7) + r"\s*\}", body)}
    ring = int(re.search(r"kWideRingBytes = (\d+);", src).group(1))
    stages = int(re.search(r"kWideMaxStages = (\d+);", src).group(1))
    return rows, ring, stages


def wide_plan(ci: int, co: int, dtype) -> dict:
    """The wide instance a ``ci -> co`` layer of ``dtype`` storage runs on,
    as ``csrc/conv3x3.cu`` builds it (its ``WideCfg``; a card test holds
    ``smem_bytes`` to the built kernel's): ``n`` (Co padded to 32, 48, 64,
    96 or 128), ``fold`` (taps folded into K, Ci <= 3), ``og`` (1: the two
    warpgroups split the tile's pixels; 2: its outputs), ``mb`` (m64 blocks
    a warpgroup), ``nh`` (the pieces a block's outputs are computed in),
    ``pp`` (the pieces in flight, each with its partial sums), ``tp`` (the
    taps a step), ``rows`` (tile rows of 32 columns), ``chunks`` and
    ``steps`` (tp taps of a chunk each, one when folded), ``stages`` (the
    slice ring, a step's slices a stage), ``resident`` (every slice stays
    in the ring), and the bytes of a tap's ``slice``, a ``window`` and the
    CTA's ``smem_bytes``."""
    if not is_wide(ci, co):
        raise ValueError(f"a {ci} -> {co} layer runs the persistent instances")
    table, ring, max_stages = _wide_table()
    esize = torch.empty((), dtype=dtype).element_size()
    n = next(w for w in (32, 48, 64, 96, 128) if co <= w)
    og, mb, nh, pp, tp = table[esize, n]
    fold = int(ci) <= FOLD_MAX_CI
    tp = 1 if fold else tp
    rows = 2 * mb * (2 // og)
    window = (rows + 2) * (TILE_COLS + 2) * (esize if fold else (36 if esize == 4 else 20)) * 4
    slice_bytes = 32 * n * (8 if esize == 4 else 2)  # a tap's
    stages = 1 if fold else max(3, min(max_stages, ring // (tp * slice_bytes)))
    runs = (8 // og) * (16 * n * esize + 16)  # a warp's (og = 1) or a pair's staging
    barriers = -(-16 * stages // 16) * 16  # a full and an empty mbarrier a stage
    chunks = 1 if fold else -(-int(ci) // 32)
    steps = 1 if fold else 9 // tp * chunks
    return dict(n=n, fold=fold, og=og, mb=mb, nh=nh, pp=pp, tp=tp, rows=rows, chunks=chunks,
                steps=steps, stages=stages, resident=steps <= stages, slice=slice_bytes,
                window=window,
                smem_bytes=stages * tp * slice_bytes + 2 * window + runs + 4 * n + barriers)


def wide_copies(ci: int, co: int, R: int, W: int, dtype, sms: int = 132) -> dict:
    """What a wide launch over an ``(R, W)`` map copies into shared memory:
    ``cta_chunks`` (the (tile, k-chunk) windows, each copied once),
    ``window_bytes`` (their copies: a pixel's 32 channels of the chunk, or
    its Ci when folded), ``weight_bytes`` (a slice a step of every tile, or
    every slice once a CTA where they stay resident; ``sms`` CTAs) and
    ``smem_bytes`` (the two)."""
    plan = wide_plan(ci, co, dtype)
    esize = torch.empty((), dtype=dtype).element_size()
    tiles = -(-int(R) // plan["rows"]) * -(-int(W) // TILE_COLS)
    pixel = (int(ci) if plan["fold"] else 32) * esize
    windows = tiles * plan["chunks"] * (plan["rows"] + 2) * (TILE_COLS + 2) * pixel
    ctas = min(tiles, int(sms))
    weights = ((ctas if plan["resident"] else tiles) * plan["steps"] * plan["tp"]
               * plan["slice"])
    return dict(cta_chunks=tiles * plan["chunks"], window_bytes=windows, weight_bytes=weights,
                smem_bytes=windows + weights)


def wide_occupancy(device, dtype, ci: int = 128, co: int = 128) -> dict:
    """``blocks_per_sm`` and ``smem_bytes`` of the wide instance a ``ci ->
    co`` layer of ``dtype`` runs on, on a CUDA ``device`` (builds the kernel
    on first use)."""
    lib = _lib()
    blocks, nbytes = ctypes.c_int(0), ctypes.c_int(0)
    with torch.cuda.device(torch.device(device)):
        _check_error(lib, lib.conv3x3_wide_occupancy(_dtype_code(dtype), int(ci), int(co),
                                                     ctypes.byref(blocks), ctypes.byref(nbytes)),
                     "occupancy query")
    return {"blocks_per_sm": blocks.value, "smem_bytes": nbytes.value}


@functools.lru_cache(maxsize=None)
def _wide_ctas(device_index: int, dtype_code: int, ci: int, co: int) -> int:
    lib = _lib()
    blocks, nbytes = ctypes.c_int(0), ctypes.c_int(0)
    with torch.cuda.device(device_index):
        _check_error(lib, lib.conv3x3_wide_occupancy(dtype_code, ci, co, ctypes.byref(blocks),
                                                     ctypes.byref(nbytes)), "occupancy query")
        sms = torch.cuda.get_device_properties(device_index).multi_processor_count
    if blocks.value < 1:
        raise RuntimeError(f"the wide conv3x3 kernel (dtype code {dtype_code}, {ci} -> {co}) "
                           "fits no CTA on an SM")
    return sms * blocks.value


@functools.lru_cache(maxsize=None)
def _blocks_per_sm(device_index: int, dtype_code: int, ci: int) -> int:
    lib = _lib()
    blocks = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        _check_error(lib, lib.conv3x3_blocks_per_sm(dtype_code, ci, ctypes.byref(blocks)),
                     "occupancy query")
    if blocks.value < 1:
        raise RuntimeError(f"the conv3x3 kernel (dtype code {dtype_code}, Ci {ci}) fits no "
                           "CTA on an SM")
    return blocks.value


def blocks_per_sm(device, dtype, ci: int) -> int:
    """Resident CTAs per SM of the kernel instance that ``dtype`` storage
    and ``ci`` input channels launch, on a CUDA ``device``, from
    ``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` (builds the kernel on
    first use)."""
    device = torch.device(device)
    index = device.index if device.index is not None else torch.cuda.current_device()
    return _blocks_per_sm(index, _dtype_code(dtype), int(ci))


def smem_bytes(dtype, ci: int) -> int:
    """Dynamic shared memory of one CTA, in bytes, of the kernel instance
    that ``dtype`` storage and ``ci`` input channels launch (builds the
    kernel on first use): the weights in B-fragment layout, two input
    windows and the warps' output staging runs."""
    lib = _lib()
    nbytes = ctypes.c_int(0)
    _check_error(lib, lib.conv3x3_smem_bytes(_dtype_code(dtype), int(ci), ctypes.byref(nbytes)),
                 "shared memory query")
    return nbytes.value


def launch_grid(x: torch.Tensor) -> tuple:
    """``(tiles, ctas)`` of a launch of the persistent instances (Ci, Co <=
    32) on the CUDA ``(R, W, Ci)`` tensor ``x``: the ``TILE_ROWS x
    TILE_COLS`` output tiles, and the persistent CTAs that walk them, at
    most the SM count times :func:`blocks_per_sm`."""
    R, W, ci = x.shape
    tiles = -(-R // TILE_ROWS) * -(-W // TILE_COLS)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    return tiles, min(tiles, sms * blocks_per_sm(x.device, x.dtype, ci))


def _launch_wide(code, xc, wc, bc, out, relu):
    R, W, ci = xc.shape
    co = wc.shape[3]
    lib = _lib()
    index = xc.device.index if xc.device.index is not None else torch.cuda.current_device()
    ctas = _wide_ctas(index, code, ci, co)
    ws = torch.empty((lib.conv3x3_wide_workspace_bytes(code, ci, co),), dtype=torch.uint8,
                     device=xc.device)
    with torch.cuda.device(xc.device):
        stream = torch.cuda.current_stream(xc.device).cuda_stream
        err = lib.conv3x3_wide_launch(code, xc.data_ptr(), wc.data_ptr(), bc.data_ptr(),
                                      out.data_ptr(), ws.data_ptr(), R, W, ci, co,
                                      int(bool(relu)), ctas, stream)
    _check_error(lib, err, "kernel launch")


def _launch_kernel(x, w, b, *, relu):
    code = _dtype_code(x.dtype)
    R, W, ci = x.shape
    co = w.shape[3]
    if ci > MAX_CHANNELS or co > MAX_CHANNELS:
        raise ValueError(
            f"channels {ci} -> {co} exceed the kernel's limit of {MAX_CHANNELS}"
        )
    xc, wc, bc = x.contiguous(), w.contiguous(), b.contiguous()
    out = torch.empty((R, W, co), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    if is_wide(ci, co):
        _launch_wide(code, xc, wc, bc, out, relu)
        conv3x3_call.launches += 1
        return out
    _, ctas = launch_grid(xc)
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.conv3x3_launch(
            code, xc.data_ptr(), wc.data_ptr(), bc.data_ptr(),
            out.data_ptr(), R, W, ci, co, int(bool(relu)), ctas, stream,
        )
    _check_error(lib, err, "kernel launch")
    conv3x3_call.launches += 1
    return out


def conv3x3_call(
    x: torch.Tensor,  # (R, W, Ci)
    w: torch.Tensor,  # (3, 3, Ci, Co)
    b: torch.Tensor,  # (Co,)
    *,
    tile_cols: int = 8,
    relu: bool = True,
) -> torch.Tensor:
    """K2: SAME 3x3 conv + bias (+ ReLU) over one band -> ``(R, W, Co)`` in
    ``x.dtype``.

    A tensor on the CPU runs :func:`conv3x3_plain`; a CUDA tensor launches
    the kernel on the current stream (no synchronisation) or raises.  On
    the card the kernel picks its own output tile and ``tile_cols`` (the
    JAX function's argument) only has to be >= 1; the result does not
    depend on it.
    """
    if x.device.type == "cpu":
        return conv3x3_plain(x, w, b, tile_cols=tile_cols, relu=relu)
    _check_args(x, w, b, tile_cols)
    if x.device.type != "cuda":
        raise ValueError(f"conv3x3_call runs on cuda or cpu, not {x.device}")
    return _launch_kernel(x, w, b, relu=relu)


conv3x3_call.launches = 0  # kernel launches since import (or reset)
