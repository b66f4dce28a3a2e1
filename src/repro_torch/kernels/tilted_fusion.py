"""Tilted layer fusion on an NVIDIA Hopper card (K1): wrapper, plain version,
buffer accounting.

The kernel (``csrc/tilted_fusion.cu``, CUDA C++ for ``sm_90a``) computes
what the JAX package's Pallas kernel
``src/repro/kernels/tilted_fusion.py::tilted_fusion_kernel`` computes: per
band, a sequential sweep over K column tiles; in each tile the whole L-layer
stack of SAME 3x3 convs (fp32 accumulation, bias, optional ReLU), phantom
columns (and, under ``row_bounds``, phantom rows) zeroed after every layer,
each layer's output rounded to the compute dtype, the last two columns of
every feature map carried to tile k+1 in the overlap queue, an optional
anchor added to the last layer, and the output tilted by L-1 columns.

* :func:`tilted_fusion_call` — the wrapper.  A CUDA tensor launches the
  kernel (or raises); a CPU tensor runs :func:`tilted_fusion_plain`.  There
  is no other path.  ``tilted_fusion_call.launches`` counts kernel launches.
* :func:`tilted_fusion_plain` — the plain PyTorch version: the same tile
  loop, with the overlap queue and residual ring held as the TPU kernel
  holds them and rounding at the same points.  It is the CPU path and the
  oracle the kernel is held against on the card.
* :func:`kernel_buffers` — the Hopper kernel's own workspace and shared
  memory, per band.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build

__all__ = [
    "tilted_fusion_call",
    "tilted_fusion_plain",
    "round_up_channels",
    "workspace_shapes",
    "kernel_buffers",
    "THREADS",
    "SUPPORTED_CHP",
]

THREADS = 256  # CTA size (kThreads in the source)
SUPPORTED_CHP = (16, 32)  # template instances of the kernel (launch_chp)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def round_up_channels(n: int, multiple: int = 8) -> int:
    """The channel-padding rule: round up to a multiple of 8.  ``ops``
    packing and :func:`kernel_buffers` both go through this."""
    return -(-int(n) // multiple) * multiple


def workspace_shapes(num_layers: int, band_rows: int, tile_cols: int, chp: int):
    """The per-band device-memory workspace of the kernel — ``(slabs,
    overlap_queue)``: two ping-pong feature slabs ``(2, Chp, R, C+2)`` and
    the overlap queue ``(L, Chp, R, 2)`` — as plain tuples.  The wrapper
    allocates exactly this; the kernel's ``workspace_elems`` indexes it."""
    slabs = (2, chp, band_rows, tile_cols + 2)
    overlap = (num_layers, chp, band_rows, 2)
    return slabs, overlap


def _elems(shape) -> int:
    n = 1
    for d in shape:
        n *= int(d)
    return n


def kernel_buffers(*, channels, band_rows: int, tile_cols: int, chp: int = None) -> dict:
    """What one CTA (one band) of the Hopper kernel holds, in ELEMENTS of
    the compute dtype unless a key says bytes.

    * ``slabs`` / ``overlap`` (summed in ``workspace_elements``) — device
      memory the wrapper allocates per band (:func:`workspace_shapes`).
      The TPU kernel's residual ring has no counterpart: the anchor is read
      from the input stream, which stays in device memory.
    * ``shared_bytes`` — dynamic shared memory per CTA: two fp32 stages of
      one layer's weights, ``2 * 9 * Chp * Chp * 4`` bytes.  It does not
      depend on R.
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
    chp = int(chp) if chp else round_up_channels(chmax)
    c0p = round_up_channels(channels[0])
    slabs, overlap = workspace_shapes(L, R, C, chp)
    buffers = {
        "slabs": {"shape": slabs, "elements": _elems(slabs)},
        "overlap": {
            "shape": overlap,
            "elements": _elems(overlap),
            "logical_elements": L * R * 2 * chmax,
        },
        "stream_in_per_column": {"shape": (R, 1, c0p), "elements": R * c0p},
        "stream_out_per_column": {"shape": (R, 1, chp), "elements": R * chp},
        "weights": {"shape": (L, 3, 3, chp, chp), "elements": L * 9 * chp * chp},
        "bias": {"shape": (L, chp), "elements": L * chp},
    }
    return {
        "num_layers": L,
        "band_rows": R,
        "tile_cols": C,
        "chp": chp,
        "c0p": c0p,
        "threads": THREADS,
        "buffers": buffers,
        "workspace_elements": buffers["slabs"]["elements"] + buffers["overlap"]["elements"],
        "shared_bytes": 2 * 9 * chp * chp * 4,
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
) -> torch.Tensor:
    """Plain PyTorch version of K1: same arguments, same tilted
    ``(B, R, K*C, Chp)`` result.

    A loop over the K tiles carrying the overlap queue ``(L, B, R, 2, Chp)``
    and the residual ring ``(B, R, C+L, C0p)``; weights are read in the
    compute dtype and the bias in the compute dtype, both widened to fp32;
    products and sums are fp32; each layer's masked output is rounded to the
    compute dtype, and the anchor is a compute-dtype sum.
    """
    _check_args(x_stream, first_col, w, b, tile_cols, relu_flags, add_anchor,
                in_channels, anchor_repeats, row_policy, row_bounds)
    B, R, KC, c0p = x_stream.shape
    L, chp = w.shape[0], w.shape[3]
    C, W = tile_cols, width
    K = KC // C
    cdt = compute_dtype or x_stream.dtype
    out_dtype = out_dtype or x_stream.dtype
    dev = x_stream.device

    wf = w.to(cdt).float()
    bf = b.to(cdt).float()
    first = first_col[:, :, 0, :].to(cdt)
    overlap = torch.zeros((L, B, R, 2, chp), dtype=cdt, device=dev)
    overlap[0, :, :, 1, :c0p] = first
    ring = torch.zeros((B, R, C + L, c0p), dtype=cdt, device=dev)
    ring[:, :, C + L - 1] = first
    row_ok = None
    if row_bounds is not None:
        rb = row_bounds.to(dev)
        rows = torch.arange(R, device=dev)
        row_ok = ((rows >= rb[:, :1]) & (rows < rb[:, 1:]))[:, :, None, None]
    col_idx = torch.arange(C, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    out = torch.empty((B, R, KC, chp), dtype=out_dtype, device=dev)

    for k in range(K):
        fresh = x_stream[:, :, k * C : (k + 1) * C].to(cdt)
        if add_anchor:
            ring = torch.cat([ring[:, :, C:], fresh], dim=2)
        f = torch.cat([overlap[0, :, :, :, :c0p], fresh], dim=2)
        overlap[0, :, :, :, :c0p] = f[:, :, -2:]
        f = F.pad(f, (0, chp - c0p))
        for l in range(L):
            g = _conv_tile_plain(f, wf[l], bf[l], row_policy)
            if relu_flags[l]:
                g = torch.clamp_min(g, 0.0)
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
                    anchor = torch.where(col_ok, anchor, torch.zeros((), dtype=cdt, device=dev))
                    g = g + anchor
                out[:, :, k * C : (k + 1) * C] = g.to(out_dtype)
    return out


# ----------------------------------------------------------------------
# The wrapper
# ----------------------------------------------------------------------
def _check_args(x_stream, first_col, w, b, tile_cols, relu_flags, add_anchor,
                in_channels, anchor_repeats, row_policy, row_bounds):
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


_lib_handle = None


def _lib() -> ctypes.CDLL:
    global _lib_handle
    if _lib_handle is None:
        lib = _build.load("tilted_fusion")
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.tilted_fusion_launch.argtypes = [ci] + [vp] * 7 + [ci] * 13 + [vp]
        lib.tilted_fusion_launch.restype = ci
        lib.tilted_fusion_error_string.argtypes = [ci]
        lib.tilted_fusion_error_string.restype = ctypes.c_char_p
        _lib_handle = lib
    return _lib_handle


def _launch_kernel(x_stream, first_col, w, b, *, width, tile_cols, relu_flags,
                   add_anchor, in_channels, anchor_repeats, row_policy,
                   row_bounds, cdt):
    dev = x_stream.device
    if cdt not in _DTYPE_CODE:
        raise ValueError(f"the kernel computes in float32 or bfloat16, not {cdt}")
    B, R, KC, c0p = x_stream.shape
    L, chp = w.shape[0], w.shape[3]
    if chp not in SUPPORTED_CHP:
        raise ValueError(
            f"padded channel count {chp} not in the kernel's {SUPPORTED_CHP}"
        )
    if L > 31:
        raise ValueError(f"{L} layers exceed the kernel's 31-bit ReLU mask")
    tensors = [x_stream, first_col, w, b] + ([row_bounds] if row_bounds is not None else [])
    if any(t.device != dev for t in tensors):
        raise ValueError("all kernel inputs must be on the same CUDA device")
    x = x_stream.to(cdt).contiguous()
    first = first_col.to(cdt).contiguous()
    wc = w.to(cdt).contiguous()
    bc = b.to(cdt).contiguous()
    bounds = None if row_bounds is None else row_bounds.to(torch.int32).contiguous()
    lib = _lib()
    C = tile_cols
    ws_elems = sum(_elems(s) for s in workspace_shapes(L, R, C, chp))
    workspace = torch.empty((B * ws_elems,), dtype=cdt, device=dev)
    out = torch.empty((B, R, KC, chp), dtype=cdt, device=dev)
    relu_mask = sum(1 << i for i, r in enumerate(relu_flags) if r)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.tilted_fusion_launch(
            _DTYPE_CODE[cdt], x.data_ptr(), first.data_ptr(), wc.data_ptr(),
            bc.data_ptr(), None if bounds is None else bounds.data_ptr(),
            out.data_ptr(), workspace.data_ptr(),
            B, R, KC // C, C, c0p, chp, L, int(width),
            relu_mask, int(bool(add_anchor)), int(in_channels), int(anchor_repeats),
            int(row_policy == "replicate"), stream,
        )
    if err != 0:
        msg = lib.tilted_fusion_error_string(err).decode()
        raise RuntimeError(f"tilted_fusion kernel launch failed: CUDA error {err} ({msg})")
    tilted_fusion_call.launches += 1
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
) -> torch.Tensor:
    """K1 over a flat batch of bands -> tilted ``(B, R, K*C, Chp)``.

    ``row_policy`` selects the vertical boundary treatment inside every
    band (``zero`` | ``replicate``); ``row_bounds`` optionally marks each
    band's real-image row range — rows outside it are phantom and re-zeroed
    per layer (the halo-slab mechanism); ``compute_dtype`` (default: the
    input's) is the feature-map dtype, float32 or bfloat16 on the card;
    accumulation is always fp32.

    A tensor on the CPU runs :func:`tilted_fusion_plain`; a CUDA tensor
    launches the kernel on the current stream (no synchronisation) or
    raises.
    """
    args = dict(width=width, tile_cols=tile_cols, relu_flags=list(relu_flags),
                add_anchor=add_anchor, in_channels=in_channels,
                anchor_repeats=anchor_repeats, row_policy=row_policy,
                row_bounds=row_bounds)
    if x_stream.device.type == "cpu":
        return tilted_fusion_plain(x_stream, first_col, w, b, compute_dtype=compute_dtype,
                                   out_dtype=out_dtype, **args)
    if x_stream.device.type != "cuda":
        raise ValueError(f"tilted_fusion_call runs on cuda or cpu, not {x_stream.device}")
    _check_args(x_stream, first_col, w, b, tile_cols, relu_flags, add_anchor,
                in_channels, anchor_repeats, row_policy, row_bounds)
    cdt = compute_dtype or x_stream.dtype
    out = _launch_kernel(x_stream, first_col, w, b, cdt=cdt, **args)
    out_dtype = out_dtype or x_stream.dtype
    return out if out_dtype == cdt else out.to(out_dtype)


tilted_fusion_call.launches = 0  # kernel launches since import (or reset)
