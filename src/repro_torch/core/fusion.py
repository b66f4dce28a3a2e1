"""Tilted layer fusion — plain PyTorch executors (paper §II).

Three executors over the same 3x3-conv stack, cross-checked in the tests:

* :func:`conv_stack_reference` — plain full-image, layer-by-layer SAME conv
  (``F.conv2d`` with TF32 off): the numerical ground truth.
* :func:`tilted_fused_band` — the paper's contribution: a band swept by
  parallelepipedal column tiles; a Python loop over the tiles carries the
  overlap buffer from tile k to tile k+1.  Horizontally exact w.r.t. the
  reference.
* :func:`run_banded` — full-image driver with a vertical band boundary
  policy (``zero`` = paper's block-conv rows, ``halo`` = exact recompute
  margins, ``replicate`` = edge padding).

Layouts at every public function are the JAX package's: NHWC activations
and HWIO weights, so arrays pass between the two packages unchanged.  The
hand-written CUDA kernel in ``repro_torch.kernels.tilted_fusion`` runs the
same schedule on the card; this module is its oracle.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.tiling import make_schedule

__all__ = [
    "ConvLayer",
    "conv_stack_reference",
    "exact_fp32",
    "tilted_fused_band",
    "tilted_fused_bands",
    "run_banded",
    "halo_slabs",
    "max_channels",
]


@dataclasses.dataclass
class ConvLayer:
    """One fused 3x3 conv layer: HWIO weights, bias, activation flag.

    An activated layer computes ``v if v > 0 else v * slope``: ReLU at the
    default slope 0, a leaky ReLU (RLFN's 0.05) otherwise."""

    w: torch.Tensor  # (3, 3, Ci, Co)
    b: torch.Tensor  # (Co,)
    relu: bool = True
    slope: float = 0.0

    @property
    def ci(self) -> int:
        return self.w.shape[2]

    @property
    def co(self) -> int:
        return self.w.shape[3]

    def to(self, device=None, dtype=None) -> "ConvLayer":
        return ConvLayer(
            w=self.w.to(device=device, dtype=dtype),
            b=self.b.to(device=device, dtype=dtype),
            relu=self.relu,
            slope=self.slope,
        )


def max_channels(layers: Sequence[ConvLayer]) -> int:
    """max(Ch_i) over all feature maps F_0..F_L (paper's buffer bound)."""
    return max([layers[0].ci] + [l.co for l in layers])


def exact_fp32():
    """Context manager: cuDNN convolutions in full fp32 (TF32 off) for the
    enclosed block only — the global flags are restored on exit.  cuDNN
    runs fp32 convolutions in TF32 by default, which keeps ~3 digits."""
    b = torch.backends.cudnn
    return b.flags(
        enabled=b.enabled,
        benchmark=b.benchmark,
        deterministic=b.deterministic,
        allow_tf32=False,
    )


def _conv2d(x: torch.Tensor, w: torch.Tensor, padding) -> torch.Tensor:
    """NHWC/HWIO conv of a (N, H, W, Ci) batch -> (N, H', W', Co), in fp64
    for fp64 input and in fp32 otherwise."""
    acc = torch.float64 if x.dtype == torch.float64 else torch.float32
    with exact_fp32():
        y = F.conv2d(
            x.permute(0, 3, 1, 2).to(acc), w.permute(3, 2, 0, 1).to(acc),
            padding=padding,
        )
    return y.permute(0, 2, 3, 1)


def _layer(f: torch.Tensor, layer: ConvLayer, padding) -> torch.Tensor:
    """conv + bias (+ ReLU) accumulated in fp32 (fp64 for fp64 input),
    rounded to ``f.dtype``."""
    out = _conv2d(f, layer.w.to(f.dtype), padding)
    out = out + layer.b.to(out.dtype)
    if layer.relu:
        out = F.leaky_relu(out, layer.slope) if layer.slope else torch.relu(out)
    return out.to(f.dtype)


def conv_stack_reference(x: torch.Tensor, layers: Sequence[ConvLayer]) -> torch.Tensor:
    """Full-image layer-by-layer execution with SAME zero padding.

    ``x`` is one ``(H, W, C)`` image or a ``(N, H, W, C)`` batch.  Each layer
    accumulates in fp32 (fp64 for fp64 input) and rounds its output to
    ``x.dtype``, so bf16 input means bf16 feature maps, as in the kernel.
    """
    single = x.ndim == 3
    f = x[None] if single else x
    for layer in layers:
        f = _layer(f, layer, padding=1)
    return f[0] if single else f


# ----------------------------------------------------------------------
# Tilted fused executor
# ----------------------------------------------------------------------
def _conv_tile(f: torch.Tensor, layer: ConvLayer, row_pad: str) -> torch.Tensor:
    """3x3 conv of a (N, R, C+2, Ci) tile slab -> (N, R, C, Co).

    Columns are VALID (the slab already carries the +-1 column halo, courtesy
    of the overlap buffer); rows are padded per the band policy.
    """
    if row_pad == "zero":
        f = F.pad(f, (0, 0, 0, 0, 1, 1))
    elif row_pad == "replicate":
        f = torch.cat([f[:, :1], f, f[:, -1:]], dim=1)
    else:
        raise ValueError(f"unknown row_pad {row_pad!r}")
    return _layer(f, layer, padding=0)


def tilted_fused_bands(
    x: torch.Tensor,
    layers: Sequence[ConvLayer],
    tile_cols: int = 8,
    row_pad: str = "zero",
    row_valid=None,
) -> torch.Tensor:
    """The tilted sweep over a batch of independent bands.

    ``x`` is ``(N, R, W, Ch0)``; ``row_valid`` is ``None`` or an ``(N, 2)``
    integer array of each band's ``[lo, hi)`` real rows (rows outside are
    phantom and re-zeroed after every layer).  Returns ``(N, R, W, Ch_L)``.

    The overlap buffer is a list of per-feature ``(N, R, 2, Ch_l)`` tensors
    carried from tile k to tile k+1 — feature 0 is the input stream, so only
    C fresh input columns are read per tile; phantom columns (absolute
    column < 0 or >= W) are zeroed after every layer.
    """
    if tile_cols < 2:
        raise ValueError("tile_cols must be >= 2 (overlap hand-off is 2 columns)")
    N, R, W, C0 = x.shape
    L = len(layers)
    K, C = make_schedule(width=W, tile_cols=tile_cols, num_layers=L).num_tiles, tile_cols
    dev = x.device

    # Fresh input stream: tile k consumes absolute input columns
    # [k*C + 1, k*C + C]; pad the image with zeros out to column K*C.
    xs = F.pad(x, (0, 0, 0, K * C + 1 - W))[:, :, 1 : K * C + 1, :]

    # Overlap buffer init: all zeros except feature 0 holds input columns
    # [-1, 0] = [zero-pad, first real column].
    overlap = [torch.zeros((N, R, 2, C0), dtype=x.dtype, device=dev)]
    overlap[0][:, :, 1, :] = x[:, :, 0, :]
    overlap += [
        torch.zeros((N, R, 2, l.co), dtype=x.dtype, device=dev) for l in layers[:-1]
    ]

    row_ok = None
    if row_valid is not None:
        if not isinstance(row_valid, torch.Tensor):
            row_valid = torch.as_tensor(np.asarray(row_valid))
        bounds = row_valid.to(dev).reshape(N, 2)
        rows = torch.arange(R, device=dev)
        row_ok = ((rows >= bounds[:, :1]) & (rows < bounds[:, 1:]))[:, :, None, None]

    col_idx = torch.arange(C, device=dev)
    tiles = []
    for k in range(K):
        f = torch.cat([overlap[0], xs[:, :, k * C : (k + 1) * C]], dim=2)
        overlap[0] = f[:, :, -2:]
        for l, layer in enumerate(layers):
            g = _conv_tile(f, layer, row_pad)
            abs_cols = k * C - l + col_idx
            valid = ((abs_cols >= 0) & (abs_cols < W))[None, None, :, None]
            g = torch.where(valid, g, torch.zeros((), dtype=g.dtype, device=dev))
            if row_ok is not None:
                g = torch.where(row_ok, g, torch.zeros((), dtype=g.dtype, device=dev))
            if l < L - 1:
                f = torch.cat([overlap[l + 1], g], dim=2)
                overlap[l + 1] = g[:, :, -2:]
            else:
                tiles.append(g)
    # Tile k's output occupies absolute columns [k*C - (L-1), ... + C):
    # contiguous; slice off the tilt.
    out = torch.cat(tiles, dim=2)
    return out[:, :, L - 1 : L - 1 + W]


def tilted_fused_band(
    x: torch.Tensor,
    layers: Sequence[ConvLayer],
    tile_cols: int = 8,
    row_pad: str = "zero",
    row_valid: Optional[Tuple[int, int]] = None,
) -> torch.Tensor:
    """Run the tilted layer-fusion sweep over one ``(R, W, Ch0)`` band.

    ``row_valid`` is an optional ``(lo, hi)`` band-row range of real image
    content; rows outside it are phantom and re-zeroed after every layer so
    they behave exactly like SAME padding.  Returns ``(R, W, Ch_L)``.
    """
    bounds = None if row_valid is None else [tuple(row_valid)]
    return tilted_fused_bands(x[None], layers, tile_cols, row_pad, bounds)[0]


# ----------------------------------------------------------------------
# Halo slab marshalling (shared by the tilted and kernel backends)
# ----------------------------------------------------------------------
def halo_slabs(frames: torch.Tensor, band_rows: int, num_layers: int):
    """Marshal halo slabs: (N, H, W, C0) -> (N*B, R+2L, W, C0) + (N*B, 2).

    Each band's slab is the (R + 2L)-row window of the zero-padded frame
    starting at its own row offset; the int32 bounds mark which slab rows
    are real image content (``[lo, hi)`` in slab coordinates).  Rows outside
    the bounds are phantom and must be re-zeroed after every conv layer;
    cropping L rows per side afterwards reproduces the full-image result.

    The bounds are computed on the frames' device: a host array copied
    there would make torch synchronize the stream after the pageable copy,
    inside every halo dispatch.
    """
    N, H, W, C0 = frames.shape
    R, L = band_rows, num_layers
    B = H // R
    slab = R + 2 * L
    padded = F.pad(frames, (0, 0, 0, 0, L, L))
    slabs = torch.stack([padded[:, b * R : b * R + slab] for b in range(B)], dim=1)
    starts = torch.arange(B, device=frames.device) * R
    lo = (L - starts).clamp(0, slab)
    hi = (L + H - starts).clamp(0, slab)
    bounds = torch.stack([lo, hi], dim=1).repeat(N, 1).to(torch.int32)
    return slabs.reshape(N * B, slab, W, C0), bounds


# ----------------------------------------------------------------------
# Full-image banded driver
# ----------------------------------------------------------------------
def run_banded(
    image: torch.Tensor,
    layers: Sequence[ConvLayer],
    band_rows: int = 60,
    tile_cols: int = 8,
    vertical_policy: str = "zero",
) -> torch.Tensor:
    """Tilted layer fusion over a full ``(H, W, C)`` image, band by band.

    vertical_policy:
      * ``"zero"`` — each R-row band is convolved with zero padding at its
        top/bottom edges (the paper's block convolution vertically).
      * ``"halo"`` — exact: each band carries an L-row margin on each side,
        cropped after the fused stack.
      * ``"replicate"`` — edge-replicate padding at band edges.
    """
    H, W, _ = image.shape
    L = len(layers)
    if H % band_rows != 0:
        raise ValueError(f"image height {H} must be a multiple of band_rows {band_rows}")
    if vertical_policy in ("zero", "replicate"):
        bands = image.reshape(H // band_rows, band_rows, W, -1)
        out = tilted_fused_bands(bands, layers, tile_cols, row_pad=vertical_policy)
    elif vertical_policy == "halo":
        slabs, bounds = halo_slabs(image[None], band_rows, L)
        out = tilted_fused_bands(slabs, layers, tile_cols, "zero", bounds)
        out = out[:, L : L + band_rows]
    else:
        raise ValueError(f"unknown vertical_policy {vertical_policy!r}")
    return out.reshape(H, W, out.shape[-1])
