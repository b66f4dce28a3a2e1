"""Public wrappers around the kernels.

The tilted-fusion wrappers do the host-side marshalling the accelerator's
DMA engine performs in the paper: channel padding, building the
fresh-column stream, and undoing the output tilt.  :func:`conv3x3` is the
single-layer conv of the layer-by-layer baseline datapath.  Each is a
line-for-line counterpart of the JAX package's ``kernels/ops.py``; the
kernel behind them runs on whatever device the tensors are on (the CUDA
kernel on the card, its plain version on the CPU), so the JAX wrappers'
``interpret`` argument has no counterpart.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.fusion import ConvLayer, halo_slabs
from repro_torch.core.tiling import make_schedule
from repro_torch.kernels import conv3x3 as _conv3x3
from repro_torch.kernels import tilted_fusion as _tilted

__all__ = [
    "band_streams",
    "tilted_fused_stack",
    "tilted_fused_frames",
    "tilted_fused_band_stack",
    "pack_layers",
    "pack_stack",
    "PackedLayers",
    "conv3x3",
]

VERTICAL_POLICIES = ("zero", "halo", "replicate")


def pack_layers(layers: Sequence[ConvLayer], chp: Optional[int] = None, dtype=None):
    """Zero-pad a heterogeneous conv stack to uniform (L,3,3,Chp,Chp) + (L,Chp).

    Padded input/output channels carry zero weights and biases, so they stay
    identically zero through every layer — the kernel never masks channels.
    ``chp`` defaults to max(Ch) rounded up to 8.
    """
    chmax = max([layers[0].ci] + [l.co for l in layers])
    chp = chp or _tilted.round_up_channels(chmax)
    if chp < chmax:
        raise ValueError(f"chp={chp} < max channels {chmax}")
    dtype = dtype or layers[0].w.dtype
    dev = layers[0].w.device
    L = len(layers)
    w = torch.zeros((L, 3, 3, chp, chp), dtype=dtype, device=dev)
    b = torch.zeros((L, chp), dtype=dtype, device=dev)
    for i, l in enumerate(layers):
        w[i, :, :, : l.ci, : l.co] = l.w.to(dtype)
        b[i, : l.co] = l.b.to(dtype)
    return w, b, chp


@dataclasses.dataclass
class PackedLayers:
    """A conv stack in the kernel's packed storage form, plus its static
    facts (channel pad, ReLU flags, real output channels, the widest hidden
    feature map).  Packed once per weight stack
    (``engine.executor.prepare_stack``) and reused by every launch."""

    w: torch.Tensor  # (L, 3, 3, Chp, Chp)
    b: torch.Tensor  # (L, Chp)
    chp: int
    relu: Tuple[bool, ...]
    out_channels: int  # Ch_L of the real (unpadded) stack
    # the widest of F_1..F_{L-1} (the input's for L = 1), from the layers'
    # shapes; K1 runs a stack whose hidden maps fit 32 channels on its
    # narrow instance even where Chp is wider.  None: Chp
    hidden_channels: Optional[int] = None
    # each layer's leaky slope where it is activated (0: ReLU); None: all 0
    slopes: Optional[Tuple[float, ...]] = None

    @property
    def num_layers(self) -> int:
        return len(self.relu)


def pack_stack(
    layers: Sequence[ConvLayer], chp: Optional[int] = None, dtype=None
) -> PackedLayers:
    """Pack a conv stack for the kernel (``pack_layers``) and bundle the
    static facts the launch needs."""
    w, b, chp = pack_layers(layers, chp, dtype=dtype)
    slopes = tuple(float(getattr(l, "slope", 0.0)) for l in layers)
    return PackedLayers(
        w=w,
        b=b,
        chp=chp,
        relu=tuple(bool(l.relu) for l in layers),
        out_channels=layers[-1].co,
        hidden_channels=max(l.co for l in layers[:-1]) if len(layers) > 1 else layers[0].ci,
        slopes=slopes if any(slopes) else None,
    )


def band_streams(xb: torch.Tensor, tile_cols: int, num_layers: int):
    """K1's input marshalling for a (B, R, W, C0) band batch: the fresh
    stream ``(B, R, K*C, C0p)`` — tile k consumes input columns
    ``[k*C + 1, k*C + C]``, zero past the image — and the first column
    ``(B, R, 1, C0p)``, channels zero-padded to a multiple of 8."""
    B, R, W, C0 = xb.shape
    K = make_schedule(width=W, tile_cols=tile_cols, num_layers=num_layers).num_tiles
    xb = F.pad(xb, (0, _tilted.round_up_channels(C0) - C0))
    KC = K * tile_cols
    xs = F.pad(xb, (0, 0, 0, KC + 1 - W))[:, :, 1 : KC + 1, :].contiguous()
    return xs, xb[:, :, 0:1, :].contiguous()


def _tilted_fused_bands(
    xb: torch.Tensor,  # (B, R, W, C0) band-major input
    packed: PackedLayers,
    *,
    tile_cols: int,
    add_anchor: bool,
    anchor_repeats: int,
    row_policy: str = "zero",
    row_bounds: Optional[torch.Tensor] = None,
    compute_dtype=None,
    clock=None,
    residual: Optional[torch.Tensor] = None,
    residual_offset: int = 0,
) -> torch.Tensor:
    """Run K1 over a flat batch of bands -> (B, R, W, ChL).

    Every band is independent (the kernel resets its overlap queue per
    band), so bands from different frames share one launch — the whole
    frame batch is ONE kernel launch.  ``clock`` (a stage clock,
    ``engine.spans.StageClock``) is marked ``k1`` at the launch and
    ``marshal`` after it.  ``residual`` (B, rows, W, Cr) is added to the
    last layer's output at band rows ``residual_offset`` on
    (``tilted_fusion_call``).
    """
    B, R, W, C0 = xb.shape
    C, L = tile_cols, packed.num_layers
    co_l = packed.out_channels
    xs, first_col = band_streams(xb, tile_cols, L)
    if clock is not None:
        clock.mark("k1")
    out = _tilted.tilted_fusion_call(
        xs,
        first_col,
        packed.w,
        packed.b,
        width=W,
        tile_cols=C,
        relu_flags=list(packed.relu),
        add_anchor=add_anchor,
        in_channels=C0,
        anchor_repeats=anchor_repeats,
        row_policy=row_policy,
        row_bounds=row_bounds,
        compute_dtype=compute_dtype,
        hidden_channels=packed.hidden_channels,
        slopes=packed.slopes,
        residual=residual,
        residual_offset=residual_offset,
    )
    if clock is not None:
        clock.mark("marshal")
    # Undo the tilt: tile k's block holds F_L columns [k*C - (L-1), ...+C).
    return out[:, :, L - 1 : L - 1 + W, :co_l]


def tilted_fused_stack(
    x: torch.Tensor,
    layers: Sequence[ConvLayer],
    *,
    band_rows: int = 60,
    tile_cols: int = 8,
    chp: Optional[int] = None,
    add_anchor: bool = False,
    anchor_repeats: int = 9,
    vertical_policy: str = "zero",
    compute_dtype=None,
) -> torch.Tensor:
    """Tilted layer fusion of a full (H, W, C0) image through K1 -> (H, W, Ch_L)
    features (or anchored output when ``add_anchor``)."""
    H, W, C0 = x.shape
    out = tilted_fused_frames(
        x[None],
        layers,
        band_rows=band_rows,
        tile_cols=tile_cols,
        chp=chp,
        add_anchor=add_anchor,
        anchor_repeats=anchor_repeats,
        vertical_policy=vertical_policy,
        compute_dtype=compute_dtype,
    )
    return out.reshape(H, W, out.shape[-1])


def tilted_fused_frames(
    frames: torch.Tensor,
    layers: Optional[Sequence[ConvLayer]] = None,
    *,
    band_rows: int = 60,
    tile_cols: int = 8,
    chp: Optional[int] = None,
    add_anchor: bool = False,
    anchor_repeats: int = 9,
    vertical_policy: str = "zero",
    compute_dtype=None,
    packed: Optional[PackedLayers] = None,
    clock=None,
    residual: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Tilted layer fusion of a batch of frames (N, H, W, C0) -> (N, H, W, ChL).

    All N * (H / band_rows) bands go to one kernel launch.
    ``vertical_policy``: ``zero``/``replicate`` run the R-row bands directly
    with the matching in-kernel row padding; ``halo`` marshals (R + 2L)-row
    slabs with per-band valid-row bounds and crops the recompute margin.
    ``compute_dtype`` is the kernel's feature-map dtype (default: the
    input's; accumulation is fp32).  ``packed`` supplies a pre-packed stack
    (:func:`pack_stack`); when given, ``layers`` is ignored.  ``clock`` (a
    stage clock, ``engine.spans.StageClock``) is marked ``marshal`` where
    the input's marshalling into K1's streams begins, ``k1`` at the launch
    and ``marshal`` again after it (the margin's crop).  ``residual``
    ``(N, H, W, Cr)`` is added to the last layer's output after its
    activation (a residual block's skip), each band's own rows under every
    policy.
    """
    N, H, W, C0 = frames.shape
    R = band_rows
    if H % R != 0:
        raise ValueError(f"height {H} must be a multiple of band_rows {R}")
    if vertical_policy not in VERTICAL_POLICIES:
        raise ValueError(
            f"vertical_policy {vertical_policy!r} not in {VERTICAL_POLICIES}"
        )
    if packed is None:
        if layers is None:
            raise ValueError("pass either layers or packed")
        packed = pack_stack(layers, chp, dtype=compute_dtype)
    L = packed.num_layers
    if residual is not None:
        if tuple(residual.shape[:3]) != (N, H, W):
            raise ValueError(f"residual {tuple(residual.shape)} does not match the frames' "
                             f"{(N, H, W)}")
        residual = residual.reshape(N * (H // R), R, W, residual.shape[3])
    if clock is not None:
        clock.mark("marshal")
    if vertical_policy == "halo":
        slabs, bounds = halo_slabs(frames, R, L)
        out = _tilted_fused_bands(
            slabs,
            packed,
            tile_cols=tile_cols,
            add_anchor=add_anchor,
            anchor_repeats=anchor_repeats,
            row_policy="zero",
            row_bounds=bounds,
            compute_dtype=compute_dtype,
            clock=clock,
            residual=residual,
            residual_offset=L,  # the band's own rows of its slab
        )
        out = out[:, L : L + R]  # crop the recompute margin
    else:
        out = _tilted_fused_bands(
            frames.reshape(N * (H // R), R, W, C0),
            packed,
            tile_cols=tile_cols,
            add_anchor=add_anchor,
            anchor_repeats=anchor_repeats,
            row_policy=vertical_policy,
            compute_dtype=compute_dtype,
            clock=clock,
            residual=residual,
        )
    return out.reshape(N, H, W, out.shape[-1])


def tilted_fused_band_stack(
    bands: torch.Tensor,
    layers: Optional[Sequence[ConvLayer]] = None,
    *,
    tile_cols: int = 8,
    vertical_policy: str = "zero",
    row_bounds: Optional[torch.Tensor] = None,
    chp: Optional[int] = None,
    compute_dtype=None,
    packed: Optional[PackedLayers] = None,
) -> torch.Tensor:
    """Tilted fusion over an explicit band stack (k, rows, W, C0) -> (k, R, W, ChL).

    The partial-band entry point: the caller has marshalled per-band input
    slabs (any subset of one or more frames' bands) and, under ``halo``,
    the matching valid-row bounds in the ``core.fusion.halo_slabs``
    geometry (``rows = R + 2L``; the margin is cropped from the output).
    Each output band is byte-identical to the same band of a full-frame
    launch: the kernel computes every band independently.
    """
    if bands.ndim != 4:
        raise ValueError(f"bands must be (k, rows, W, C0), got {tuple(bands.shape)}")
    if vertical_policy not in VERTICAL_POLICIES:
        raise ValueError(
            f"vertical_policy {vertical_policy!r} not in {VERTICAL_POLICIES}"
        )
    if packed is None:
        if layers is None:
            raise ValueError("pass either layers or packed")
        packed = pack_stack(layers, chp, dtype=compute_dtype)
    if vertical_policy == "halo":
        L = packed.num_layers
        R = bands.shape[1] - 2 * L
        if R <= 0:
            raise ValueError(
                f"halo slabs need rows > 2L; got rows={bands.shape[1]}, L={L}"
            )
        if row_bounds is None:
            raise ValueError("halo band stacks require row_bounds")
        out = _tilted_fused_bands(
            bands,
            packed,
            tile_cols=tile_cols,
            add_anchor=False,
            anchor_repeats=9,
            row_policy="zero",
            row_bounds=row_bounds,
            compute_dtype=compute_dtype,
        )
        return out[:, L : L + R]  # crop the recompute margin
    return _tilted_fused_bands(
        bands,
        packed,
        tile_cols=tile_cols,
        add_anchor=False,
        anchor_repeats=9,
        row_policy=vertical_policy,
        compute_dtype=compute_dtype,
    )


def conv3x3(
    x: torch.Tensor,
    w: torch.Tensor,
    b: torch.Tensor,
    *,
    tile_cols: int = 8,
    relu: bool = True,
) -> torch.Tensor:
    """Single-layer vectorwise 3x3 conv (the layerwise-baseline datapath):
    ``(R, W, Ci)`` NHWC band, HWIO ``(3, 3, Ci, Co)`` weights -> ``(R, W, Co)``
    through K2."""
    return _conv3x3.conv3x3_call(x, w, b, tile_cols=tile_cols, relu=relu)
