"""Plain oracles for the kernels (the correctness contracts).

Each ``*_ref`` matches the signature of its ``ops`` counterpart and is built
from nothing but the full-band layer-by-layer conv (``F.conv2d`` with TF32
off; no tiling, no carried state), so a disagreement points at the kernel's
dataflow, not at the math.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.fusion import ConvLayer, conv_stack_reference

__all__ = ["conv3x3_ref", "tilted_fused_stack_ref", "tf32_rna", "tf32_split"]


def conv3x3_ref(
    x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *, relu: bool = True
) -> torch.Tensor:
    """SAME-padded 3x3 conv over a ``(R, W, Ci)`` band with HWIO weights
    ``(3, 3, Ci, Co)``, plus bias, with ReLU when asked -> ``(R, W, Co)``.
    Accumulates in fp32 (fp64 for fp64 input) and rounds once to
    ``x.dtype``."""
    return conv_stack_reference(x, [ConvLayer(w, b, relu)])


def tilted_fused_stack_ref(
    x: torch.Tensor,
    layers: Sequence[ConvLayer],
    *,
    band_rows: int = 60,
    add_anchor: bool = False,
    anchor_repeats: int = 9,
) -> torch.Tensor:
    """Oracle for the fused kernel: per-band SAME conv stack (+ anchor).

    Bands are convolved independently with zero padding at band edges — the
    paper's vertical block-conv policy.
    """
    H, W, C0 = x.shape
    R = band_rows
    bands = x.reshape(H // R, R, W, C0)
    out = conv_stack_reference(bands, layers)
    if add_anchor:
        anchor = torch.repeat_interleave(bands, anchor_repeats, dim=-1)
        out = out + F.pad(anchor, (0, out.shape[-1] - C0 * anchor_repeats))
    return out.reshape(H, W, out.shape[-1])


def tf32_rna(a) -> np.ndarray:
    """float32 -> the TF32 value ``cvt.rna.tf32.f32`` gives: round to
    nearest, ties away from zero, the 13 low mantissa bits cleared (finite
    inputs).  Adding half of the cleared unit to the magnitude bits rounds
    the magnitude half up, whatever the sign.  The CUDA kernels' own
    ``tf32_rna`` (``csrc/conv3x3.cu``, ``csrc/tilted_fusion.cu``), in numpy
    for the tests that emulate their 3xTF32 products."""
    bits = np.ascontiguousarray(a, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def tf32_split(a) -> Tuple[np.ndarray, np.ndarray]:
    """The kernels' 3xTF32 operand split: ``hi = tf32(a)``, ``lo = tf32(a -
    hi)`` (the difference taken in float32)."""
    a = np.asarray(a, np.float32)
    hi = tf32_rna(a)
    return hi, tf32_rna(a - hi)
