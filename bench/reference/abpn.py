"""Plain PyTorch reference of ABPN as the benchmark's cells serve it.

ABPN (Du et al., "Anchor-based Plain Net for Mobile Image Super-Resolution",
CVPRW 2021): SAME 3x3 convolutions with bias, ReLU on all but the last;
the last layer's ``C * s**2`` outputs plus the anchor (each input channel
repeated ``s**2`` times) are pixel-shuffled to the HR frame and clipped to
``[0, 1]``.  Under the ``zero`` band policy each ``band_rows``-row band of
the LR frame is convolved on its own, with zero rows outside it at every
layer (so the HR frame is the bands' results stacked).

Frames are NHWC, weights ``(3, 3, Ci, Co)``.  ``precision`` is ``"fp32"``
(the reference: TF32 must be off, which :func:`exact` ensures) or one of
the lower precisions the correctness control computes in:

* ``"tf32"`` — every convolution's operands (activations and weights)
  rounded to TF32 (10 explicit mantissa bits, round to nearest with ties
  away from zero, as ``cvt.rna.tf32.f32``), products accumulated in fp32:
  a TF32 tensor-core convolution.
* ``"fp8"`` — operands scaled per tensor to the range of float8 e4m3 and
  rounded to it, accumulated in fp32; each layer's output and the anchor sum
  rounded so too (as a bf16 program rounds them to bf16).

Nothing here imports the program under test.
"""

from __future__ import annotations

import contextlib
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

PRECISIONS = ("fp32", "tf32", "fp8")
FP8_MAX = 448.0  # largest finite float8 e4m3 (fn) value


@contextlib.contextmanager
def exact():
    """fp32 convolutions and matmuls without TF32, restored on exit."""
    cudnn, matmul = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = cudnn
        torch.backends.cuda.matmul.allow_tf32 = matmul


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to TF32's 10 mantissa bits, ties away from zero."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` scaled so that its largest magnitude is e4m3's largest value,
    rounded to float8 e4m3, and scaled back."""
    amax = x.abs().amax()
    if amax == 0:
        return x
    scale = FP8_MAX / amax
    return (x * scale).to(torch.float8_e4m3fn).to(torch.float32) / scale


def _rounders(precision: str):
    """(operand rounding, output rounding) for ``precision``."""
    ident = lambda t: t  # noqa: E731
    if precision == "fp32":
        return ident, ident
    if precision == "tf32":
        return tf32_round, ident
    if precision == "fp8":
        return fp8_round, fp8_round
    raise ValueError(f"precision {precision!r} not in {PRECISIONS}")


def depth_to_space(x: torch.Tensor, s: int) -> torch.Tensor:
    """(N, H, W, C*s*s) -> (N, H*s, W*s, C), channel-major:
    ``out[y*s + dy, x*s + dx, c] = in[y, x, c*s*s + dy*s + dx]``."""
    n, h, w, cs = x.shape
    c = cs // (s * s)
    x = x.reshape(n, h, w, c, s, s).permute(0, 1, 4, 2, 5, 3)
    return x.reshape(n, h * s, w * s, c)


def abpn(frames: torch.Tensor, layers: Sequence[Tuple[torch.Tensor, torch.Tensor, bool]],
         scale: int, band_rows: int, precision: str = "fp32") -> torch.Tensor:
    """HR frames ``(N, H*s, W*s, C)`` float32 for LR ``frames (N, H, W, C)``
    under the ``zero`` band policy at ``band_rows``."""
    op, out = _rounders(precision)
    frames = frames.to(torch.float32)
    n, h, w, c = frames.shape
    if h % band_rows:
        raise ValueError(f"LR height {h} is not a multiple of band_rows {band_rows}")
    x = frames.reshape(n * (h // band_rows), band_rows, w, c).permute(0, 3, 1, 2)
    for wt, b, relu in layers:
        x = F.conv2d(op(x), op(wt.to(torch.float32)).permute(3, 2, 0, 1), b.to(torch.float32),
                     padding=1)
        if relu:
            x = F.relu(x)
        x = out(x)
    feats = x.permute(0, 2, 3, 1).reshape(n, h, w, -1)
    hr = out(feats + out(frames.repeat_interleave(scale * scale, dim=-1)))
    return depth_to_space(hr, scale).clamp(0.0, 1.0)
