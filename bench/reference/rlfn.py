"""Plain PyTorch reference of RLFN as the benchmark's cells serve it.

RLFN (Kong et al., "Residual Local Feature Network for Efficient
Super-Resolution", CVPRW 2022, arXiv:2205.07514), written from
github.com/bytedance/RLFN ``src/model/rlfn.py`` (``RLFN``) and
``src/model/block.py`` (``RLFB``, ``ESA``, ``conv_layer``,
``pixelshuffle_block``) over whole NCHW frames, the weights a state dict
in that module's names and ``(Co, Ci, kh, kw)`` shapes.  Departures from
``block.py``: none in the model.  The served HR frame is clipped to
``[0, 1]`` (the published model returns it unclipped; the benchmark's
frames are 8-bit images).  Frames in and out are NHWC, as the benchmark
hands them to the server.

``precision`` is ``"fp32"`` (the reference: TF32 off, which :func:`exact`
ensures) or one of the lower precisions the correctness control computes
in (``reference.abpn``'s): ``"tf32"`` rounds every convolution's operands
to TF32; ``"fp8"`` rounds them per tensor to float8 e4m3 and also rounds
every intermediate result (each convolution's output, the activations, the
residual sums, the pooled, resized, gated maps) so, as a bf16 program
rounds them to bf16.

Nothing here imports the program under test.
"""

from __future__ import annotations

import contextlib
from typing import Dict

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


def rlfn(frames: torch.Tensor, sd: Dict[str, torch.Tensor], scale: int, num_blocks: int = 6,
         slope: float = 0.05, clip: bool = True, precision: str = "fp32") -> torch.Tensor:
    """HR frames ``(N, H*s, W*s, C)`` float32 for LR ``frames (N, H, W, C)``."""
    op, out = _rounders(precision)

    def conv(t, name, **kw):
        return out(F.conv2d(op(t), op(sd[f"{name}.weight"].float()), sd[f"{name}.bias"].float(),
                            **kw))

    def lrelu(t):
        return out(F.leaky_relu(t, slope))

    def esa(x, p):
        c1_ = conv(x, f"{p}.conv1")
        c1 = conv(c1_, f"{p}.conv2", stride=2, padding=0)
        v_max = out(F.max_pool2d(c1, kernel_size=7, stride=3))
        c3 = conv(v_max, f"{p}.conv3", padding=1)
        c3 = out(F.interpolate(c3, (x.size(2), x.size(3)), mode="bilinear",
                               align_corners=False))
        cf = conv(c1_, f"{p}.conv_f")
        c4 = conv(out(c3 + cf), f"{p}.conv4")
        m = out(torch.sigmoid(c4))
        return out(x * m)

    def rlfb(x, p):
        h = lrelu(conv(x, f"{p}.c1_r", padding=1))
        h = lrelu(conv(h, f"{p}.c2_r", padding=1))
        h = lrelu(conv(h, f"{p}.c3_r", padding=1))
        h = out(h + x)
        return esa(conv(h, f"{p}.c5"), f"{p}.esa")

    x = out(frames.to(torch.float32).permute(0, 3, 1, 2))
    f0 = conv(x, "conv_1", padding=1)
    b = f0
    for k in range(1, num_blocks + 1):
        b = rlfb(b, f"block_{k}")
    y = out(conv(b, "conv_2", padding=1) + f0)
    hr = F.pixel_shuffle(conv(y, "upsampler.0", padding=1), scale)
    if clip:
        hr = hr.clamp(0.0, 1.0)
    return hr.permute(0, 2, 3, 1).contiguous()


def param_shapes(in_channels: int = 3, feature_channels: int = 52, num_blocks: int = 6,
                 esa_channels: int = 16, scale: int = 4) -> Dict[str, tuple]:
    """The published module's state dict (``RLFN(in_channels, out_channels,
    feature_channels, upscale)``): name -> shape, in its order."""
    c, f, e = in_channels, feature_channels, esa_channels
    out = {}

    def conv(name, ci, co, k):
        out[f"{name}.weight"] = (co, ci, k, k)
        out[f"{name}.bias"] = (co,)

    conv("conv_1", c, f, 3)
    for k in range(1, num_blocks + 1):
        p = f"block_{k}"
        conv(f"{p}.c1_r", f, f, 3)
        conv(f"{p}.c2_r", f, f, 3)
        conv(f"{p}.c3_r", f, f, 3)
        conv(f"{p}.c5", f, f, 1)
        conv(f"{p}.esa.conv1", f, e, 1)
        conv(f"{p}.esa.conv_f", e, e, 1)
        conv(f"{p}.esa.conv2", e, e, 3)
        conv(f"{p}.esa.conv3", e, e, 3)
        conv(f"{p}.esa.conv4", e, f, 1)
    conv("conv_2", f, f, 3)
    conv("upsampler.0", f, c * scale * scale, 3)
    return out
