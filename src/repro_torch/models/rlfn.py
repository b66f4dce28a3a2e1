"""RLFN — Residual Local Feature Network (Kong et al., "Residual Local
Feature Network for Efficient Super-Resolution", CVPRW 2022,
arXiv:2205.07514; github.com/bytedance/RLFN, ``src/model/rlfn.py`` and
``src/model/block.py``), as the port serves it.

The published model, ``RLFN(feature_channels=52, upscale=4)``::

    f0 = conv_1(x)                               3x3, 3 -> 52, no activation
    b_k = RLFB(b_{k-1}), b_0 = f0, k = 1..6
    y = conv_2(b_6) + f0                         3x3, 52 -> 52
    HR = pixel_shuffle(upsampler(y), 4)          3x3, 52 -> 48

    RLFB(b):  h = lrelu(c3(lrelu(c2(lrelu(c1(b))))))   3x3 52 -> 52, slope 0.05
              u = c5(h + b)                             1x1 52 -> 52
              out = u * ESA(u)
    ESA(u):   c1_ = conv1(u)                            1x1 52 -> 16
              c1 = conv2(c1_)                           3x3 stride 2, padding 0
              c3 = conv3(max_pool(c1, 7, stride 3))     3x3, padding 1
              c3 = bilinear(c3 -> H x W, align_corners=False)
              m = sigmoid(conv4(c3 + conv_f(c1_)))      1x1 16 -> 16; 1x1 16 -> 52

Every conv has a bias: 543,740 parameters.  The port serves it as stages
(``core.stages``): the K1 segments ``[conv_1]``, ``[c1, c2, c3] +
residual(block input)`` six times, each followed by the block's ``c5`` and
ESA on whole frames (:class:`ESAStage`: hand-written kernels on the card,
``kernels.esa``), ``[conv_2] +
residual(f0)`` and ``[upsampler]``, then the epilogue's shuffle and clip
without an anchor.  Weights live in the published module's state-dict form
(names and ``(Co, Ci, kh, kw)`` shapes, :func:`param_shapes`), so a trained
checkpoint loads as it is (:func:`rlfn_model`).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple, Union

import torch

from repro_torch.core.fusion import ConvLayer
from repro_torch.core.stages import Segment, StagedModel
from repro_torch.kernels.esa import esa_call

__all__ = ["RLFNConfig", "ESAStage", "param_shapes", "param_count", "init_rlfn", "rlfn_model"]


@dataclasses.dataclass(frozen=True)
class RLFNConfig:
    in_channels: int = 3
    feature_channels: int = 52
    num_blocks: int = 6
    esa_channels: int = 16
    slope: float = 0.05  # the RLFB's LeakyReLU
    scale: int = 4
    clip: bool = True  # clip HR to [0, 1] (8-bit image range); the published model does not

    @property
    def out_channels(self) -> int:
        return self.in_channels * self.scale * self.scale


def param_shapes(cfg: RLFNConfig = RLFNConfig()) -> Dict[str, Tuple[int, ...]]:
    """The published module's state dict: name -> shape, in its order."""
    c, f, e = cfg.in_channels, cfg.feature_channels, cfg.esa_channels

    def conv(name, ci, co, k):
        return {f"{name}.weight": (co, ci, k, k), f"{name}.bias": (co,)}

    out = conv("conv_1", c, f, 3)
    for k in range(1, cfg.num_blocks + 1):
        b = f"block_{k}"
        for name, ci, co, ks in (("c1_r", f, f, 3), ("c2_r", f, f, 3), ("c3_r", f, f, 3),
                                 ("c5", f, f, 1), ("esa.conv1", f, e, 1),
                                 ("esa.conv_f", e, e, 1), ("esa.conv2", e, e, 3),
                                 ("esa.conv3", e, e, 3), ("esa.conv4", e, f, 1)):
            out.update(conv(f"{b}.{name}", ci, co, ks))
    out.update(conv("conv_2", f, f, 3))
    out.update(conv("upsampler.0", f, cfg.out_channels, 3))
    return out


def param_count(cfg: RLFNConfig = RLFNConfig()) -> int:
    return sum(math.prod(shape) for shape in param_shapes(cfg).values())


def init_rlfn(generator: Union[torch.Generator, int, None] = None,
              cfg: RLFNConfig = RLFNConfig(), dtype=torch.float32,
              device="cpu") -> Dict[str, torch.Tensor]:
    """A He-initialised state dict (:func:`param_shapes`): std ``sqrt(2 /
    ((1 + a^2) fan_in))`` with ``a`` the slope before a leaky layer, and
    ``sqrt(1 / fan_in)`` for the others; biases zero.  Drawn on the CPU
    from ``generator`` (or an int seed for one), so a seed gives the same
    weights on every device."""
    if not isinstance(generator, torch.Generator):
        generator = torch.Generator().manual_seed(0 if generator is None else int(generator))
    leaky = (".c1_r.", ".c2_r.", ".c3_r.")
    out = {}
    for name, shape in param_shapes(cfg).items():
        if name.endswith(".bias"):
            out[name] = torch.zeros(shape, dtype=dtype, device=device)
            continue
        fan_in = shape[1] * shape[2] * shape[3]
        gain = 2.0 / (1.0 + cfg.slope ** 2) if any(k in name for k in leaky) else 1.0
        w = torch.randn(shape, generator=generator) * (gain / fan_in) ** 0.5
        out[name] = w.to(device=device, dtype=dtype)
    return out


@dataclasses.dataclass(frozen=True)
class ESAStage:
    """An RLFB's tail on whole NHWC frames: ``u = c5(h)``, then ``u *
    ESA(u)``, in the frames' dtype (``kernels.esa.esa_call``: hand-written
    kernels on the card, the plain PyTorch chain on the CPU and ``meta``).
    Weights are ``(w, b)`` pairs in ``(Co, Ci, kh, kw)`` layout."""

    c5: Tuple[torch.Tensor, torch.Tensor]
    conv1: Tuple[torch.Tensor, torch.Tensor]
    conv_f: Tuple[torch.Tensor, torch.Tensor]
    conv2: Tuple[torch.Tensor, torch.Tensor]
    conv3: Tuple[torch.Tensor, torch.Tensor]
    conv4: Tuple[torch.Tensor, torch.Tensor]
    name = "esa"

    def to(self, device=None, dtype=None) -> "ESAStage":
        return ESAStage(*(tuple(t.to(device=device, dtype=dtype) for t in getattr(self, f.name))
                          for f in dataclasses.fields(self)))

    def tensors(self):
        for f in dataclasses.fields(self):
            yield from getattr(self, f.name)

    def __call__(self, x: torch.Tensor, clock=None) -> torch.Tensor:
        """``clock``: the dispatch's stage clock, which counts the kernels'
        launches."""
        return esa_call(x.contiguous(), self.c5, self.conv1, self.conv_f, self.conv2,
                        self.conv3, self.conv4, clock=clock)


def _conv3x3(sd, name, relu=False, slope=0.0) -> ConvLayer:
    """The port's HWIO layer from a state dict's ``(Co, Ci, 3, 3)`` conv."""
    return ConvLayer(w=sd[f"{name}.weight"].permute(2, 3, 1, 0).contiguous(),
                     b=sd[f"{name}.bias"], relu=relu, slope=slope)


def rlfn_model(state_dict: Dict[str, torch.Tensor],
               cfg: RLFNConfig = RLFNConfig()) -> StagedModel:
    """The stage list the port serves, from a state dict in the published
    form: value 0 is the frames, 1 is ``f0``, 2k + 1 block k's output."""
    sd = state_dict
    shapes = param_shapes(cfg)
    missing = sorted(set(shapes) - set(sd))
    if missing:
        raise ValueError(f"state dict lacks {missing[:4]}{'...' if len(missing) > 4 else ''}")
    bad = [n for n, s in shapes.items() if tuple(sd[n].shape) != s]
    if bad:
        raise ValueError(f"state dict shapes differ from RLFN's at {bad[:4]}")
    stages = [Segment((_conv3x3(sd, "conv_1"),))]
    for k in range(1, cfg.num_blocks + 1):
        b = f"block_{k}"
        stages.append(Segment(tuple(_conv3x3(sd, f"{b}.{n}", relu=True, slope=cfg.slope)
                                    for n in ("c1_r", "c2_r", "c3_r")),
                              residual=2 * k - 1))
        stages.append(ESAStage(*((sd[f"{b}.{n}.weight"], sd[f"{b}.{n}.bias"])
                                 for n in ("c5", "esa.conv1", "esa.conv_f", "esa.conv2",
                                           "esa.conv3", "esa.conv4"))))
    stages.append(Segment((_conv3x3(sd, "conv_2"),), residual=1))
    stages.append(Segment((_conv3x3(sd, "upsampler.0"),)))
    return StagedModel(tuple(stages), anchor=False)
