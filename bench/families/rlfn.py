"""RLFN (Kong et al., "Residual Local Feature Network for Efficient
Super-Resolution", CVPRW 2022, arXiv:2205.07514) as the benchmark serves
it: six residual blocks of three leaky 3x3 convs and an ESA attention
branch, a global skip, a 3x3 to ``3 * scale**2`` outputs and a pixel
shuffle, no anchor.

Weights are a state dict in the published module's names and ``(Co, Ci,
kh, kw)`` shapes (``reference.rlfn.param_shapes``), float32, drawn on the
device with a ``torch.Generator`` there in two calls (one for every weight,
one for every bias): He-initialised for the activation that follows each
convolution, ``std = sqrt(2 / ((1 + a^2) fan_in))`` before a LeakyReLU of
slope ``a = init.slope`` (every block's c1_r, c2_r, c3_r) and ``sqrt(1 /
fan_in)`` before none (the rest; He's gain for a linear layer, which keeps
the residual sums from growing block by block), the upsampler's std scaled by
``init.last_layer_std_scale`` and its biases shifted by
``init.last_layer_bias`` so that the HR frame sits inside ``[0, 1]``
(few values clip, as in a trained model's output); biases uniform in
``[-bias_range, bias_range]``, not zero, so that the bias path is checked.
The plain reference is ``reference/rlfn.py``.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from harness import inputs, peaks
from reference import rlfn as ref

exact = ref.exact


def _shapes(cfg: dict) -> Dict[str, tuple]:
    return ref.param_shapes(int(cfg["in_channels"]), int(cfg["feature_channels"]),
                            int(cfg["num_blocks"]), int(cfg["esa_channels"]), int(cfg["scale"]))


def make_weights(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The state dict in float32 on ``device``."""
    init = cfg["init"]
    shapes = _shapes(cfg)
    device = torch.device(device)
    g = torch.Generator(device=device).manual_seed(int(seed))
    weights = {n: s for n, s in shapes.items() if n.endswith(".weight")}
    biases = {n: s for n, s in shapes.items() if n.endswith(".bias")}
    sizes = [math.prod(s) for s in weights.values()]
    flat_w = torch.randn(sum(sizes), generator=g, device=device, dtype=torch.float32)
    bsizes = [math.prod(s) for s in biases.values()]
    flat_b = torch.rand(sum(bsizes), generator=g, device=device, dtype=torch.float32)
    flat_b = (2 * flat_b - 1) * float(init["bias_range"])
    leaky = 2.0 / (1.0 + float(init["slope"]) ** 2)
    out = {}
    for (name, shape), w in zip(weights.items(), flat_w.split(sizes)):
        gain = leaky if name.endswith(("c1_r.weight", "c2_r.weight", "c3_r.weight")) else 1.0
        std = (gain / (shape[1] * shape[2] * shape[3])) ** 0.5
        if name.startswith("upsampler."):
            std *= float(init["last_layer_std_scale"])
        out[name] = (w * std).reshape(shape).contiguous()
    for (name, shape), b in zip(biases.items(), flat_b.split(bsizes)):
        if name.startswith("upsampler."):
            b = b + float(init["last_layer_bias"])
        out[name] = b.reshape(shape).contiguous()
    return {n: out[n] for n in shapes}


def open_server(cfg: dict, weights, device, backend: Optional[str] = None):
    """The port's server on the benchmark's weights, as the configuration
    serves it."""
    from repro_torch.engine import SRServer
    from repro_torch.models.rlfn import RLFNConfig, rlfn_model

    serving = dict(cfg["serving"])
    if backend is not None:
        serving["backend"] = backend
    rcfg = RLFNConfig(in_channels=int(cfg["in_channels"]),
                      feature_channels=int(cfg["feature_channels"]),
                      num_blocks=int(cfg["num_blocks"]), esa_channels=int(cfg["esa_channels"]),
                      slope=float(cfg["slope"]), scale=int(cfg["scale"]), clip=bool(cfg["clip"]))
    return SRServer.open(cfg["model"], layers=rlfn_model(weights, rcfg), scale=rcfg.scale,
                         clip=rcfg.clip, device=str(device), **serving)


def reference(lr: torch.Tensor, weights, cfg: dict, precision: str = "fp32") -> torch.Tensor:
    """HR frames of the LR frames ``lr`` over whole frames, in
    ``precision`` (``reference.rlfn.PRECISIONS``)."""
    return ref.rlfn(lr, weights, int(cfg["scale"]), int(cfg["num_blocks"]),
                    float(cfg["slope"]), bool(cfg["clip"]), precision)


def _convs(cfg: dict):
    """``(name, kernel, Ci, Co, output pixels)`` of every convolution of
    one frame, each at its own resolution."""
    h, w, _ = inputs.lr_shape(cfg)
    # ESA's strided 3x3 (padding 0), then the 7x7 stride-3 max pool
    h2, w2 = (h - 3) // 2 + 1, (w - 3) // 2 + 1
    h3, w3 = (h2 - 7) // 3 + 1, (w2 - 7) // 3 + 1
    at = {"esa.conv2": h2 * w2, "esa.conv3": h3 * w3}
    for name, shape in _shapes(cfg).items():
        if name.endswith(".weight"):
            stem = name[:-len(".weight")]
            px = next((v for k, v in at.items() if stem.endswith(k)), h * w)
            yield stem, shape[2], shape[1], shape[0], px


def flops_per_frame(cfg: dict) -> int:
    """RLFN's own work on one frame: 2 FLOP per multiply-add of every
    convolution, each at its own resolution (ESA's strided 3x3 at 1/4 of
    the pixels, its pooled 3x3 at about 1/36); the activations, adds,
    pooling, resize and gating left out."""
    return sum(2 * k * k * ci * co * px for _, k, ci, co, px in _convs(cfg))


def _k1_stems(cfg: dict):
    return [s for s, k, _, _, px in _convs(cfg) if k == 3 and ".esa." not in s]


def k1_work(cfg: dict, precision: str) -> Tuple[int, int]:
    """(FLOPs, bytes) of K1's segments on one frame: the full-resolution 3x3
    convs (conv_1, every block's three, conv_2, the upsampler), and each
    segment's input, its residual where that is not its input (conv_2's
    f0), and its output, once each, in the compute dtype: 935 channels a
    pixel at RLFN x4."""
    h, w, c0 = inputs.lr_shape(cfg)
    f, blocks = int(cfg["feature_channels"]), int(cfg["num_blocks"])
    out = c0 * int(cfg["scale"]) ** 2
    flops = sum(2 * k * k * ci * co * px for s, k, ci, co, px in _convs(cfg)
                if s in _k1_stems(cfg))
    channels = (c0 + f) + blocks * 2 * f + 3 * f + (f + out)
    return flops, h * w * channels * peaks.element_bytes(precision)


def esa_work(cfg: dict, precision: str) -> Tuple[int, int]:
    """(FLOPs, bytes) of the whole-frame stages on one frame: every block's
    c5 and ESA convolutions, and each stage's input and output once (104
    channels a pixel a block at RLFN x4) in the compute dtype."""
    h, w, _ = inputs.lr_shape(cfg)
    f, blocks = int(cfg["feature_channels"]), int(cfg["num_blocks"])
    flops = sum(2 * k * k * ci * co * px for s, k, ci, co, px in _convs(cfg)
                if s.startswith("block_") and (".esa." in s or s.endswith(".c5")))
    return flops, h * w * blocks * 2 * f * peaks.element_bytes(precision)
