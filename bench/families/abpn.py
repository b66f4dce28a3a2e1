"""ABPN (Du et al., "Anchor-based Plain Net for Mobile Image
Super-Resolution", CVPRW 2021) as the benchmark serves it: a chain of SAME
3x3 convolutions, the anchor added to the last, a pixel shuffle.

Weights are ``[(w (3, 3, Ci, Co), b (Co,), relu)]`` in float32, drawn on the
device with a ``torch.Generator`` there, in two calls (one for every weight,
one for every bias): He-initialised (``std = sqrt(2 / (9 * Ci))``), the
last layer's std scaled by the configuration's ``last_layer_std_scale`` so
that the residual over the anchor is small, as in a trained ABPN, and most
HR pixels are not clipped; biases uniform in ``[-bias_range, bias_range]``,
not zero, so that the bias path is checked.  The plain reference is
``reference/abpn.py``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from harness import inputs
from reference import abpn as ref

exact = ref.exact


def channels(cfg: dict) -> List[int]:
    """F_0..F_L channel counts of the configuration's ABPN stack."""
    c0, feat = int(cfg["in_channels"]), int(cfg["feature_channels"])
    return [c0] + [feat] * (int(cfg["num_layers"]) - 1) + [int(cfg["out_channels"])]


def make_weights(cfg: dict, seed: int, device) -> List[Tuple[torch.Tensor, torch.Tensor, bool]]:
    """``[(w (3, 3, Ci, Co), b (Co,), relu)]`` in float32 on ``device``."""
    init = cfg["init"]
    ch = channels(cfg)
    L = len(ch) - 1
    device = torch.device(device)
    g = torch.Generator(device=device).manual_seed(int(seed))
    sizes = [9 * ch[i] * ch[i + 1] for i in range(L)]
    flat_w = torch.randn(sum(sizes), generator=g, device=device, dtype=torch.float32)
    flat_b = torch.rand(sum(ch[1:]), generator=g, device=device, dtype=torch.float32)
    flat_b = (2 * flat_b - 1) * float(init["bias_range"])
    layers = []
    for i, (w, b) in enumerate(zip(flat_w.split(sizes), flat_b.split(ch[1:]))):
        std = (2.0 / (9 * ch[i])) ** 0.5
        if i == L - 1:
            std *= float(init["last_layer_std_scale"])
        layers.append(((w * std).reshape(3, 3, ch[i], ch[i + 1]).contiguous(), b.contiguous(),
                       i < L - 1))
    return layers


def open_server(cfg: dict, weights, device, backend: Optional[str] = None):
    """The port's server on the benchmark's weights, as the configuration
    serves it."""
    from repro_torch.core.fusion import ConvLayer
    from repro_torch.engine import SRServer

    serving = dict(cfg["serving"])
    if backend is not None:
        serving["backend"] = backend
    stack = [ConvLayer(w=w, b=b, relu=r) for w, b, r in weights]
    return SRServer.open(cfg["model"], layers=stack, scale=int(cfg["scale"]),
                         device=str(device), **serving)


def reference(lr: torch.Tensor, weights, cfg: dict, precision: str = "fp32") -> torch.Tensor:
    """HR frames of the LR frames ``lr`` under the configuration's band
    policy, in ``precision`` (``reference.abpn.PRECISIONS``)."""
    return ref.abpn(lr, weights, int(cfg["scale"]), int(cfg["serving"]["band_rows"]), precision)


def flops_per_frame(cfg: dict) -> int:
    """ABPN's own work on one frame: 2 FLOP per multiply-add of its 3x3
    convolutions over every LR pixel (the anchor's adds left out)."""
    h, w, _ = inputs.lr_shape(cfg)
    ch = channels(cfg)
    return 2 * h * w * 9 * sum(a * b for a, b in zip(ch, ch[1:]))


def executed_flops(session, cfg: dict, buckets, device) -> Dict[int, int]:
    """K1's executed FLOPs for one dispatch of each bucket, as the program
    counts them (``engine.executor.plan_cost_terms``, i.e.
    ``tilted_fusion.launch_cost`` at the card's segment plan)."""
    from repro_torch.engine.executor import plan_cost_terms

    plan = session.plan_for(inputs.lr_shape(cfg))
    out = {}
    for b in sorted(buckets):
        terms = plan_cost_terms(plan, session.layers, b, torch.float32, device=device)
        out[b] = sum(int(k["flops"]) for k in terms["k1"])
    return out
