"""The benchmark's own inputs, made from ``--seed``: the LR frame pool the
traffic draws from and the ABPN weights handed to both the port and the
reference.

Weights are drawn on the device with a ``torch.Generator`` there, in two
calls (one for every weight, one for every bias): He-initialised
(``std = sqrt(2 / (9 * Ci))``), the last layer's std scaled by the
configuration's ``last_layer_std_scale`` so that the residual over the
anchor is small, as in a trained ABPN, and most HR pixels are not clipped;
biases uniform in ``[-bias_range, bias_range]``, not zero, so that the
bias path is checked.  Frames are float32 in ``[0, 1)``, drawn on the host
with numpy, as a client hands them to the server.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch


def channels(cfg: dict) -> List[int]:
    """F_0..F_L channel counts of the configuration's ABPN stack."""
    c0, feat = int(cfg["in_channels"]), int(cfg["feature_channels"])
    return [c0] + [feat] * (int(cfg["num_layers"]) - 1) + [int(cfg["out_channels"])]


def lr_shape(cfg: dict) -> Tuple[int, int, int]:
    return int(cfg["lr_height"]), int(cfg["lr_width"]), int(cfg["in_channels"])


def make_layers(cfg: dict, seed: int, device) -> List[Tuple[torch.Tensor, torch.Tensor, bool]]:
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


def make_pool(cfg: dict, pool_frames: int, seed: int) -> np.ndarray:
    """``(pool_frames, H, W, C)`` float32 LR frames in ``[0, 1)``."""
    rng = np.random.default_rng([int(seed), 7])
    return rng.random((int(pool_frames), *lr_shape(cfg)), dtype=np.float32)


def abpn_flops_per_frame(cfg: dict) -> int:
    """ABPN's own work on one frame: 2 FLOP per multiply-add of its 3x3
    convolutions over every LR pixel (the anchor's adds left out)."""
    h, w, _ = lr_shape(cfg)
    ch = channels(cfg)
    return 2 * h * w * 9 * sum(a * b for a, b in zip(ch, ch[1:]))
