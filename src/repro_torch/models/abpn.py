"""ABPN — Anchor-based Plain Net (Du et al., CVPR-W 2021), the paper's model.

Seven layers (paper §III-A): six 3x3 convs with ReLU (3->28, then 28->28 x5)
and a final 3x3 conv to ``3 * scale**2`` channels followed by the *anchor*:
the input image replicated ``scale**2`` times per channel is added to the
final conv output, and a pixel shuffle (depth-to-space) produces the HR
image.

Execution goes through ``repro_torch.engine`` (``SRPlan`` + ``run``);
``apply_abpn`` is a single-frame shim over that API.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.core.fusion import ConvLayer

__all__ = [
    "ABPNConfig",
    "init_abpn",
    "depth_to_space",
    "make_anchor",
    "apply_abpn",
    "param_count",
    "layers_from_numpy",
]


@dataclasses.dataclass(frozen=True)
class ABPNConfig:
    in_channels: int = 3
    feature_channels: int = 28  # paper: all intermediate layers have 28
    num_layers: int = 7
    scale: int = 3  # x3 SR: 640x360 -> 1920x1080
    clip: bool = True  # clip output to [0, 1] (8-bit image range)

    @property
    def out_channels(self) -> int:
        return self.in_channels * self.scale * self.scale

    @property
    def channels(self) -> List[int]:
        """F_0..F_L channel counts."""
        return (
            [self.in_channels]
            + [self.feature_channels] * (self.num_layers - 1)
            + [self.out_channels]
        )


def init_abpn(
    generator: Union[torch.Generator, int, None] = None,
    cfg: ABPNConfig = ABPNConfig(),
    dtype=torch.float32,
    device="cpu",
) -> List[ConvLayer]:
    """He-initialised ABPN conv stack.

    The numbers are drawn on the CPU from ``generator`` (a
    ``torch.Generator``, or an int seed for one), so a seed gives the same
    weights on every device; they differ from the JAX package's
    ``jax.random`` draws — carry weights across with :func:`layers_from_numpy`.
    """
    if not isinstance(generator, torch.Generator):
        generator = torch.Generator().manual_seed(0 if generator is None else int(generator))
    ch = cfg.channels
    layers = []
    for i in range(cfg.num_layers):
        ci, co = ch[i], ch[i + 1]
        w = torch.randn((3, 3, ci, co), generator=generator) * (2.0 / (9 * ci)) ** 0.5
        layers.append(ConvLayer(
            w=w.to(device=device, dtype=dtype),
            b=torch.zeros((co,), dtype=dtype, device=device),
            relu=(i < cfg.num_layers - 1),
        ))
    return layers


def layers_from_numpy(layers, device="cpu", dtype=torch.float32) -> List[ConvLayer]:
    """The port's :class:`ConvLayer` stack from array-valued layers.

    ``layers`` is a sequence of objects with ``.w`` (3, 3, Ci, Co), ``.b``
    (Co,) and ``.relu``, or of ``(w, b, relu)`` tuples; the arrays are
    anything ``np.asarray`` reads.  This is how a trained stack — or another
    framework's weights — crosses into the port without the port importing
    that framework.
    """
    out = []
    for layer in layers:
        if isinstance(layer, tuple):
            w, b, relu = layer
        else:
            w, b, relu = layer.w, layer.b, layer.relu
        out.append(ConvLayer(
            w=torch.from_numpy(np.array(w, dtype=np.float32)).to(device=device, dtype=dtype),
            b=torch.from_numpy(np.array(b, dtype=np.float32)).to(device=device, dtype=dtype),
            relu=bool(relu),
        ))
    return out


def depth_to_space(x: torch.Tensor, block: int) -> torch.Tensor:
    """(..., H, W, C*block^2) -> (..., H*block, W*block, C), channel-major.

    Convention: ``out[y*b+dy, x*b+dx, c] = in[y, x, c*b*b + dy*b + dx]`` —
    chosen so that replicating each input channel ``b*b`` times yields an
    exact nearest-neighbour upsample (the ABPN anchor).
    """
    *lead, H, W, CB = x.shape
    b = block
    C = CB // (b * b)
    if C * b * b != CB:
        raise ValueError(f"channels {CB} not divisible by block^2 {b * b}")
    n = len(lead)
    x = x.reshape(*lead, H, W, C, b, b)
    x = x.permute(*range(n), n, n + 3, n + 1, n + 4, n + 2)  # H, dy, W, dx, C
    return x.reshape(*lead, H * b, W * b, C)


def make_anchor(lr: torch.Tensor, scale: int) -> torch.Tensor:
    """The ABPN anchor: each input channel repeated scale^2 times.

    ``depth_to_space(make_anchor(lr, s), s)`` == nearest-neighbour upsample.
    """
    return torch.repeat_interleave(lr, scale * scale, dim=-1)


def apply_abpn(
    layers: Sequence[ConvLayer],
    lr: torch.Tensor,
    cfg: ABPNConfig = ABPNConfig(),
    method: str = "reference",
    band_rows: int = 60,
    tile_cols: int = 8,
    vertical_policy: str = "zero",
    device: Optional[str] = None,
) -> torch.Tensor:
    """LR (H, W, in_ch) -> HR (H*scale, W*scale, in_ch) through one plan.

    A thin shim over :mod:`repro_torch.engine` that rebuilds an ``SRPlan``
    per call; build a plan once and use ``engine.run`` for frame batches.
    """
    from repro_torch import engine  # local import: models must not cycle engine

    if method not in ("reference", "tilted", "kernel"):
        raise ValueError(f"unknown method {method!r}")
    plan = engine.make_plan(
        layers,
        tuple(lr.shape),
        band_rows=band_rows,
        tile_cols=tile_cols,
        vertical_policy=vertical_policy,
        backend=method,
        scale=cfg.scale,
        clip=cfg.clip,
    )
    return engine.run(plan, layers, lr[None], device=device)[0]


def param_count(layers: Sequence[ConvLayer]) -> int:
    return sum(int(l.w.numel() + l.b.numel()) for l in layers)
