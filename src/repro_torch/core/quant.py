"""Symmetric int8 quantisation (ABPN ships 8-bit weights; paper §I).

* :func:`quantize` / :func:`dequantize` — symmetric int8 with per-tensor or
  per-channel scales.
* :func:`fake_quant` — straight-through-estimator fake quantisation for
  quantisation-aware training.
* :func:`quantize_layers` — converts a float ``ConvLayer`` stack into an
  int8-weight stack with dequant-on-read semantics.

``torch.round`` rounds half to even, as ``jnp.round`` does, so the int8
codes equal the JAX package's exactly.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch

from repro_torch.core.fusion import ConvLayer

__all__ = [
    "quantize",
    "dequantize",
    "fake_quant",
    "QuantizedConvLayer",
    "quantize_layers",
    "dequantize_layers",
]

_EPS = 1e-12


def _scale_for(x: torch.Tensor, axis: Optional[Tuple[int, ...]]) -> torch.Tensor:
    if axis is None:
        amax = x.abs().max()
    else:
        amax = x.abs().amax(dim=axis, keepdim=True)
    return torch.clamp_min(amax, _EPS) / 127.0


def quantize(
    x: torch.Tensor, axis: Optional[Tuple[int, ...]] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 quantisation.

    ``axis`` lists the axes to REDUCE when computing the scale: ``None`` is
    per-tensor; ``(0, 1, 2)`` on HWIO conv weights is per-output-channel.
    Returns ``(q, scale)`` with ``q`` int8 and ``x ≈ q * scale``.
    """
    scale = _scale_for(x, axis)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize(q: torch.Tensor, scale: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    return q.to(dtype) * scale.to(dtype)


def fake_quant(x: torch.Tensor, axis: Optional[Tuple[int, ...]] = None) -> torch.Tensor:
    """Quantise-dequantise with a straight-through gradient (QAT)."""
    scale = _scale_for(x, axis)
    q = torch.clamp(torch.round(x / scale), -127, 127) * scale
    return x + (q - x).detach()


@dataclasses.dataclass
class QuantizedConvLayer:
    """int8 storage form of a :class:`ConvLayer` (per-out-channel scales)."""

    wq: torch.Tensor  # (3, 3, Ci, Co) int8
    w_scale: torch.Tensor  # (1, 1, 1, Co)
    bq: torch.Tensor  # (Co,) int32 (bias kept wide, as accumulators are)
    b_scale: torch.Tensor  # ()
    relu: bool = True


def quantize_layers(layers: Sequence[ConvLayer]) -> List[QuantizedConvLayer]:
    out = []
    for l in layers:
        wq, ws = quantize(l.w, axis=(0, 1, 2))
        bs = torch.clamp_min(l.b.abs().max(), _EPS) / (2**23)  # wide bias
        bq = torch.round(l.b / bs).to(torch.int32)
        out.append(QuantizedConvLayer(wq=wq, w_scale=ws, bq=bq, b_scale=bs, relu=l.relu))
    return out


def dequantize_layers(
    qlayers: Sequence[QuantizedConvLayer], dtype=torch.float32
) -> List[ConvLayer]:
    return [
        ConvLayer(
            w=dequantize(q.wq, q.w_scale, dtype),
            b=dequantize(q.bq, q.b_scale, dtype),
            relu=q.relu,
        )
        for q in qlayers
    ]
