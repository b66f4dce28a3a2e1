"""Dense MLP blocks: gated SwiGLU (llama/qwen style) or plain 2-layer, the
port of ``repro.layers.mlp``.

The weights are cast to the activation dtype at each use, as the
reference does, so bf16 rounds at the same points.  The activations carry
the reference's logical-axis tags (``distributed.partitioning.pshard``, an
identity on the tensor).
"""

from __future__ import annotations

import torch

from repro_torch.distributed.partitioning import pshard
from repro_torch.layers.common import act_fn
from repro_torch.layers.params import ParamSpec

__all__ = ["mlp_schema", "mlp_block"]


def mlp_schema(cfg, d_ff=None, gated=None) -> dict:
    d = cfg.d_model
    f = d_ff or cfg.d_ff
    gated = cfg.mlp_act == "silu" if gated is None else gated
    s = {
        "wi": ParamSpec((d, f), ("embed", "mlp")),
        "wo": ParamSpec((f, d), ("mlp", "embed")),
    }
    if gated:
        s["wg"] = ParamSpec((d, f), ("embed", "mlp"))
    return s


def mlp_block(p: dict, cfg, x: torch.Tensor) -> torch.Tensor:
    act = act_fn(cfg.mlp_act)
    h = torch.einsum("bsd,df->bsf", x, p["wi"].to(x.dtype))
    if "wg" in p:
        g = torch.einsum("bsd,df->bsf", x, p["wg"].to(x.dtype))
        h = act(g) * h
    else:
        h = act(h)
    h = pshard(h, "batch", "seq", "mlp")
    y = torch.einsum("bsf,fd->bsd", h, p["wo"].to(x.dtype))
    return pshard(y, "batch", "act_seq", "embed")
