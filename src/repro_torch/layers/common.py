"""Shared NN primitives (norms, embeddings, losses) — functional style, the
port of ``repro.layers.common``."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

__all__ = ["rmsnorm", "layernorm", "embed_lookup", "cross_entropy", "silu", "act_fn"]


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm with fp32 statistics (matches HF Qwen/DeepSeek numerics)."""
    dt = x.dtype
    xf = x.float()
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    normed = xf * torch.rsqrt(var + eps)
    return (normed * scale.float()).to(dt)


def layernorm(
    x: torch.Tensor, scale: torch.Tensor, bias: Optional[torch.Tensor], eps: float = 1e-6
) -> torch.Tensor:
    dt = x.dtype
    xf = x.float()
    mean = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    y = (xf - mean) * torch.rsqrt(var + eps) * scale.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(dt)


def embed_lookup(embedding: torch.Tensor, ids: torch.Tensor, dtype=None) -> torch.Tensor:
    out = embedding[ids]
    return out.to(dtype) if dtype is not None else out


def silu(x):
    return x * torch.sigmoid(x)


def _gelu(x):
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh")


def act_fn(name: str):
    return {"silu": silu, "gelu": _gelu, "relu": F.relu}[name]


def cross_entropy(
    logits: torch.Tensor,  # (B, S, V)
    targets: torch.Tensor,  # (B, S) integer
    mask: Optional[torch.Tensor] = None,  # (B, S) {0,1}
):
    """Masked mean token cross-entropy with fp32 log-softmax.

    Returns (loss, metrics) where metrics carries token counts and z-stats.
    """
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets[..., None].long())[..., 0]
    nll = logz - gold
    if mask is None:
        mask = torch.ones_like(nll)
    mask = mask.float()
    total = torch.clamp_min(mask.sum(), 1.0)
    loss = (nll * mask).sum() / total
    metrics = {
        "loss": loss,
        "tokens": total,
        "z_mean": (logz * mask).sum() / total,
    }
    return loss, metrics
