"""Rotary position embeddings (GPT-NeoX half-split convention), the port of
``repro.layers.rope``."""

from __future__ import annotations

import torch

__all__ = ["apply_rope"]


def _angles(positions: torch.Tensor, dim: int, theta: float) -> torch.Tensor:
    """positions (B, S) -> (B, S, dim/2) fp32 angles."""
    inv_freq = 1.0 / (
        theta ** (torch.arange(0, dim, 2, dtype=torch.float32, device=positions.device) / dim)
    )  # (dim/2,)
    return positions.float()[..., None] * inv_freq


def apply_rope(
    x: torch.Tensor,  # (B, S, H, D) or (B, S, D)
    positions: torch.Tensor,  # (B, S)
    theta: float = 1e6,
) -> torch.Tensor:
    """Rotate the last dim; fp32 trig, output in x.dtype."""
    squeeze = x.dim() == 3
    if squeeze:
        x = x[:, :, None, :]
    d = x.shape[-1]
    ang = _angles(positions, d, theta)[:, :, None, :]  # (B, S, 1, d/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    out = out.to(x.dtype)
    return out[:, :, 0, :] if squeeze else out
