"""Multi-head Latent Attention (DeepSeek-V2, arXiv:2405.04434) — the port of
``repro.layers.mla``.

Queries and KV are low-rank compressed; only the compressed KV latent
(``kv_lora_rank`` = 512) plus a small decoupled-RoPE key (64 dims, shared
across heads) are cached.  Per-head dims: 128 "nope" + 64 rope for QK,
128 for V.

Two execution forms, numerically identical up to fp32 association:
  * train/prefill — decompress K/V to per-head form and run the shared
    flash attention (``layers.attention.flash_attention``) with
    D_qk = nope + rope = 192, D_v = 128, one query per KV head (G = 1);
  * decode        — *absorbed* form: W_uk is folded into the query and W_uv
    into the output so attention runs directly in the 512-dim compressed
    space, in fp32 over the latent cache.

The cache is written **in place** (``layers.attention._write_at``), as the
port's KV caches are.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.distributed.partitioning import pshard
from repro_torch.layers.attention import NEG_INF, _scale, _write_at, flash_attention
from repro_torch.layers.common import rmsnorm
from repro_torch.layers.params import ParamSpec
from repro_torch.layers.rope import apply_rope

__all__ = ["mla_schema", "mla_block", "init_mla_cache_spec"]


def mla_schema(cfg) -> dict:
    d, h = cfg.d_model, cfg.num_heads
    r_kv, r_q = cfg.kv_lora_rank, cfg.q_lora_rank
    dn, dr, dv = cfg.head_dim, cfg.rope_head_dim, cfg.v_head_dim
    return {
        "wq_a": ParamSpec((d, r_q), ("embed", None)),
        "q_norm": ParamSpec((r_q,), ("norm",), init="ones"),
        "wq_b": ParamSpec((r_q, h, dn + dr), (None, "heads", "head_dim")),
        "wkv_a": ParamSpec((d, r_kv + dr), ("embed", "kv_lora")),
        "kv_norm": ParamSpec((r_kv,), ("norm",), init="ones"),
        "wk_b": ParamSpec((r_kv, h, dn), ("kv_lora", "heads", "head_dim")),
        "wv_b": ParamSpec((r_kv, h, dv), ("kv_lora", "heads", "head_dim")),
        "wo": ParamSpec((h, dv, d), ("heads", "head_dim", "embed")),
    }


def init_mla_cache_spec(cfg, batch: int, max_len: int):
    """Cache = compressed latent (r_kv) ++ rope key (dr) per position."""
    shape = (batch, max_len, cfg.kv_lora_rank + cfg.rope_head_dim)
    axes = ("batch", "kv_seq", "kv_lora")
    return shape, cfg.activation_dtype, axes


def _compress(p, cfg, x, positions):
    """-> (q_nope (B,S,H,dn), q_rope (B,S,H,dr), c_kv (B,S,r), k_rope (B,S,dr))."""
    dn = cfg.head_dim
    cq = rmsnorm(torch.einsum("bsd,dr->bsr", x, p["wq_a"].to(x.dtype)),
                 p["q_norm"], cfg.norm_eps)
    q = torch.einsum("bsr,rhk->bshk", cq, p["wq_b"].to(x.dtype))
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)

    ckv = torch.einsum("bsd,dr->bsr", x, p["wkv_a"].to(x.dtype))
    c_kv = rmsnorm(ckv[..., :cfg.kv_lora_rank], p["kv_norm"], cfg.norm_eps)
    k_rope = apply_rope(ckv[..., cfg.kv_lora_rank:], positions, cfg.rope_theta)
    return q_nope, q_rope, c_kv, k_rope


def mla_block(
    p: dict,
    cfg,
    x: torch.Tensor,  # (B, S, d)
    positions: torch.Tensor,
    cache: Optional[torch.Tensor] = None,  # (B, Smax, r_kv + dr)
    cache_pos: Optional[int] = None,
    mode: str = "train",
):
    """Returns (y (B,S,d), new_cache).  ``prefill`` and ``decode`` write the
    packed ``c_kv ‖ k_rope`` into ``cache`` in place and return it."""
    B, S, d = x.shape
    h, dn, dr, r = cfg.num_heads, cfg.head_dim, cfg.rope_head_dim, cfg.kv_lora_rank
    q_nope, q_rope, c_kv, k_rope = _compress(p, cfg, x, positions)
    new_cache = None

    if mode in ("train", "prefill"):
        # Decompressed form: concat nope+rope into a 192-dim QK space.
        k_nope = torch.einsum("bsr,rhk->bshk", c_kv, p["wk_b"].to(x.dtype))
        v = torch.einsum("bsr,rhk->bshk", c_kv, p["wv_b"].to(x.dtype))
        k = torch.cat([k_nope, k_rope[:, :, None, :].expand(B, S, h, dr)], -1)
        q = torch.cat([q_nope, q_rope], -1)  # (B,S,h,dn+dr)
        q = pshard(q[:, :, :, None, :], "batch", "seq", "heads", None, None)
        k = pshard(k, "batch", "seq", "heads", "head_dim")
        v = pshard(v, "batch", "seq", "heads", "head_dim")
        out = flash_attention(q, k, v, causal=True, chunk=cfg.attn_chunk)
        out = out[:, :, :, 0, :]  # (B,S,h,dv)
        if mode == "prefill":
            new_cache = pshard(_write_at(cache, 0, torch.cat([c_kv, k_rope], -1)),
                               "batch", "kv_seq", "kv_lora")
    elif mode == "decode":
        # Absorbed form: attention entirely in the compressed space.
        cache = pshard(_write_at(cache, cache_pos, torch.cat([c_kv, k_rope], -1)),
                       "batch", "kv_seq", "kv_lora")
        new_cache = cache
        ckv_cache, krope_cache = cache[..., :r].float(), cache[..., r:].float()
        # fold W_uk into q:   q_eff = q_nope @ W_uk  -> (B,1,h,r)
        q_eff = torch.einsum("bshk,rhk->bshr", q_nope, p["wk_b"].to(x.dtype))
        s = (torch.einsum("bshr,btr->bhst", q_eff.float(), ckv_cache)
             + torch.einsum("bshk,btk->bhst", q_rope.float(), krope_cache)) * _scale(dn + dr)
        valid = torch.arange(cache.shape[1], device=x.device) <= cache_pos
        s = torch.where(valid[None, None, None, :], s, NEG_INF)
        attn = torch.softmax(s, dim=-1)
        ctx = torch.einsum("bhst,btr->bshr", attn, ckv_cache)
        # fold W_uv into the output
        out = torch.einsum("bshr,rhk->bshk", ctx.to(x.dtype), p["wv_b"].to(x.dtype))
    else:
        raise ValueError(f"unknown mode {mode!r}")

    y = torch.einsum("bshk,hkd->bsd", out, p["wo"].to(x.dtype))
    return pshard(y, "batch", "act_seq", "embed"), new_cache
