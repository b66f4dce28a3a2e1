"""Attention: GQA with flash-style chunked softmax, plus cached decode — the
port of ``repro.layers.attention``.

Design notes:

* GQA is computed in *grouped* layout — q ``(B, S, Kh, G, D)`` against
  un-replicated kv ``(B, S, Kh, D)`` — KV heads are never materially
  repeated.
* Long sequences use an online softmax over KV chunks (a loop whose carry
  is the running max / normaliser / accumulator), Q chunks outside, KV
  chunks inside.  This keeps activation memory O(S · chunk) instead of
  O(S^2).  The gradient is the reference's own VJP (``_flash_bwd``): the
  forward keeps only its output, running max and normaliser, and the
  backward recomputes each chunk's probabilities from them.  Causality is
  enforced by masking with -1e30; chunks fully in the future wash out of
  the online softmax.  The function is the reference's, operation for
  operation, in torch ops (not
  ``scaled_dot_product_attention``): the reference computes it in
  ``jnp``, outside any kernel, so there is no TPU kernel to port here.
* Decode attends one query position against the whole preallocated KV
  cache, masking ``arange(Smax) <= pos``.
* V head dim may differ from QK head dim (MLA reuses this code).
* KV caches are written **in place**: a prefill or decode step writes its
  keys and values into the preallocated cache tensors it is given and
  returns those same tensors (the reference's ``dynamic_update_slice``
  returns new arrays, and its serving loop donates the old ones).  A
  caller must not reuse a cache it passed in as the state before the step.
  Cache positions are Python ints, so a decode step copies nothing
  between the host and the card.
* Activations and caches carry the reference's logical-axis tags
  (``distributed.partitioning.pshard``, an identity on the tensor).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.distributed.partitioning import pshard
from repro_torch.layers.common import rmsnorm
from repro_torch.layers.params import ParamSpec
from repro_torch.layers.rope import apply_rope

__all__ = [
    "gqa_schema",
    "flash_attention",
    "decode_attention",
    "attention_block",
    "init_kv_cache_spec",
]

NEG_INF = -1e30


# ----------------------------------------------------------------------
# Parameter schema
# ----------------------------------------------------------------------
def gqa_schema(cfg) -> dict:
    d, h, kh, dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    s = {
        "wq": ParamSpec((d, h, dh), ("embed", "heads", "head_dim")),
        "wk": ParamSpec((d, kh, dh), ("embed", "kv_heads", "head_dim")),
        "wv": ParamSpec((d, kh, dh), ("embed", "kv_heads", "head_dim")),
        "wo": ParamSpec((h, dh, d), ("heads", "head_dim", "embed")),
    }
    if cfg.qkv_bias:
        s["bq"] = ParamSpec((h, dh), ("heads", "head_dim"), init="zeros")
        s["bk"] = ParamSpec((kh, dh), ("kv_heads", "head_dim"), init="zeros")
        s["bv"] = ParamSpec((kh, dh), ("kv_heads", "head_dim"), init="zeros")
    if cfg.qk_norm:
        s["q_norm"] = ParamSpec((dh,), ("norm",), init="ones")
        s["k_norm"] = ParamSpec((dh,), ("norm",), init="ones")
    return s


# ----------------------------------------------------------------------
# Flash-style chunked attention (training / prefill)
# ----------------------------------------------------------------------
def _scale(d: int) -> float:
    """1/sqrt(d) rounded as the reference rounds it (fp32 sqrt, fp32 divide)."""
    return float(np.float32(1.0) / np.sqrt(np.float32(d)))


def _chunk_mask(q_pos, ki, ck, Sk, causal):
    k_pos = ki * ck + torch.arange(ck, dtype=q_pos.dtype, device=q_pos.device)
    mask = k_pos[None, :] < Sk  # real (un-padded) KV positions
    if causal:
        mask = mask & (q_pos[:, None] >= k_pos[None, :])
    return mask  # (Sq, ck)


def _kv_chunks(k, v, chunk):
    """K and V cut into ``(nk, B, ck, Kh, D)`` chunks of ``ck = min(chunk,
    Sk)`` positions, the last zero-padded; returns ``(kc, vc, ck)``."""
    B, Sk, Kh, Dqk = k.shape
    ck = min(chunk, Sk)
    pad = (-Sk) % ck
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    nk = (Sk + pad) // ck
    kc = k.reshape(B, nk, ck, Kh, Dqk).transpose(0, 1)
    vc = v.reshape(B, nk, ck, Kh, v.shape[-1]).transpose(0, 1)
    return kc, vc, ck


def _flash_fwd_core(q, k, v, q_pos, causal, chunk):
    B, Sq, Kh, G, Dqk = q.shape
    Sk = k.shape[1]
    Dv = v.shape[-1]
    kc, vc, ck = _kv_chunks(k, v, chunk)
    nk = kc.shape[0]
    qf = q.float() * _scale(Dqk)

    m = torch.full((B, Sq, Kh, G), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, Sq, Kh, G), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, Sq, Kh, G, Dv), dtype=torch.float32, device=q.device)
    for ki in range(nk):
        s = torch.einsum("bqkgd,bskd->bqkgs", qf, kc[ki].float())
        mask = _chunk_mask(q_pos, ki, ck, Sk, causal)
        s = torch.where(mask[None, :, None, None, :], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bqkgs,bskd->bqkgd", p, vc[ki].float())
        m = m_new
    out = acc / torch.clamp_min(l, 1e-37)[..., None]
    return out.to(q.dtype), m, l


def _flash_bwd_core(q, k, v, q_pos, out, m, l, g, causal, chunk):
    """The reference's ``_flash_bwd``: ``p`` is recomputed per KV chunk
    against the forward's saved max ``m`` and normaliser ``l``, with
    ``delta = sum(g * out)`` over the value dim; ``dq`` accumulates in fp32
    across chunks, ``dk``/``dv`` are computed per chunk and joined."""
    B, Sq, Kh, G, Dqk = q.shape
    Sk = k.shape[1]
    scale = _scale(Dqk)
    kc, vc, ck = _kv_chunks(k, v, chunk)
    qf = q.float() * scale
    gf = g.float()
    l_safe = torch.clamp_min(l, 1e-37)
    delta = torch.sum(gf * out.float(), dim=-1)  # (B, Sq, Kh, G)

    dq = torch.zeros((B, Sq, Kh, G, Dqk), dtype=torch.float32, device=q.device)
    dk_c, dv_c = [], []
    for ki in range(kc.shape[0]):
        kb, vb = kc[ki].float(), vc[ki].float()
        s = torch.einsum("bqkgd,bskd->bqkgs", qf, kb)
        mask = _chunk_mask(q_pos, ki, ck, Sk, causal)
        s = torch.where(mask[None, :, None, None, :], s, NEG_INF)
        p = torch.exp(s - m[..., None]) / l_safe[..., None]
        dv_c.append(torch.einsum("bqkgs,bqkgd->bskd", p, gf))
        dp = torch.einsum("bqkgd,bskd->bqkgs", gf, vb)
        ds = p * (dp - delta[..., None])
        dq = dq + torch.einsum("bqkgs,bskd->bqkgd", ds, kb) * scale
        dk_c.append(torch.einsum("bqkgs,bqkgd->bskd", ds, qf))
    dk = torch.cat(dk_c, dim=1)[:, :Sk]
    dv = torch.cat(dv_c, dim=1)[:, :Sk]
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _Flash(torch.autograd.Function):
    """The reference's ``_flash`` (a ``jax.custom_vjp`` with ``causal`` and
    ``chunk`` as ``nondiff_argnums``): the forward is
    :func:`_flash_fwd_core` and saves ``(q, k, v, q_pos, out, m, l)``; the
    backward is :func:`_flash_bwd_core`, which recomputes the scores per
    KV chunk rather than keeping them.  ``q_pos`` gets no gradient (the
    reference returns a zero cotangent for it)."""

    @staticmethod
    def forward(ctx, q, k, v, q_pos, causal, chunk):
        out, m, l = _flash_fwd_core(q, k, v, q_pos, causal, chunk)
        ctx.save_for_backward(q, k, v, q_pos, out, m, l)
        ctx.causal, ctx.chunk = causal, chunk
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, q_pos, out, m, l = ctx.saved_tensors
        dq, dk, dv = _flash_bwd_core(q, k, v, q_pos, out, m, l, g, ctx.causal, ctx.chunk)
        return dq, dk, dv, None, None, None


def _flash(q, k, v, q_pos, causal, chunk):
    return _Flash.apply(q, k, v, q_pos, causal, chunk)


def flash_attention(
    q: torch.Tensor,  # (B, Sq, Kh, G, Dqk)
    k: torch.Tensor,  # (B, Sk, Kh, Dqk)
    v: torch.Tensor,  # (B, Sk, Kh, Dv)
    *,
    causal: bool = True,
    q_offset: int = 0,
    chunk: int = 1024,
    q_chunk: int = 512,
) -> torch.Tensor:  # (B, Sq, Kh, G, Dv)
    """2-D tiled flash attention: KV chunks inside, Q chunks outside.

    The Q tiling bounds every score block to (B, q_chunk, H, kv_chunk)
    fp32.  Query positions travel as an fp32 tensor (exact for positions
    < 2^24), as in the reference.
    """
    B, Sq, Kh, G, Dqk = q.shape
    Sk = k.shape[1]
    kv_chunk = min(chunk, Sk)
    q_pos_all = (q_offset + torch.arange(Sq, device=q.device)).float()
    cq = min(q_chunk, Sq)
    if Sq % cq:  # pad Q; padded rows attend to position 0 only, then dropped
        padq = (-Sq) % cq
        q = F.pad(q, (0, 0, 0, 0, 0, 0, 0, padq))
        q_pos_all = F.pad(q_pos_all, (0, padq))
        Sq_p = Sq + padq
    else:
        Sq_p = Sq
    nq = Sq_p // cq
    if nq == 1:
        return _flash(q, k, v, q_pos_all, causal, kv_chunk)[:, :Sq]
    outs = [
        _flash(q[:, i * cq:(i + 1) * cq], k, v, q_pos_all[i * cq:(i + 1) * cq], causal, kv_chunk)
        for i in range(nq)
    ]
    return torch.cat(outs, dim=1)[:, :Sq]


# ----------------------------------------------------------------------
# Cached decode attention (one query position)
# ----------------------------------------------------------------------
def decode_attention(
    q: torch.Tensor,  # (B, 1, Kh, G, Dqk)
    k_cache: torch.Tensor,  # (B, Smax, Kh, Dqk)
    v_cache: torch.Tensor,  # (B, Smax, Kh, Dv)
    pos: int,  # current position (cache filled through pos)
) -> torch.Tensor:  # (B, 1, Kh, G, Dv)
    Dqk = q.shape[-1]
    Smax = k_cache.shape[1]
    s = torch.einsum("bqkgd,bskd->bqkgs", q.float() * _scale(Dqk), k_cache.float())
    valid = torch.arange(Smax, device=q.device) <= pos
    s = torch.where(valid[None, None, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bqkgs,bskd->bqkgd", p, v_cache.float())
    return out.to(q.dtype)


# ----------------------------------------------------------------------
# Full block (projections + rope + norm + cache plumbing)
# ----------------------------------------------------------------------
def _project_qkv(p, cfg, x):
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(x.dtype))
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"].to(x.dtype))
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"].to(x.dtype))
    if cfg.qkv_bias:
        q = q + p["bq"].to(x.dtype)
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"], cfg.norm_eps)
        k = rmsnorm(k, p["k_norm"], cfg.norm_eps)
    return q, k, v


def init_kv_cache_spec(cfg, batch: int, max_len: int):
    """(shape, dtype, logical axes) for one layer's K and V caches."""
    kh, dh = cfg.num_kv_heads, cfg.head_dim
    shape = (batch, max_len, kh, dh)
    axes = ("batch", "kv_seq", "kv_heads", "head_dim")
    return shape, cfg.activation_dtype, axes


def _write_at(cache: torch.Tensor, pos: int, value: torch.Tensor) -> torch.Tensor:
    """Write ``value`` (B, n, ...) into ``cache`` (B, Smax, ...) from
    sequence position ``pos`` on, in place (the reference's
    ``dynamic_update_slice``)."""
    cache[:, pos:pos + value.shape[1]] = value.to(cache.dtype)
    return cache


def attention_block(
    p: dict,
    cfg,
    x: torch.Tensor,  # (B, S, d)
    positions: torch.Tensor,  # (B, S)
    cache: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    cache_pos: Optional[int] = None,
    mode: str = "train",
):
    """Returns (y, new_cache). Modes: train | prefill | decode.

    ``prefill`` and ``decode`` write into ``cache`` in place and return the
    same two tensors as ``new_cache``.
    """
    B, S, d = x.shape
    h, kh = cfg.num_heads, cfg.num_kv_heads
    G = h // kh
    q, k, v = _project_qkv(p, cfg, x)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    q = pshard(q.reshape(B, S, kh, G, cfg.head_dim), "batch", "seq", "kv_heads", None, None)
    k = pshard(k, "batch", "seq", "kv_heads", None)  # in-flight: Dh replicated
    v = pshard(v, "batch", "seq", "kv_heads", None)

    new_cache = None
    if mode in ("train", "prefill"):
        out = flash_attention(q, k, v, causal=True, chunk=cfg.attn_chunk)
        if mode == "prefill":
            kc, vc = cache  # pre-allocated (B, Smax, Kh, Dh)
            new_cache = (pshard(_write_at(kc, 0, k), "batch", "kv_seq", "kv_heads", "head_dim"),
                         pshard(_write_at(vc, 0, v), "batch", "kv_seq", "kv_heads", "head_dim"))
    elif mode == "decode":
        kc, vc = cache
        kc = pshard(_write_at(kc, cache_pos, k), "batch", "kv_seq", "kv_heads", "head_dim")
        vc = pshard(_write_at(vc, cache_pos, v), "batch", "kv_seq", "kv_heads", "head_dim")
        out = decode_attention(q, kc, vc, cache_pos)
        new_cache = (kc, vc)
    else:
        raise ValueError(f"unknown mode {mode!r}")

    out = out.reshape(B, S, h, cfg.head_dim)
    y = torch.einsum("bshk,hkd->bsd", out, p["wo"].to(x.dtype))
    return pshard(y, "batch", "act_seq", "embed"), new_cache
