"""Encoder-decoder backbone (seamless-m4t-large-v2) — the port of
``repro.models.encdec``.

The modality frontend is a stub: ``src`` arrives as precomputed frame
embeddings ``(B, S_enc, d_model)``.  The backbone is a pre-norm
transformer encoder-decoder: encoder self-attention is bidirectional; the
decoder stacks causal self-attention, cross-attention over the encoder
output, and the FFN.  RoPE replaces the original positions; cross
attention carries no rotation and no position.

Decode caches: per decoder layer a causal self-KV cache plus the
cross-attention keys and values computed once at prefill from the encoder
output.  As everywhere in the port, prefill and decode write the cache in
place (``layers.attention``): the cross leaves ``xk``/``xv`` must hold
exactly the encoder's ``S_enc`` positions (``distributed.steps.init_cache``
sizes them from ``enc_len``), and prefill raises when they do not — a
longer cache would leave zero rows that decode's softmax still weighs.

The reference's ``lax.scan`` over ``enc_blocks`` and ``dec_blocks`` is a
Python loop over one ``unbind`` of each stacked tree (``models.lm._unstack``).
The reference runs no remat here (whatever ``cfg.remat`` says), and neither
does the port.
"""

from __future__ import annotations

import torch

from repro_torch.distributed.partitioning import pshard
from repro_torch.layers import attention as attn_lib
from repro_torch.layers.attention import flash_attention
from repro_torch.layers.common import cross_entropy, embed_lookup, rmsnorm
from repro_torch.layers.mlp import mlp_block, mlp_schema
from repro_torch.layers.params import ParamSpec, stack_schema
from repro_torch.layers.rope import apply_rope
from repro_torch.models.lm import _unstack

__all__ = ["schema", "cache_schema", "loss", "prefill", "decode_step", "encode"]


def _enc_block_schema(cfg) -> dict:
    d = cfg.d_model
    return {
        "ln1": ParamSpec((d,), ("norm",), init="ones"),
        "attn": attn_lib.gqa_schema(cfg),
        "ln2": ParamSpec((d,), ("norm",), init="ones"),
        "mlp": mlp_schema(cfg),
    }


def _dec_block_schema(cfg) -> dict:
    s = _enc_block_schema(cfg)
    s["ln_x"] = ParamSpec((cfg.d_model,), ("norm",), init="ones")
    s["xattn"] = attn_lib.gqa_schema(cfg)
    return s


def schema(cfg) -> dict:
    d, v = cfg.d_model, cfg.vocab_size
    return {
        "embed": ParamSpec((v, d), ("vocab", "embed"), init="embed", scale=0.02),
        "enc_blocks": stack_schema(_enc_block_schema(cfg), cfg.encoder_layers),
        "enc_norm": ParamSpec((d,), ("norm",), init="ones"),
        "dec_blocks": stack_schema(_dec_block_schema(cfg), cfg.num_layers),
        "final_norm": ParamSpec((d,), ("norm",), init="ones"),
        "lm_head": ParamSpec((d, v), ("embed", "vocab")),
    }


def cache_schema(cfg, batch: int, max_len: int, enc_len: int) -> dict:
    kv_shape, kv_dtype, kv_axes = attn_lib.init_kv_cache_spec(cfg, batch, max_len)
    dtype = str(kv_dtype).removeprefix("torch.")
    self_kv = ParamSpec(kv_shape, kv_axes, init="zeros", dtype=dtype)
    x_shape = (batch, enc_len, cfg.num_kv_heads, cfg.head_dim)
    cross_kv = ParamSpec(x_shape, kv_axes, init="zeros", dtype=dtype)
    layer = {"k": self_kv, "v": self_kv, "xk": cross_kv, "xv": cross_kv}
    return {"layers": stack_schema(layer, cfg.num_layers)}


def _cross_kv(p, cfg, enc_out):
    k = torch.einsum("bsd,dhk->bshk", enc_out, p["wk"].to(enc_out.dtype))
    v = torch.einsum("bsd,dhk->bshk", enc_out, p["wv"].to(enc_out.dtype))
    return k, v


def _cross_attend(p, cfg, x, k, v):
    B, S, _ = x.shape
    h, kh = cfg.num_heads, cfg.num_kv_heads
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(x.dtype))
    q = q.reshape(B, S, kh, h // kh, cfg.head_dim)
    out = flash_attention(q, k, v, causal=False, chunk=cfg.attn_chunk)
    out = out.reshape(B, S, h, cfg.head_dim)
    return torch.einsum("bshk,hkd->bsd", out, p["wo"].to(x.dtype))


def encode(params, cfg, src: torch.Tensor) -> torch.Tensor:
    """src (B, S_enc, d) stub frame embeddings -> encoder output."""
    x = src.to(cfg.activation_dtype)
    x = pshard(x, "batch", "act_seq", "embed")
    B, S, _ = x.shape
    positions = torch.arange(S, dtype=torch.int32, device=x.device).expand(B, S)
    kh = cfg.num_kv_heads
    for lp in _unstack(params["enc_blocks"], cfg.encoder_layers):
        h = rmsnorm(x, lp["ln1"], cfg.norm_eps)
        # bidirectional self-attention
        q, k, v = attn_lib._project_qkv(lp["attn"], cfg, h)
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
        q = q.reshape(B, S, kh, cfg.num_heads // kh, cfg.head_dim)
        out = flash_attention(q, k, v, causal=False, chunk=cfg.attn_chunk)
        out = out.reshape(B, S, cfg.num_heads, cfg.head_dim)
        x = x + torch.einsum("bshk,hkd->bsd", out, lp["attn"]["wo"].to(h.dtype))
        h2 = rmsnorm(x, lp["ln2"], cfg.norm_eps)
        x = x + mlp_block(lp["mlp"], cfg, h2)
    return rmsnorm(x, params["enc_norm"], cfg.norm_eps)


def _write_cross(cache: torch.Tensor, value: torch.Tensor) -> None:
    """Fill one layer's cross cache with the encoder's keys or values."""
    if cache.shape[1] != value.shape[1]:
        raise ValueError(
            f"the cross-attention cache holds {cache.shape[1]} encoder positions but src has "
            f"{value.shape[1]}: size the cache with init_cache(..., enc_len={value.shape[1]})")
    cache.copy_(value)


def _decoder(params, cfg, tokens, enc_out=None, cache=None, cache_pos=None,
             mode="train", last_logit_only=False):
    """Returns (logits, cache): ``cache`` is the tree passed in, written in
    place (None when none was passed)."""
    x = embed_lookup(params["embed"], tokens, cfg.activation_dtype)
    x = pshard(x, "batch", "act_seq", "embed")
    B, S, _ = x.shape
    if mode == "decode":
        positions = torch.full((B, 1), cache_pos, dtype=torch.int32, device=x.device)
    else:
        positions = torch.arange(S, dtype=torch.int32, device=x.device).expand(B, S)

    n = cfg.num_layers
    layer_caches = [None] * n if cache is None else _unstack(cache["layers"], n)
    for lp, lc in zip(_unstack(params["dec_blocks"], n), layer_caches):
        h = rmsnorm(x, lp["ln1"], cfg.norm_eps)
        a, _ = attn_lib.attention_block(
            lp["attn"], cfg, h, positions,
            cache=None if lc is None else (lc["k"], lc["v"]),
            cache_pos=cache_pos, mode=mode)
        x = x + a
        h2 = rmsnorm(x, lp["ln_x"], cfg.norm_eps)
        if mode == "decode":
            xk, xv = lc["xk"], lc["xv"]
        else:
            xk, xv = _cross_kv(lp["xattn"], cfg, enc_out)
            if lc is not None:  # prefill: the cross cache, once
                _write_cross(lc["xk"], xk)
                _write_cross(lc["xv"], xv)
        x = x + _cross_attend(lp["xattn"], cfg, h2, xk, xv)
        h3 = rmsnorm(x, lp["ln2"], cfg.norm_eps)
        x = x + mlp_block(lp["mlp"], cfg, h3)

    if last_logit_only:
        x = x[:, -1:]  # skip the unembedding over the S-1 unused positions
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    logits = torch.einsum("bsd,dv->bsv", x, params["lm_head"].to(x.dtype))
    return pshard(logits, "batch", "seq", "vocab"), cache


def loss(params, cfg, batch):
    enc_out = encode(params, cfg, batch["src"])
    logits, _ = _decoder(params, cfg, batch["tokens"], enc_out, mode="train")
    l, metrics = cross_entropy(logits, batch["targets"], batch.get("mask"))
    metrics["total_loss"] = l
    return l, metrics


def prefill(params, cfg, batch, cache):
    """Encode ``batch["src"]``, fill the cache (in place) over the prompt;
    return (last-position logits (B, V), cache)."""
    enc_out = encode(params, cfg, batch["src"])
    logits, new_cache = _decoder(params, cfg, batch["tokens"], enc_out, cache=cache,
                                 cache_pos=0, mode="prefill", last_logit_only=True)
    return logits[:, -1, :], new_cache


def decode_step(params, cfg, tokens, cache, pos):
    """One decode step at position ``pos`` (a Python int), attending over
    the cross cache prefill filled; writes the cache in place; returns
    (logits (B, V), cache)."""
    logits, new_cache = _decoder(params, cfg, tokens, cache=cache, cache_pos=pos,
                                 mode="decode")
    return logits[:, -1, :], new_cache
