"""Mamba2 language model (attention-free SSM; mamba2-130m) — the port of
``repro.models.mamba_lm``.

Embedding -> (norm + Mamba2 block) residual layers -> norm -> tied logits.
The reference's ``lax.scan`` over the stacked ``blocks`` is a Python loop
over their layers (one ``unbind`` per leaf, see ``models.lm._unstack``).
Decode is O(1) per token: the cache is the conv window plus the (H, P, N)
SSM state per layer, written **in place** (``layers.ssd.mamba_block``);
a caller must not reuse the cache it passed in.  As in the reference, the
config's ``remat`` does not apply to this family.
"""

from __future__ import annotations

from typing import Any, Dict

from repro_torch.layers.common import cross_entropy, embed_lookup, rmsnorm
from repro_torch.layers.params import ParamSpec, stack_schema
from repro_torch.layers.ssd import init_ssm_cache_spec, mamba_block, mamba_schema
from repro_torch.models.lm import _unstack, unembed

__all__ = ["schema", "cache_schema", "loss", "prefill", "decode_step", "forward"]


def _block_schema(cfg) -> dict:
    return {
        "ln": ParamSpec((cfg.d_model,), ("norm",), init="ones"),
        "mamba": mamba_schema(cfg),
    }


def schema(cfg) -> dict:
    s: Dict[str, Any] = {
        "embed": ParamSpec((cfg.vocab_size, cfg.d_model), ("vocab", "embed"),
                           init="embed", scale=0.02),
        "blocks": stack_schema(_block_schema(cfg), cfg.num_layers),
        "final_norm": ParamSpec((cfg.d_model,), ("norm",), init="ones"),
    }
    if not cfg.tie_embeddings:
        s["lm_head"] = ParamSpec((cfg.d_model, cfg.vocab_size), ("embed", "vocab"))
    return s


def ssm_layer_cache_schema(cfg, batch: int) -> dict:
    """One Mamba layer's cache: the conv window (activation dtype) and the
    fp32 SSM state."""
    (conv_shape, conv_axes), (ssm_shape, ssm_axes) = init_ssm_cache_spec(cfg, batch)
    return {
        "conv": ParamSpec(conv_shape, conv_axes, init="zeros", dtype=cfg.dtype),
        "ssm": ParamSpec(ssm_shape, ssm_axes, init="zeros", dtype="float32"),
    }


def cache_schema(cfg, batch: int, max_len: int) -> dict:
    return {"layers": stack_schema(ssm_layer_cache_schema(cfg, batch), cfg.num_layers)}


def mamba_layer(lp, cfg, x, lc, mode):
    """One pre-norm residual Mamba layer; writes ``lc`` (a layer's cache
    dict, or None) in place."""
    h = rmsnorm(x, lp["ln"], cfg.norm_eps)
    y, _ = mamba_block(lp["mamba"], cfg, h,
                       cache=None if lc is None else (lc["conv"], lc["ssm"]), mode=mode)
    return x + y


def forward(params, cfg, tokens, *, cache=None, cache_pos=None, mode="train",
            last_logit_only=False):
    """Returns (logits (B, S, V), cache, metrics {})."""
    x = embed_lookup(params["embed"], tokens, cfg.activation_dtype)
    n = cfg.num_layers
    layer_caches = [None] * n if cache is None else _unstack(cache["layers"], n)
    for lp, lc in zip(_unstack(params["blocks"], n), layer_caches):
        x = mamba_layer(lp, cfg, x, lc, mode)
    if last_logit_only:
        # only the last position's logits are consumed: slice the hidden
        # state before the unembedding matmul
        x = x[:, -1:]
    return unembed(params, cfg, x), cache, {}


def loss(params, cfg, batch):
    logits, _, metrics = forward(params, cfg, batch["tokens"], mode="train")
    l, ce = cross_entropy(logits, batch["targets"], batch.get("mask"))
    metrics.update(ce)
    metrics["total_loss"] = l
    return l, metrics


def prefill(params, cfg, batch, cache):
    """Fill the cache (in place); return (last-position logits (B, V), cache)."""
    logits, new_cache, _ = forward(params, cfg, batch["tokens"], cache=cache, cache_pos=0,
                                   mode="prefill", last_logit_only=True)
    return logits[:, -1, :], new_cache


def decode_step(params, cfg, tokens, cache, pos):
    """One decode step (the position is implicit in the state); writes the
    cache in place; returns (logits (B, V), cache)."""
    logits, new_cache, _ = forward(params, cfg, tokens, cache=cache, cache_pos=pos,
                                   mode="decode")
    return logits[:, -1, :], new_cache
