"""Zamba2-style hybrid: Mamba2 backbone + shared attention blocks — the port
of ``repro.models.zamba``.

``num_layers`` Mamba2 residual blocks are interleaved with applications of
``num_shared_blocks`` weight-shared transformer blocks (attention + MLP):
after every ``shared_attn_period`` Mamba layers, shared block
``(app_index % num_shared_blocks)`` runs.  Shared-block weights are stored
once, while each application keeps its own KV cache.  Mamba layers past
the last application run at the end.

Simplifications vs the released checkpoints (the reference's): per-
application LoRA deltas on the shared blocks and the concatenated residual
input are omitted; block structure, GQA geometry, SSM sizes and the
sharing schedule follow the config.  Caches are written **in place**
(``layers.attention``, ``layers.ssd``); a caller must not reuse the cache
it passed in.  As in the reference, the config's ``remat`` does not apply
to this family.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.distributed.partitioning import pshard
from repro_torch.layers import attention as attn_lib
from repro_torch.layers.common import cross_entropy, embed_lookup, rmsnorm
from repro_torch.layers.mlp import mlp_block, mlp_schema
from repro_torch.layers.params import ParamSpec, stack_schema
from repro_torch.layers.ssd import mamba_schema
from repro_torch.models.lm import _unstack, unembed
from repro_torch.models.mamba_lm import mamba_layer, ssm_layer_cache_schema

__all__ = ["schema", "cache_schema", "loss", "prefill", "decode_step", "forward"]


def _num_apps(cfg) -> int:
    return cfg.num_layers // cfg.shared_attn_period


def _shared_block_schema(cfg) -> dict:
    d = cfg.d_model
    return {
        "ln1": ParamSpec((d,), ("norm",), init="ones"),
        "attn": attn_lib.gqa_schema(cfg),
        "ln2": ParamSpec((d,), ("norm",), init="ones"),
        "mlp": mlp_schema(cfg),
    }


def schema(cfg) -> dict:
    s: Dict[str, Any] = {
        "embed": ParamSpec((cfg.vocab_size, cfg.d_model), ("vocab", "embed"),
                           init="embed", scale=0.02),
        "blocks": stack_schema(
            {"ln": ParamSpec((cfg.d_model,), ("norm",), init="ones"),
             "mamba": mamba_schema(cfg)},
            cfg.num_layers,
        ),
        "shared": stack_schema(_shared_block_schema(cfg), cfg.num_shared_blocks,
                               axis_name="layers"),
        "final_norm": ParamSpec((cfg.d_model,), ("norm",), init="ones"),
    }
    if not cfg.tie_embeddings:
        s["lm_head"] = ParamSpec((cfg.d_model, cfg.vocab_size), ("embed", "vocab"))
    return s


def cache_schema(cfg, batch: int, max_len: int) -> dict:
    kv_shape, kv_dtype, kv_axes = attn_lib.init_kv_cache_spec(cfg, batch, max_len)
    kv = ParamSpec(kv_shape, kv_axes, init="zeros", dtype=str(kv_dtype).removeprefix("torch."))
    # one KV cache per shared-block APPLICATION (not per shared block)
    return {
        "layers": stack_schema(ssm_layer_cache_schema(cfg, batch), cfg.num_layers),
        "shared_kv": stack_schema({"k": kv, "v": kv}, _num_apps(cfg), axis_name="layers"),
    }


def _shared_apply(p, cfg, x, positions, kv, cache_pos, mode):
    h = rmsnorm(x, p["ln1"], cfg.norm_eps)
    a, _ = attn_lib.attention_block(
        p["attn"], cfg, h, positions,
        cache=None if kv is None else (kv["k"], kv["v"]),
        cache_pos=cache_pos, mode=mode)
    x = x + a
    h = rmsnorm(x, p["ln2"], cfg.norm_eps)
    return x + mlp_block(p["mlp"], cfg, h)


def forward(params, cfg, tokens, *, cache=None, cache_pos=None, mode="train",
            last_logit_only=False):
    """Returns (logits (B, S, V), cache, metrics {})."""
    period, n_apps = cfg.shared_attn_period, _num_apps(cfg)
    x = embed_lookup(params["embed"], tokens, cfg.activation_dtype)
    x = pshard(x, "batch", "act_seq", "embed")
    B, S, _ = x.shape
    if mode == "decode":
        positions = torch.full((B, 1), cache_pos, dtype=torch.int32, device=x.device)
    else:
        positions = torch.arange(S, dtype=torch.int32, device=x.device).expand(B, S)

    n = cfg.num_layers
    layers = _unstack(params["blocks"], n)
    shared = _unstack(params["shared"], cfg.num_shared_blocks)
    layer_caches = [None] * n if cache is None else _unstack(cache["layers"], n)
    kvs = [None] * n_apps if cache is None else _unstack(cache["shared_kv"], n_apps)
    for i in range(n):
        x = mamba_layer(layers[i], cfg, x, layer_caches[i], mode)
        app = i // period
        if (i + 1) % period == 0 and app < n_apps:
            x = _shared_apply(shared[app % cfg.num_shared_blocks], cfg, x, positions,
                              kvs[app], cache_pos, mode)

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
    """One decode step at position ``pos`` (a Python int); writes the cache
    in place; returns (logits (B, V), cache)."""
    logits, new_cache, _ = forward(params, cfg, tokens, cache=cache, cache_pos=pos,
                                   mode="decode")
    return logits[:, -1, :], new_cache
