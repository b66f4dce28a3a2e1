"""Decoder-only LM covering the dense / MoE / MLA / VLM-prefix families —
the port of ``repro.models.lm``.

One config-driven assembly:
  * attention: GQA (qwen2/3, arctic) or MLA (deepseek-v2)
  * FFN: SwiGLU MLP, MoE (+shared experts), or MoE + parallel dense
    residual (arctic); ``first_k_dense`` prologue layers (deepseek) keep
    the config's attention and use the dense MLP
  * optional multimodal prefix: precomputed frontend embeddings (internvl2
    stub ViT) are concatenated ahead of the token embeddings
  * the reference's ``lax.scan`` over the stacked ``blocks`` is a Python
    loop over their leading (layer) dimension; MoE metrics are averaged
    over the stacked layers (the prologue's are dropped, as the reference
    drops them)
  * ``cfg.remat`` applies when a train-mode forward records a graph:
    ``"full"`` checkpoints each stacked block
    (``torch.utils.checkpoint.checkpoint(..., use_reentrant=False)``, the
    reference's ``jax.checkpoint``), and ``"dots"`` checkpoints it
    selectively, saving the outputs of matmuls without batch dimensions
    (the reference's ``checkpoint_dots_with_no_batch_dims``).  A
    checkpointed block returns its MoE metrics with their graph, so the
    router's aux terms reach its gradient.  Serving modes and forwards
    without a graph run the blocks plainly

The same forward serves train, prefill (fills the KV cache, returns
last-position logits) and single-token decode.  Prefill and decode write
the cache **in place** and return the same tree (see
``layers.attention``); a caller must not reuse the cache it passed in.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Optional

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.distributed.partitioning import pshard
from repro_torch.layers import attention as attn_lib
from repro_torch.layers import mla as mla_lib
from repro_torch.layers import moe as moe_lib
from repro_torch.layers.common import cross_entropy, embed_lookup, rmsnorm
from repro_torch.layers.mlp import mlp_block, mlp_schema
from repro_torch.layers.params import ParamSpec, stack_schema, tree_map

__all__ = ["schema", "cache_schema", "loss", "prefill", "decode_step", "forward"]

# ----------------------------------------------------------------------
# Schemas
# ----------------------------------------------------------------------
def _block_schema(cfg, moe: bool) -> dict:
    d = cfg.d_model
    s: Dict[str, Any] = {
        "ln1": ParamSpec((d,), ("norm",), init="ones"),
        "ln2": ParamSpec((d,), ("norm",), init="ones"),
    }
    s["attn"] = mla_lib.mla_schema(cfg) if cfg.attention == "mla" else attn_lib.gqa_schema(cfg)
    if moe:
        s["moe"] = moe_lib.moe_schema(cfg)
        if cfg.dense_residual:
            s["dense"] = mlp_schema(cfg)
    else:
        s["mlp"] = mlp_schema(cfg)
    return s


def _n_scan(cfg) -> int:
    return cfg.num_layers - cfg.first_k_dense


def schema(cfg) -> dict:
    d, v = cfg.d_model, cfg.vocab_size
    s: Dict[str, Any] = {
        "embed": ParamSpec((v, d), ("vocab", "embed"), init="embed", scale=0.02),
        "blocks": stack_schema(_block_schema(cfg, moe=cfg.is_moe), _n_scan(cfg)),
        "final_norm": ParamSpec((d,), ("norm",), init="ones"),
    }
    for i in range(cfg.first_k_dense):
        s[f"prologue_{i}"] = _block_schema(cfg, moe=False)
    if not cfg.tie_embeddings:
        s["lm_head"] = ParamSpec((d, v), ("embed", "vocab"))
    return s


def cache_schema(cfg, batch: int, max_len: int) -> dict:
    """ParamSpec tree (init=zeros) describing the decode cache."""
    spec = mla_lib.init_mla_cache_spec if cfg.attention == "mla" else attn_lib.init_kv_cache_spec
    shape, dtype, axes = spec(cfg, batch, max_len)
    one = ParamSpec(shape, axes, init="zeros", dtype=str(dtype).removeprefix("torch."))
    layer = {"ckv": one} if cfg.attention == "mla" else {"k": one, "v": one}
    s = {"layers": stack_schema(layer, _n_scan(cfg))}
    for i in range(cfg.first_k_dense):
        s[f"prologue_{i}"] = dict(layer)
    return s


# ----------------------------------------------------------------------
# Blocks
# ----------------------------------------------------------------------
def _apply_block(p, cfg, x, positions, cache, cache_pos, mode, moe: bool):
    """Pre-norm residual block; writes ``cache`` (a layer's cache dict, or
    None) in place. Returns (x, metrics)."""
    h = rmsnorm(x, p["ln1"], cfg.norm_eps)
    if cfg.attention == "mla":
        a, _ = mla_lib.mla_block(p["attn"], cfg, h, positions,
                                 cache=None if cache is None else cache["ckv"],
                                 cache_pos=cache_pos, mode=mode)
    else:
        a, _ = attn_lib.attention_block(
            p["attn"], cfg, h, positions,
            cache=None if cache is None else (cache["k"], cache["v"]),
            cache_pos=cache_pos, mode=mode)
    x = x + a
    h = rmsnorm(x, p["ln2"], cfg.norm_eps)
    metrics = {}
    if moe:
        f, metrics = moe_lib.moe_block(p["moe"], cfg, h)
        if cfg.dense_residual:
            f = f + mlp_block(p["dense"], cfg, h)
    else:
        f = mlp_block(p["mlp"], cfg, h)
    return x + f, metrics


def _dots_policy(ctx, op, *args, **kwargs):
    """Save the outputs of matmuls without batch dimensions, recompute the
    rest.  ``torch.einsum`` lowers a contraction with no batch dimension to
    a ``bmm`` of batch 1 (the projections, the MLP, the unembedding); the
    attention scores are ``bmm``s over ``B * Kh`` and are recomputed, as
    the reference's policy recomputes its batched dots (at ``B * Kh == 1``
    they are saved too, which costs memory, not correctness)."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    if op is torch.ops.aten.bmm.default and args[0].shape[0] == 1:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat(fn, cfg, mode: str):
    """``fn`` wrapped as ``cfg.remat`` asks, in a train forward that records
    a graph; ``fn`` itself otherwise."""
    if mode != "train" or not torch.is_grad_enabled() or cfg.remat == "none":
        return fn
    if cfg.remat == "full":
        return functools.partial(checkpoint, fn, use_reentrant=False)
    if cfg.remat == "dots":
        return functools.partial(
            checkpoint, fn, use_reentrant=False,
            context_fn=functools.partial(create_selective_checkpoint_contexts, _dots_policy))
    raise ValueError(f"unknown remat {cfg.remat!r}; expected none | dots | full")


def _unstack(tree, n: int) -> list:
    """The ``n`` layers of a stacked tree, as views from one ``unbind`` per
    leaf (so cache writes land in the stack).  Its backward stacks the
    layers' gradients into the stacked leaf's gradient once; indexing each
    layer apart would instead add a zero-filled gradient of the whole
    stacked leaf per layer, ``n`` times the stack's bytes."""
    parts = tree_map(lambda t: t.unbind(0), tree, is_leaf=lambda t: not isinstance(t, dict))
    return [tree_map(lambda u: u[i], parts, is_leaf=lambda u: not isinstance(u, dict))
            for i in range(n)]


# ----------------------------------------------------------------------
# Forward
# ----------------------------------------------------------------------
def forward(
    params,
    cfg,
    tokens: torch.Tensor,  # (B, S)
    *,
    frontend: Optional[torch.Tensor] = None,  # (B, F, d) precomputed embeds
    cache=None,
    cache_pos=None,
    mode: str = "train",
    last_logit_only: bool = False,
):
    """Returns (logits (B, S_total, V), cache, metrics).  ``cache`` is the
    tree passed in, written in place (None when none was passed)."""
    act = cfg.activation_dtype
    x = embed_lookup(params["embed"], tokens, act)
    if frontend is not None:
        x = torch.cat([frontend.to(act), x], dim=1)
    B, S, _ = x.shape
    x = pshard(x, "batch", "act_seq", "embed")
    if mode == "decode":
        positions = torch.full((B, 1), cache_pos, dtype=torch.int32, device=x.device)
    else:
        positions = torch.arange(S, dtype=torch.int32, device=x.device).expand(B, S)

    for i in range(cfg.first_k_dense):
        c = None if cache is None else cache[f"prologue_{i}"]
        x, _ = _apply_block(params[f"prologue_{i}"], cfg, x, positions, c, cache_pos, mode,
                            moe=False)

    def block(p, x, lc):
        return _apply_block(p, cfg, x, positions, lc, cache_pos, mode, moe=cfg.is_moe)

    block = _remat(block, cfg, mode)
    n = _n_scan(cfg)
    layer_caches = [None] * n if cache is None else _unstack(cache["layers"], n)
    layer_metrics = []
    for lp, lc in zip(_unstack(params["blocks"], n), layer_caches):
        x, m = block(lp, x, lc)
        layer_metrics.append(m)

    if last_logit_only:
        # only the last position's logits are consumed: slice the hidden
        # state before the unembedding matmul
        x = x[:, -1:]
    metrics = {}
    if cfg.is_moe and layer_metrics:
        metrics = {k: torch.stack([m[k] for m in layer_metrics]).mean()
                   for k in layer_metrics[0]}
    return unembed(params, cfg, x), cache, metrics


def unembed(params, cfg, x):
    """Final norm, then logits through the tied embedding or ``lm_head``."""
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    if cfg.tie_embeddings:
        logits = torch.einsum("bsd,vd->bsv", x, params["embed"].to(x.dtype))
    else:
        logits = torch.einsum("bsd,dv->bsv", x, params["lm_head"].to(x.dtype))
    return pshard(logits, "batch", "seq", "vocab")


# ----------------------------------------------------------------------
# Unified API
# ----------------------------------------------------------------------
def loss(params, cfg, batch):
    logits, _, metrics = forward(
        params, cfg, batch["tokens"], frontend=batch.get("frontend"), mode="train"
    )
    if batch.get("frontend") is not None:
        logits = logits[:, batch["frontend"].shape[1]:]
    l, ce_metrics = cross_entropy(logits, batch["targets"], batch.get("mask"))
    metrics.update(ce_metrics)
    if cfg.is_moe:
        l = (l + cfg.router_aux_weight * metrics["moe_aux_loss"]
             + cfg.router_z_weight * metrics["moe_z_loss"])
    metrics["total_loss"] = l
    return l, metrics


def prefill(params, cfg, batch, cache):
    """Fill the cache (in place); return (last-position logits (B, V), cache)."""
    logits, new_cache, _ = forward(
        params, cfg, batch["tokens"], frontend=batch.get("frontend"),
        cache=cache, cache_pos=0, mode="prefill", last_logit_only=True,
    )
    return logits[:, -1, :], new_cache


def decode_step(params, cfg, tokens, cache, pos):
    """One decode step at position ``pos`` (a Python int); writes the cache
    in place; returns (logits (B, V), cache)."""
    logits, new_cache, _ = forward(
        params, cfg, tokens, cache=cache, cache_pos=pos, mode="decode"
    )
    return logits[:, -1, :], new_cache
