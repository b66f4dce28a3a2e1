"""Step-function factories: train, prefill and decode, plus their
logical-axis trees (``train_state_axes``, ``train_state_shapes``,
``batch_axes``, ``cache_axes_and_shapes``, which ``distributed.partitioning``
resolves into shardings) — the port of ``repro.distributed.steps``.

The closures run eagerly.  The reference jits them and donates their state;
here the state is updated in place instead: a train step writes the new
parameters and moments into the tensors of the state it is given (see
``optim.adamw``), and prefill and decode write the KV cache in place (see
``layers.attention``).  A caller passes each step the state the previous
step returned and never reuses an older one.  The shape trees are
``meta`` tensors (``layers.params.param_shapes``): nothing is allocated.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.config import resolve_device, torch_dtype
from repro_torch.layers.params import (init_params, param_axes, param_shapes,
                                       tree_leaves_with_path, tree_map, tree_unflatten)
from repro_torch.models.registry import get_model
from repro_torch.optim.adamw import adamw_update, init_opt_state

__all__ = ["make_train_step", "compute_grads", "init_train_state", "train_state_axes",
           "train_state_shapes", "batch_axes", "make_prefill_step", "make_decode_step",
           "init_cache", "cache_axes_and_shapes"]


# ----------------------------------------------------------------------
# Train
# ----------------------------------------------------------------------
def compute_grads(cfg, params, batch):
    """``(metrics, grads)``: ``model.loss``'s metrics (detached) and its
    gradient with respect to every leaf of ``params``, a tree of the same
    structure in the parameters' dtypes (zeros for a leaf the loss does not
    reach, as ``jax.grad`` gives).  ``params`` are not modified."""
    paths, leaves = zip(*tree_leaves_with_path(params))
    xs = [p.detach().requires_grad_() for p in leaves]
    with torch.enable_grad():
        loss, metrics = get_model(cfg).loss(tree_unflatten(paths, xs), cfg, batch)
        grads = torch.autograd.grad(loss, xs, allow_unused=True, materialize_grads=True)
    return {k: v.detach() for k, v in metrics.items()}, tree_unflatten(paths, grads)


def make_train_step(cfg, tcfg):
    """``(state, batch) -> (state, metrics)``; ``state = {params, opt}``.

    The gradient of ``model.loss`` with respect to every parameter, then one
    AdamW step in place.  With ``tcfg.microbatches > 1`` the leading batch
    dimension is split into that many microbatches whose gradients are
    summed in fp32 and divided by their count; the metrics are the last
    microbatch's (the reference's ``lax.scan``).  ``metrics`` are 0-d
    tensors on the state's device: nothing is read back to the host."""
    get_model(cfg)  # an unported family raises here, not at the first step

    def train_step(state, batch):
        mb = tcfg.microbatches
        if mb > 1:
            gsum = None
            for i in range(mb):
                micro = {k: v.reshape((mb, v.shape[0] // mb) + tuple(v.shape[1:]))[i]
                         for k, v in batch.items()}
                metrics, grads = compute_grads(cfg, state["params"], micro)
                flat = [g.float() for _, g in tree_leaves_with_path(grads)]
                if gsum is None:
                    gsum = flat
                else:
                    for a, g in zip(gsum, flat):
                        a.add_(g)
            paths = [p for p, _ in tree_leaves_with_path(state["params"])]
            grads = tree_unflatten(paths, [g / mb for g in gsum])
        else:
            metrics, grads = compute_grads(cfg, state["params"], batch)

        params, opt, opt_metrics = adamw_update(grads, state["opt"], state["params"], tcfg)
        metrics.update(opt_metrics)
        return {"params": params, "opt": opt}, metrics

    return train_step


def init_train_state(cfg, tcfg, generator=None, device="cuda"):
    """``{params, opt}`` on ``device`` (default the CUDA card; raises where
    there is none): parameters from the model's schema drawn from
    ``generator`` (a ``torch.Generator`` on ``device``; seed 0 when None),
    zero AdamW moments in ``tcfg.optimizer_dtype``."""
    device = resolve_device(device)
    params = init_params(get_model(cfg).schema(cfg), generator, cfg.weight_dtype, device)
    return {"params": params, "opt": init_opt_state(params, torch_dtype(tcfg.optimizer_dtype))}


def train_state_shapes(cfg, tcfg):
    """``{params, opt}`` as ``meta`` tensors: the parameters in their
    dtypes, the AdamW moments in ``tcfg.optimizer_dtype``, the int32 step."""
    p_shapes = param_shapes(get_model(cfg).schema(cfg), cfg.weight_dtype)
    mdt = torch_dtype(tcfg.optimizer_dtype)
    mom = tree_map(lambda t: torch.empty(t.shape, dtype=mdt, device="meta"), p_shapes,
                   is_leaf=lambda t: not isinstance(t, dict))
    return {"params": p_shapes,
            "opt": {"m": mom, "v": mom, "step": torch.empty((), dtype=torch.int32,
                                                              device="meta")}}


def train_state_axes(cfg):
    axes = param_axes(get_model(cfg).schema(cfg))
    return {"params": axes, "opt": {"m": axes, "v": axes, "step": ()}}


def batch_axes(cfg, shape_kind: str) -> Dict[str, Tuple]:
    """Logical axes for each batch entry of a ``train``, ``prefill`` or
    ``decode`` step."""
    tok = ("batch", None)
    if shape_kind == "decode":
        return {"tokens": tok}
    if shape_kind == "train":
        out = {"tokens": tok, "targets": tok, "mask": tok}
    elif shape_kind == "prefill":
        out = {"tokens": tok}
    else:
        raise ValueError(shape_kind)
    if cfg.family == "vlm":
        out["frontend"] = ("batch", None, "embed")
    if cfg.family == "encdec":
        out["src"] = ("batch", None, "embed")
    return out


# ----------------------------------------------------------------------
# Serve
# ----------------------------------------------------------------------
def make_prefill_step(cfg):
    model = get_model(cfg)

    @torch.no_grad()
    def prefill_step(params, batch, cache):
        return model.prefill(params, cfg, batch, cache)

    return prefill_step


def make_decode_step(cfg):
    model = get_model(cfg)

    @torch.no_grad()
    def decode_step(params, tokens, cache, pos):
        return model.decode_step(params, cfg, tokens, cache, pos)

    return decode_step


def _cache_schema(cfg, batch: int, max_len: int, enc_len):
    model = get_model(cfg)
    if cfg.family == "encdec":
        if enc_len is None:
            raise ValueError(f"{cfg.name}: an encoder-decoder cache needs enc_len, the "
                             "length of the src its prefill encodes")
        return model.cache_schema(cfg, batch, max_len, enc_len=enc_len)
    if enc_len is not None:
        raise ValueError(f"{cfg.name}: enc_len applies to the encdec family only")
    return model.cache_schema(cfg, batch, max_len)


def init_cache(cfg, batch: int, max_len: int, device=None, *, enc_len=None):
    """A zeroed decode cache from the model's ``cache_schema`` (each leaf
    in the activation dtype), as the reference's ``launch/serve.py`` builds
    it with ``init_params(cache_schema, ...)``, on ``device`` (default the
    CUDA card; raises where there is none).  An encoder-decoder cache holds
    the cross-attention keys and values of exactly ``enc_len`` encoder
    positions, the ``src`` length its prefill must be given."""
    device = resolve_device("cuda" if device is None else device)
    return init_params(_cache_schema(cfg, batch, max_len, enc_len),
                       dtype=cfg.activation_dtype, device=device)


def cache_axes_and_shapes(cfg, batch: int, max_len: int):
    """The cache's logical axes and ``meta`` shapes; an encoder-decoder
    cache is shaped with ``enc_len = max_len``, as the reference's dry-run
    shapes it (a serving cache is sized to its ``src``: :func:`init_cache`)."""
    cs = _cache_schema(cfg, batch, max_len, max_len if cfg.family == "encdec" else None)
    return param_axes(cs), param_shapes(cs, cfg.activation_dtype)
