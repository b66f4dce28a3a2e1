"""Step-function factories for serving: prefill and decode — the serving
half of ``repro.distributed.steps``.

The closures run eagerly under ``torch.no_grad``; the reference jits them
and donates the cache, and here the cache is written in place (see
``layers.attention``), so a caller passes each step the cache the previous
step returned and never reuses an older one.  The train half
(``make_train_step``, the train-state trees) comes with the LM training
slice (ROADMAP queue 1, item 14c), the logical-axis trees for shardings
with the dry-run slice (item 14g).
"""

from __future__ import annotations

import torch

from repro_torch.layers.params import init_params
from repro_torch.models.registry import get_model

__all__ = ["make_prefill_step", "make_decode_step", "init_cache"]


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


def init_cache(cfg, batch: int, max_len: int, device="cpu"):
    """A zeroed decode cache on ``device`` from the model's
    ``cache_schema`` (each leaf in the activation dtype), as the reference's
    ``launch/serve.py`` builds it with ``init_params(cache_schema, ...)``."""
    cs = get_model(cfg).cache_schema(cfg, batch, max_len)
    return init_params(cs, dtype=cfg.activation_dtype, device=device)
