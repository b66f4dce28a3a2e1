"""Analytic MODEL_FLOPS: 6*N*D (dense) / 6*N_active*D (MoE) — the port of
``repro.roofline.model_flops``.

The "useful work" yardstick for the §Roofline ratio
``MODEL_FLOPS / counted FLOPs`` — anything the traced program computes
above this is remat recompute, masked-out attention waste (the flash loop
visits every KV chunk), or padding.
"""

from __future__ import annotations

from typing import Tuple

from repro_torch.layers.params import tree_leaves
from repro_torch.models.registry import get_model

__all__ = ["active_params", "model_flops"]


def active_params(cfg) -> Tuple[int, int]:
    """(total, active-per-token) parameter counts from the schema.

    Expert-stacked leaves (axes containing 'expert') contribute
    ``k / E`` of their size to the active count; everything else is fully
    active.  Embedding lookups are counted (they feed the residual stream);
    the unembedding matmul is part of every token's compute.
    """
    schema = get_model(cfg).schema(cfg)
    total = active = 0
    k_over_e = (
        cfg.experts_per_token / cfg.num_experts if cfg.is_moe else 1.0
    )
    for leaf in tree_leaves(schema):
        n = 1
        for d in leaf.shape:
            n *= d
        total += n
        if "expert" in leaf.axes:
            active += int(n * k_over_e)
        else:
            active += n
    return total, active


def model_flops(cfg, kind: str, global_batch: int, seq_len: int) -> float:
    """GLOBAL useful FLOPs for one step of the given kind.

    train   : 6 * N_active * (B*S)   (fwd 2ND + bwd 4ND, the MFU convention)
    prefill : 2 * N_active * (B*S)
    decode  : 2 * N_active * B       (one token per sequence)

    Attention's O(S^2) score FLOPs are intentionally excluded (standard
    6ND accounting) — they surface in the ratio as "non-model" compute.
    """
    _, n_active = active_params(cfg)
    if kind == "train":
        return 6.0 * n_active * global_batch * seq_len
    if kind == "prefill":
        return 2.0 * n_active * global_batch * seq_len
    if kind == "decode":
        return 2.0 * n_active * global_batch
    raise ValueError(kind)
