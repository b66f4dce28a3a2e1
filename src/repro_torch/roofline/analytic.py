"""Analytic per-device traffic: the memory and collective roofline terms —
the port of ``repro.roofline.analytic``.

Byte counts from an eager trace (``trace_cost.bytes_accessed``) count
every unfused elementwise operator and fp32 up-cast once for its reads and
once for its writes, so they over-state device-memory traffic by one to
two orders of magnitude.  This module computes the standard napkin model
instead — weights, optimizer state, KV/SSM cache and residual-stream
carries actually crossing device memory per step — with every tensor
divided by its real shard count (the same shape-aware rules the dry-run
uses).  The roofline report shows both numbers; the bottleneck call uses
this one.

Traffic model (per device, per step):

  train   : microbatches * (2 reads + grad write) of params
            + 4x optimizer state (m,v read+write) + 1x param write
            + 2x saved layer carries (write fwd, read bwd) * microbatches
            + logits io (3x) * microbatches + token io
  prefill : 1x params read + 1x cache write + 2x residual stream
  decode  : 1x params read + 1x cache read (the KV/state scan) + epsilon

Collective bytes (per device, per step; :func:`analytic_collective_bytes`)
stand in for the collectives the reference reads from the compiled HLO —
the port has no partitioner, so nothing is traced: see that function.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

from repro_torch.config import torch_dtype
from repro_torch.distributed import partitioning as pt
from repro_torch.layers.params import tree_leaves
from repro_torch.models.registry import get_model

__all__ = ["sharded_bytes", "analytic_hbm_bytes", "analytic_collective_bytes"]


class _StubMesh:
    """Duck-typed mesh for ``shape_aware_spec``: the axis names and sizes,
    no devices."""

    def __init__(self, sizes: Dict[str, int]):
        self.axis_names = tuple(sizes)
        self.shape = tuple(sizes.values())


def _mesh_sizes(mesh_name: str) -> Dict[str, int]:
    return ({"pod": 2, "data": 16, "model": 16} if mesh_name == "multi_pod"
            else {"data": 16, "model": 16})


def _itemsize(dtype) -> int:
    return torch_dtype(dtype).itemsize


def _shards(spec, mesh_sizes: Dict[str, int]) -> int:
    shards = 1
    for entry in spec:
        if entry is None:
            continue
        for ax in (entry,) if isinstance(entry, str) else entry:
            shards *= mesh_sizes[ax]
    return shards


def sharded_bytes(schema, rules, mesh_sizes: Dict[str, int],
                  default_dtype="float32") -> int:
    """Per-device bytes of a ParamSpec tree under the given rules."""
    mesh = _StubMesh(mesh_sizes)
    total = 0
    for leaf in tree_leaves(schema):
        spec = pt.shape_aware_spec(leaf.axes, leaf.shape, mesh, rules)
        n = math.prod(leaf.shape)
        total += n * _itemsize(leaf.dtype or default_dtype) // _shards(spec, mesh_sizes)
    return total


def _sizes(rec: Dict, mesh_sizes: Optional[Dict[str, int]]) -> Dict[str, int]:
    return dict(mesh_sizes) if mesh_sizes is not None else _mesh_sizes(rec["mesh"])


def analytic_hbm_bytes(rec: Dict, cfg, rules,
                       mesh_sizes: Optional[Dict[str, int]] = None) -> float:
    """Per-device HBM bytes for the recorded cell's step.  ``mesh_sizes``
    (``{axis: size}``) names a mesh other than the record's production
    mesh (``single_pod`` or ``multi_pod``), such as one card's ``(1, 1)``."""
    sizes = _sizes(rec, mesh_sizes)
    schema = get_model(cfg).schema(cfg)
    p_bytes = sharded_bytes(schema, rules, sizes, cfg.weight_dtype)
    devices = math.prod(sizes.values())
    B, S = rec["global_batch"], rec["seq_len"]
    d = cfg.d_model
    act = _itemsize(cfg.dtype)
    dp = max(devices // sizes["model"], 1)
    sp = sizes["model"]  # act_seq sequence-parallel factor

    if rec["kind"] == "train":
        mb = 4 if cfg.fsdp else 1
        mom_bytes = 2 * p_bytes  # m and v, same sharding (dtype ~ param)
        carries = (cfg.num_layers * (B // dp) * S // sp * d * act) // max(mb, 1)
        logits = (B // dp) * S * (cfg.vocab_size // sizes["model"]) * act
        return (
            mb * 2 * p_bytes  # fwd + remat-fwd reads (bwd reuses)
            + p_bytes  # grad write
            + p_bytes + 2 * mom_bytes  # optimizer read+write
            + mb * 2 * carries
            + 3 * logits
        )
    if rec["kind"] == "prefill":
        cache = _cache_bytes(cfg, rec, sizes)
        stream = 2 * cfg.num_layers * (B // dp) * (S // sp) * d * act
        return p_bytes + cache + stream
    # decode
    cache = _cache_bytes(cfg, rec, sizes)
    return p_bytes + cache


def _cache_bytes(cfg, rec, sizes) -> int:
    from repro_torch.distributed.steps import cache_axes_and_shapes

    axes_tree, shapes_tree = cache_axes_and_shapes(
        cfg, rec["global_batch"], rec["seq_len"]
    )
    mesh = _StubMesh(sizes)
    # rules for cache include kv_seq sharding on long decode
    rules = dict(pt.BASE_RULES)
    if rec["shape"] == "long_500k":
        rules = pt.long_context_rules(rules)
    total = 0
    for axes, sds in zip(tree_leaves(axes_tree), tree_leaves(shapes_tree)):
        spec = pt.shape_aware_spec(axes, sds.shape, mesh, rules)
        total += math.prod(sds.shape) * sds.dtype.itemsize // _shards(spec, sizes)
    return total


def analytic_collective_bytes(rec: Dict, cfg, rules,
                              mesh_sizes: Optional[Dict[str, int]] = None) -> Dict[str, float]:
    """Per-device collective bytes of the recorded cell's step, by type
    (the reference's HLO opcode names), in the napkin style of
    :func:`analytic_hbm_bytes`.  The reference reads these bytes from the
    compiled HLO (``hlo_parse``: operand sizes of every collective); the
    port has no partitioner and moves nothing between devices in a traced
    step, so it models the three collectives a data- and tensor-parallel
    step makes, each as the bytes one device sends (a ring moves
    ``2 (n - 1) / n`` of an all-reduce's buffer and ``(n - 1) / n`` of an
    all-gather's result through every device):

    * ``all-reduce``, gradients (train): the DP mean of the per-device
      gradient bytes (the parameters' bytes as sharded) over the ``dp =
      devices / model`` data-parallel devices, ``2 (dp - 1) / dp`` of them;
    * ``all-gather``, FSDP weights (train under ``fsdp_rules``, where
      ``embed`` shards over ``data``): every microbatch gathers the
      weights for its forward and again for its backward, ``(data - 1)``
      shards of the per-device parameter bytes each time.  The microbatch
      count is the record's ``microbatches``: ``run_cell`` writes the one
      the step was traced with (``dryrun_lib._train_tcfg``);
    * ``all-reduce``, activations: two a layer on the ``model`` axis (after
      the attention out-projection and after the MLP's down-projection, as
      Megatron-style tensor parallelism places them), each of one
      device's ``(B / dp, S, d_model)`` residual stream, ``2 (m - 1) / m``
      of it; a train step makes them in the forward and again in the
      backward.  Decode's stream is one token.

    Returns ``{"all-reduce": bytes, "all-gather": bytes}`` (zero entries
    dropped); their sum is the record's ``collective_bytes``."""
    sizes = _sizes(rec, mesh_sizes)
    devices = math.prod(sizes.values())
    m = sizes.get("model", 1)
    dp = max(devices // m, 1)
    B, S = rec["global_batch"], rec["seq_len"]
    p_bytes = sharded_bytes(get_model(cfg).schema(cfg), rules, sizes, cfg.weight_dtype)
    out = {"all-reduce": 0.0, "all-gather": 0.0}
    passes = 1
    if rec["kind"] == "train":
        passes = 2
        out["all-reduce"] += 2 * (dp - 1) / dp * p_bytes
        if rules.get("embed") == "data":
            gathers = rec["microbatches"] * 2
            out["all-gather"] += gathers * (sizes.get("data", 1) - 1) * p_bytes
    tokens = (B // dp if B % dp == 0 else B) * (1 if rec["kind"] == "decode" else S)
    stream = tokens * cfg.d_model * _itemsize(cfg.dtype)
    layers = cfg.num_layers + cfg.encoder_layers
    out["all-reduce"] += passes * 2 * layers * 2 * (m - 1) / m * stream
    return {k: v for k, v in out.items() if v}
