"""Static plan verification: prove an :class:`~repro_torch.engine.plan.SRPlan`'s
geometry before anything is built or launched.

Invariant families, each reported as :class:`Finding`\\ s:

* **Band coverage** — the bands partition the frame height exactly
  (``num_bands * band_rows == height``); a gap or overlap would corrupt
  the output silently.
* **Halo sufficiency** — for the ``halo`` vertical policy, the slab
  margin provided by ``core.fusion.halo_slabs`` must cover the
  receptive-field growth of the fused stack: L stacked 3x3 convs grow
  the field by exactly one row per side per layer, so the margin must be
  ``>= num_layers``.  The provided margin is *measured* from the
  ``halo_slabs`` geometry itself, not restated here.
* **Shards** — band-sharded serving (``band_shards=``): whole bands per
  device, and under ``halo`` a shard-edge margin that covers the stack.
  Pure geometry; nothing here needs more than one device.
* **Schedule** — the tilted sweep's hand-off invariants.
* **On-chip budget** — two rules, which is where this module departs from
  the JAX package's ``analysis/plan_check.py``:

  - On the ``kernel`` backend, an **error** when K1's shared memory per
    CTA exceeds :data:`SMEM_PER_BLOCK_BYTES` (227 KB, the H100's opt-in
    limit of one CTA): the launch would fail.  K1
    (``kernels.tilted_fusion.kernel_buffers``) keeps a tile's two feature
    maps in shared memory where they fit (its on-chip route: ABPN's 60-
    and 74-row bands; 190,624 bytes at Chp = 32, R = 60 in fp32 and int8,
    95,392 in bf16), beside one stage of one layer's packed weights, and
    its overlap queue in device memory.  A taller band takes
    the device-memory route, whose slabs are per-CTA workspace in device
    memory and whose shared memory (two stages and two input windows of
    320 pixels: 229,632 bytes at Chp = 32 in fp32, 78,080 in bf16) does
    not depend on R.  So R picks the route and never fails the launch.
    The reference instead makes a past-budget R an error, because its
    Pallas kernel's VMEM scratch grows with R.  Fewer resident CTAs per SM than the build's
    ``__launch_bounds__`` ask for would only lower occupancy, so it is no
    error.  K2 is not checked: no banded plan launches it, and its shared
    memory depends only on the precision (at most 204,544 B, fp32 per tap).
  - On both banded backends, a **warning** when K1's per-CTA working set
    in the paper's units (one byte an element: the two ping-pong maps or
    slabs, the overlap queue, the shared-memory weight stages and, on the
    device-memory route, the two input windows) exceeds
    Table II's 102.36 KB by more than :data:`BUDGET_TOLERANCE`.  Advisory:
    the queue (and on the device-memory route the slabs) live in device
    memory (cached in L1/L2), not
    in a fixed SRAM.  So a ``kernel`` plan at ``band_rows=120`` warns and
    does not fail.

``verify_plan`` accepts any *plan-like* object (the ``SRPlan`` field
names, duck-typed) so tests can probe deliberately-illegal geometry that
``SRPlan.__post_init__`` would reject at construction.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

from repro_torch.analysis.findings import Finding
from repro_torch.core import analysis as core_analysis

__all__ = [
    "verify_plan",
    "verify_delta_cover",
    "table2_crosscheck",
    "measured_halo_margin",
    "required_halo_margin",
    "plan_buffer_report",
    "BUDGET_TOLERANCE",
    "TABLE2_TOTAL_KB",
    "BANDED_BACKENDS",
    "SMEM_PER_BLOCK_BYTES",
]

# Table II bottom line (decimal KB) — the ASIC's fixed on-chip allocation.
TABLE2_TOTAL_KB = core_analysis.PAPER_TABLE2["tilted"]["total"]

# Headroom over the Table II budget before the advisory warning: K1 pads
# channels to Chp (28 -> 32) and its slabs carry two extra columns per tile.
# At the paper's design point its per-CTA working set is 0.82x the budget.
BUDGET_TOLERANCE = 0.30

BANDED_BACKENDS = ("tilted", "kernel")

# The most shared memory one CTA may opt in to on an H100 (compute
# capability 9.0).
SMEM_PER_BLOCK_BYTES = 227 * 1024

# Table II counts one byte per element (the int8 ASIC convention).
_PAPER_BYTES_PER_ELEM = 1


def required_halo_margin(num_layers: int) -> int:
    """Receptive-field growth of ``num_layers`` stacked 3x3 convs: one row
    per side per layer."""
    return int(num_layers)


def measured_halo_margin(band_rows: int, num_layers: int) -> int:
    """The halo margin ``core.fusion.halo_slabs`` ACTUALLY provides,
    measured from the geometry it returns for a one-band probe frame."""
    import torch

    from repro_torch.core.fusion import halo_slabs

    probe = torch.zeros((1, int(band_rows), 1, 1))
    slabs, _bounds = halo_slabs(probe, int(band_rows), int(num_layers))
    return (int(slabs.shape[1]) - int(band_rows)) // 2


def _default_channels(plan) -> List[int]:
    """Feature-map channels F_0..F_L for the budget check.  ABPN's stack
    when the plan matches the paper's geometry; otherwise a conservative
    estimate (hidden width = the pixel-shuffle output width)."""
    abpn = core_analysis.ABPN_CHANNELS
    if plan.num_layers == len(abpn) - 1 and plan.in_channels == abpn[0]:
        # ABPN's last layer has in_channels * scale^2 outputs (x4: 48)
        return list(abpn[:-1]) + [plan.in_channels * plan.scale * plan.scale]
    hidden = max(plan.in_channels * plan.scale * plan.scale, plan.in_channels)
    return [plan.in_channels] + [hidden] * plan.num_layers


def _k1_table2_elements(report: dict) -> int:
    """K1's per-CTA working set in elements: the two ping-pong maps (in
    shared memory on the on-chip route, with their carried columns) or
    slabs (in device memory) and the overlap queue, and in shared memory
    the weight stages (one on the on-chip route, else two) and, on the
    device-memory route, the two input windows, all at the hidden
    width (a mixed launch's last layer stages one output group of at most
    32 at a time)."""
    chp = report["hidden_chp"]
    buffers = report["buffers"]
    onchip = report["route"] == "onchip"
    stages = 1 if onchip else 2
    return (buffers["slabs"]["elements"] + buffers["overlap"]["elements"]
            + stages * 9 * chp * chp + (0 if onchip else 2 * report["window_elements"]))


def plan_buffer_report(plan, channels: Optional[Sequence[int]] = None) -> dict:
    """K1's own accounting for this plan's geometry:
    :func:`~repro_torch.kernels.tilted_fusion.kernel_buffers` (per CTA, and
    for a launch over the frame's bands, with its ``shared_bytes``) and its
    per-CTA working set in elements (``table2_elements``)."""
    import torch

    from repro_torch.kernels.tilted_fusion import kernel_buffers

    chans = list(channels) if channels else _default_channels(plan)
    # bf16 computes in bf16; fp32 and int8 (dequantised) in fp32
    dtype = torch.bfloat16 if plan.precision == "bf16" else torch.float32
    report = kernel_buffers(channels=chans, band_rows=plan.band_rows,
                            tile_cols=plan.tile_cols, bands=plan.num_bands, dtype=dtype)
    report["table2_elements"] = _k1_table2_elements(report)
    return report


def _check_band_coverage(plan, findings: List[Finding], where: str) -> None:
    if plan.backend == "reference":
        return  # full-image path: no bands to cover
    bands, rem = divmod(plan.height, plan.band_rows)
    if rem != 0 or bands < 1:
        findings.append(Finding(
            checker="plan",
            rule="band_coverage",
            severity="error",
            message=(
                f"{bands} bands of {plan.band_rows} rows cover "
                f"{bands * plan.band_rows} of {plan.height} frame rows — "
                f"{rem} rows would be dropped; bands must partition the "
                "height exactly"
            ),
            where=where,
        ))
    if getattr(plan, "degenerate_bands", False):
        findings.append(Finding(
            checker="plan",
            rule="degenerate_bands",
            severity="warning",
            message=(
                f"height {plan.height} had no legal band decomposition and "
                f"fell back to ONE {plan.band_rows}-row band — banded "
                "backends lose streaming locality at this height"
            ),
            where=where,
        ))


def _check_halo(plan, findings: List[Finding], where: str,
                halo_margin: Optional[int]) -> None:
    if plan.vertical_policy != "halo" or plan.backend == "reference":
        return
    need = required_halo_margin(plan.num_layers)
    have = (int(halo_margin) if halo_margin is not None
            else measured_halo_margin(plan.band_rows, plan.num_layers))
    if have < need:
        findings.append(Finding(
            checker="plan",
            rule="halo_sufficiency",
            severity="error",
            message=(
                f"halo slab provides {have} margin rows per side but "
                f"{plan.num_layers} stacked 3x3 layers grow the receptive "
                f"field by {need} rows per side — band boundaries would "
                "read stale/phantom rows"
            ),
            where=where,
        ))


def _check_shards(plan, findings: List[Finding], where: str,
                  band_shards: Optional[int],
                  shard_halo_margin: Optional[int]) -> None:
    """Band-sharded serving invariants.

    A shard boundary is a band boundary that additionally crosses devices:
    the bands must split into equal per-device blocks, and under the
    ``halo`` policy the exchanged shard-edge margin must still cover the
    stack's receptive-field growth (L rows per side) — a short exchange
    would read stale rows from the neighbour shard, silently, because the
    in-shard bands still validate.
    """
    if not band_shards or int(band_shards) <= 1:
        return
    band_shards = int(band_shards)
    if plan.backend == "reference":
        findings.append(Finding(
            checker="plan",
            rule="shard_backend",
            severity="error",
            message=(
                "reference backend computes over the full frame and "
                f"cannot band-shard {band_shards} ways — use the tilted "
                "or kernel backend"
            ),
            where=where,
        ))
        return
    bands, rem = divmod(plan.height, plan.band_rows)
    if rem != 0:
        return  # band_coverage already reported the broken geometry
    if bands % band_shards != 0:
        findings.append(Finding(
            checker="plan",
            rule="shard_band_alignment",
            severity="error",
            message=(
                f"{bands} bands do not split into {band_shards} equal "
                "shards — each device must own whole bands "
                f"(height {plan.height}, band_rows {plan.band_rows})"
            ),
            where=where,
        ))
        return
    if plan.vertical_policy != "halo":
        return  # zero/replicate bands are independent: no shard coupling
    need = required_halo_margin(plan.num_layers)
    have = (int(shard_halo_margin) if shard_halo_margin is not None
            else measured_halo_margin(plan.band_rows, plan.num_layers))
    if have < need:
        findings.append(Finding(
            checker="plan",
            rule="shard_halo_sufficiency",
            severity="error",
            message=(
                f"shard edges exchange {have} margin rows per side but "
                f"{plan.num_layers} stacked 3x3 layers need {need} — "
                "bands at device boundaries would read stale neighbour "
                "rows"
            ),
            where=where,
        ))


def _check_schedule(plan, findings: List[Finding], where: str) -> None:
    try:
        plan.check_invariants()
    except Exception as exc:  # surfaced as a finding, not a crash
        findings.append(Finding(
            checker="plan",
            rule="tile_handoff",
            severity="error",
            message=f"tilted schedule invariants failed: {exc}",
            where=where,
        ))


def _check_shared_memory(plan, report: dict, findings: List[Finding], where: str) -> None:
    """The hard rules of the ``kernel`` backend: an instance of K1 covers
    the stack's channels (Chp at most 128), its shared memory fits one
    CTA, and a 3-row window of the plan's tile width fits the instance's
    window.  A mixed launch runs on its hidden width's instance."""
    from repro_torch.kernels.tilted_fusion import SUPPORTED_CHP

    if report["instance"] is None:
        findings.append(Finding(
            checker="plan",
            rule="on_chip_budget",
            severity="error",
            message=(
                f"tilted_fusion has no instance for Chp {report['packed_chp']}: its "
                f"instances are Chp {', '.join(map(str, SUPPORTED_CHP))}, and a stack "
                f"wider than {SUPPORTED_CHP[-1]} channels is not launched; the launch would fail"
            ),
            where=where,
        ))
        return
    instance = report["hidden_chp"]
    if instance != report["chp"]:
        instance = f"{instance} -> {report['chp']} outputs"
    widest = report["max_tile_cols"]
    if plan.tile_cols > widest:
        findings.append(Finding(
            checker="plan",
            rule="on_chip_budget",
            severity="error",
            message=(
                f"tilted_fusion <{plan.precision}, chp {instance}> takes tile_cols <= "
                f"{widest}: a row block's {report['window_pixels']}-pixel window holds no "
                f"3 x {plan.tile_cols + 2} window of tile_cols={plan.tile_cols}; the launch "
                "would fail"
            ),
            where=where,
        ))
    per_cta = report["shared_bytes"]
    if per_cta > SMEM_PER_BLOCK_BYTES:
        findings.append(Finding(
            checker="plan",
            rule="on_chip_budget",
            severity="error",
            message=(
                f"tilted_fusion <{plan.precision}, chp {instance}> needs "
                f"{per_cta} B of shared memory per CTA — over the H100's "
                f"{SMEM_PER_BLOCK_BYTES} B limit of one CTA; the launch would fail"
            ),
            where=where,
        ))


def _check_budget(plan, findings: List[Finding], where: str,
                  channels: Optional[Sequence[int]],
                  budget_kb: Optional[float]) -> None:
    if plan.backend not in BANDED_BACKENDS:
        return
    report = plan_buffer_report(plan, channels)
    if plan.backend == "kernel":
        _check_shared_memory(plan, report, findings, where)
    budget = (float(budget_kb) if budget_kb is not None
              else core_analysis.on_chip_budget_kb())
    padded_kb = report["table2_elements"] * _PAPER_BYTES_PER_ELEM / 1000.0
    limit = budget * (1.0 + BUDGET_TOLERANCE)
    if padded_kb > limit:
        findings.append(Finding(
            checker="plan",
            rule="on_chip_budget",
            severity="warning",
            message=(
                f"K1's per-CTA working set is {padded_kb:.2f} KB at "
                f"band_rows={plan.band_rows} — over the {budget:.2f} KB "
                f"Table II budget by more than the documented "
                f"{BUDGET_TOLERANCE:.0%} padding tolerance "
                f"(limit {limit:.2f} KB); advisory: "
                + ("its feature maps live in shared memory and its overlap queue in "
                   "device memory" if report["route"] == "onchip" else
                   "its slabs and overlap queue live in device memory")
            ),
            where=where,
        ))


def verify_plan(
    plan,
    *,
    channels: Optional[Sequence[int]] = None,
    budget_kb: Optional[float] = None,
    halo_margin: Optional[int] = None,
    band_shards: Optional[int] = None,
    shard_halo_margin: Optional[int] = None,
) -> List[Finding]:
    """Statically verify a plan-like object; returns all findings (possibly
    empty).  ``channels`` supplies the model's real feature-map widths for
    the budget checks (defaults to ABPN when the geometry matches);
    ``budget_kb`` and ``halo_margin`` override the Table II budget and the
    measured slab margin — test hooks for probing illegal geometry.
    ``band_shards`` (> 1) additionally verifies band-sharded serving:
    shard alignment and shard-edge halo sufficiency
    (``shard_halo_margin`` overrides the exchanged margin the same way
    ``halo_margin`` does in-shard).
    """
    findings: List[Finding] = []
    where = (
        f"plan {plan.backend}/{plan.precision} "
        f"{plan.height}x{plan.width} R={plan.band_rows} C={plan.tile_cols} "
        f"{plan.vertical_policy}"
    )
    if band_shards and int(band_shards) > 1:
        where += f" shards={int(band_shards)}"
    _check_band_coverage(plan, findings, where)
    _check_halo(plan, findings, where, halo_margin)
    _check_shards(plan, findings, where, band_shards, shard_halo_margin)
    _check_schedule(plan, findings, where)
    _check_budget(plan, findings, where, channels, budget_kb)
    return findings


def table2_crosscheck(
    channels: Optional[Sequence[int]] = None,
    band_rows: int = 60,
    tile_cols: int = 8,
) -> dict:
    """Cross-check K1's buffer accounting against the analytical Table II
    model (``core.analysis.buffer_sizes``), under the JAX package's keys.

    Returns, in decimal KB at the paper's 1-byte-per-element convention:

    * ``model_*_kb`` — the analytical model, as the JAX package computes
      it (L overlap slots, one per fused layer, vs the RTL's L+2).
    * ``kernel_overlap_kb`` / ``kernel_weight_kb`` — K1's *logical*
      (unpadded) element counts for its overlap queue and the weights and
      bias it reads.  They equal the model exactly.
    * ``kernel_residual_kb`` — ``None``: K1 has no residual ring.  It reads
      the anchor columns from the input stream, which stays in device
      memory, so there is no buffer to count.
    * ``kernel_padded_total_kb`` — K1's per-CTA working set: the two
      ping-pong maps (or slabs) and the overlap queue at padded channels,
      plus the shared-memory weight stages and, on the device-memory route,
      the two input windows (93.70 KB at the design point in fp32, where
      the maps stay on chip);
      ``budget_ratio`` = that over the
      Table II total, bounded by ``1 + BUDGET_TOLERANCE`` at the design
      point.
    """
    from repro_torch.kernels.tilted_fusion import kernel_buffers

    channels = list(channels) if channels else list(core_analysis.ABPN_CHANNELS)
    L = len(channels) - 1
    report = kernel_buffers(channels=channels, band_rows=band_rows, tile_cols=tile_cols)
    cfg = core_analysis.HWConfig(
        band_rows=band_rows,
        tile_cols=tile_cols,
        channels=tuple(channels),
        bytes_per_elem=_PAPER_BYTES_PER_ELEM,
        overlap_queue_slots=L,
    )
    model = core_analysis.buffer_sizes(cfg)
    buf = report["buffers"]
    kernel_weight = buf["weights"]["logical_elements"] + buf["bias"]["logical_elements"]
    padded_total_kb = _k1_table2_elements(report) * _PAPER_BYTES_PER_ELEM / 1000.0
    return {
        "kernel_overlap_kb": buf["overlap"]["logical_elements"] / 1000.0,
        "model_overlap_kb": model["overlap_kb"],
        "kernel_residual_kb": None,
        "model_residual_kb": model["residual_kb"],
        "kernel_weight_kb": kernel_weight / 1000.0,
        "model_weight_kb": model["weight_kb"],
        "kernel_padded_total_kb": padded_total_kb,
        "table2_total_kb": TABLE2_TOTAL_KB,
        "budget_ratio": padded_total_kb / TABLE2_TOTAL_KB,
        "tolerance": BUDGET_TOLERANCE,
    }


def verify_delta_cover(plan, dirty_bands, changed_bands=None) -> List[Finding]:
    """Verify a temporal delta step's splice invariant for ``plan``.

    The delta path serves ``dirty_bands`` fresh and splices every other
    band from the output cache; the HR frame is correct iff the two sets
    partition the output rows AND the dirty set is at least the
    halo-reach dilation of the bands whose content actually changed.
    Error-level rules:

    * ``delta_cover`` — every dirty index in range, no duplicates, and
      dirty + spliced bands account for every output row exactly once.
    * ``delta_dilation`` — for each changed band, every band within the
      halo reach (``ceil(L / R)`` under ``halo``, 0 otherwise — the
      ``core.fusion.halo_slabs`` receptive-field geometry) is dirty.  A
      clean band inside the reach would splice stale rows.

    ``changed_bands=None`` skips the dilation rule.  Returns findings;
    empty = valid.
    """
    from repro_torch.engine.temporal.band_diff import halo_reach

    findings: List[Finding] = []
    where = (
        f"delta {plan.backend}/{plan.vertical_policy} "
        f"{plan.height}x{plan.width} R={plan.band_rows}"
    )
    num_bands = plan.height // plan.band_rows
    dirty = [int(b) for b in dirty_bands]
    bad = [b for b in dirty if not 0 <= b < num_bands]
    dirty_set = set(dirty)
    if bad or len(dirty_set) != len(dirty):
        findings.append(Finding(
            checker="plan",
            rule="delta_cover",
            severity="error",
            message=(
                f"dirty band set {sorted(dirty)} is not a valid subset of "
                f"[0, {num_bands}): out-of-range {sorted(set(bad))}, "
                f"{len(dirty) - len(dirty_set)} duplicate(s)"
            ),
            where=where,
        ))
        return findings
    spliced = num_bands - len(dirty_set)
    covered_rows = (len(dirty_set) + spliced) * plan.band_rows
    if covered_rows != plan.height:
        findings.append(Finding(
            checker="plan",
            rule="delta_cover",
            severity="error",
            message=(
                f"{len(dirty_set)} dirty + {spliced} spliced bands of "
                f"{plan.band_rows} rows cover {covered_rows} of "
                f"{plan.height} output rows — the splice would drop or "
                "double-write rows"
            ),
            where=where,
        ))
    if changed_bands is not None:
        reach = halo_reach(plan.band_rows, plan.num_layers, plan.vertical_policy)
        missing = set()
        for c in changed_bands:
            c = int(c)
            if c not in dirty_set:
                missing.add(c)
            lo = max(0, c - reach)
            hi = min(num_bands, c + reach + 1)
            missing.update(b for b in range(lo, hi) if b not in dirty_set)
        if missing:
            findings.append(Finding(
                checker="plan",
                rule="delta_dilation",
                severity="error",
                message=(
                    f"changed bands {sorted(int(c) for c in changed_bands)} "
                    f"require dirty coverage within halo reach {reach}, but "
                    f"bands {sorted(missing)} are not dirty — their cached "
                    "output depends on rows that changed"
                ),
                where=where,
            ))
    return findings
