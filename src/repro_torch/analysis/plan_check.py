"""Static plan verification, reported as :class:`Finding`\\ s.

Holds the temporal delta path's splice rule, :func:`verify_delta_cover`,
which ``engine.temporal.DeltaSession`` enforces before every partial-band
dispatch.  The plan geometry and on-chip budget checkers of the JAX
package's ``analysis/plan_check.py`` are not ported yet (ROADMAP queue 1,
item 12).
"""

from __future__ import annotations

from typing import List

from repro_torch.analysis.findings import Finding

__all__ = ["verify_delta_cover"]


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
