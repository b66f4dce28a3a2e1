"""repro_torch.analysis — the static-analysis subsystem (CI gate).

Three checkers, one shape of diagnostic (:class:`Finding`), one front door
(``python -m repro_torch.analysis``):

* :mod:`~repro_torch.analysis.plan_check` — prove an ``SRPlan``'s geometry:
  band coverage, halo sufficiency vs receptive-field growth, band shards,
  the Hopper kernels' shared memory against the H100's limits, and K1's
  working set against the paper's Table II budget (advisory); plus the
  temporal delta path's splice rule.  Wired into ``SRPlan.verify()`` and
  ``SRSession(..., strict=True)``.
* :mod:`~repro_torch.analysis.program_audit` — scan what one serving call
  runs (its aten ops; on the card, the profiler's kernels, copies and
  synchronizing runtime calls; the kernel builds it triggered) for quant
  ops in the hot path, host transfers and waits, silent fp32 upcasts,
  builds, an ignored donation and rebuilds.
* :mod:`~repro_torch.analysis.concurrency_lint` — AST lint of the serving
  sources for blocking calls / ``await`` under a held lock, lock-order
  cycles and wall-clock reads.

The engine imports this package lazily (never the reverse at import time).
"""

from repro_torch.analysis.findings import (
    SEVERITIES,
    Finding,
    PlanVerificationError,
    count_by_checker,
    count_by_severity,
    errors,
    format_findings,
)

__all__ = [
    "Finding",
    "PlanVerificationError",
    "SEVERITIES",
    "count_by_checker",
    "count_by_severity",
    "errors",
    "format_findings",
]
