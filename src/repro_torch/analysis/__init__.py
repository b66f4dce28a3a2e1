"""repro_torch.analysis — static checks reported as :class:`Finding`\\ s.

Ported so far: the diagnostic record (:mod:`~repro_torch.analysis.findings`)
and the temporal delta path's splice rule
(:func:`~repro_torch.analysis.plan_check.verify_delta_cover`).  The plan,
program and concurrency checkers wait for ROADMAP queue 1, item 12.

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
