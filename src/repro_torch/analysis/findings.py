"""Structured diagnostics shared by the static checkers.

Every checker reports ``Finding`` records instead of raising ad hoc, so
callers (the temporal delta path's splice check today; the CLI, CI gate
and ``SRSession(strict=True)`` once the rest of the analysis package is
ported) all consume one shape.

Severity contract:
  * ``error``   — a proven invariant violation; CI fails, strict sessions
    raise ``PlanVerificationError``.
  * ``warning`` — legal but suspicious (degenerate band fallback, a
    kernel's buffers over their budget, rebuilds).
  * ``info``    — observations useful in reports.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Sequence, Tuple

__all__ = [
    "SEVERITIES",
    "Finding",
    "PlanVerificationError",
    "count_by_severity",
    "count_by_checker",
    "errors",
    "format_findings",
]

SEVERITIES: Tuple[str, ...] = ("error", "warning", "info")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One diagnostic from a static checker.

    ``checker`` names the pass (``plan`` | ``program`` | ``concurrency``),
    ``rule`` the specific invariant (e.g. ``band_coverage``,
    ``quant_in_hot_path``, ``await_under_lock``), ``where`` the subject
    (a plan repr, cache key, or ``file:line``).
    """

    checker: str
    rule: str
    severity: str
    message: str
    where: str = ""

    def __post_init__(self) -> None:
        if self.severity not in SEVERITIES:
            raise ValueError(
                f"severity {self.severity!r} not in {SEVERITIES}"
            )

    def format(self) -> str:
        loc = f" [{self.where}]" if self.where else ""
        return f"{self.severity.upper():7s} {self.checker}.{self.rule}{loc}: {self.message}"


class PlanVerificationError(ValueError):
    """Raised by strict-mode plan verification; carries the findings."""

    def __init__(self, findings: Sequence[Finding]):
        self.findings: List[Finding] = list(findings)
        super().__init__(
            "plan verification failed:\n"
            + "\n".join(f.format() for f in self.findings)
        )


def errors(findings: Iterable[Finding]) -> List[Finding]:
    return [f for f in findings if f.severity == "error"]


def count_by_severity(findings: Iterable[Finding]) -> Dict[str, int]:
    counts = {s: 0 for s in SEVERITIES}
    for f in findings:
        counts[f.severity] += 1
    return counts


def count_by_checker(findings: Iterable[Finding]) -> Dict[str, Dict[str, int]]:
    out: Dict[str, Dict[str, int]] = {}
    for f in findings:
        out.setdefault(f.checker, {s: 0 for s in SEVERITIES})[f.severity] += 1
    return out


def format_findings(findings: Sequence[Finding], *, header: str = "") -> str:
    lines = [header] if header else []
    if not findings:
        lines.append("  (clean)")
    lines.extend("  " + f.format() for f in findings)
    return "\n".join(lines)
