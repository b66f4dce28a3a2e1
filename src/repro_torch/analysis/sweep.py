"""Representative repo-wide sweeps for the static checkers.

This is what ``python -m repro_torch.analysis`` runs:

* :func:`sweep_lint` — the concurrency lint over the port's serving
  sources.
* :func:`sweep_plans` — static plan verification across the full
  backend x vertical-policy x precision grid at the paper's design point
  (ABPN, 360-row frames, 60-row bands) — nothing is built.
* :func:`sweep_programs` — open small representative sessions
  (``autotune="off"`` so no tuning DB is read) on a device, serve one
  frame each, and audit every cached executor: the JAX package's
  configurations (tilted fp32/bf16/int8 and the reference oracle), and on
  the card also the ``kernel`` backend in fp32/bf16/int8 under ``zero`` and
  in fp32/bf16 under ``halo``, where K1 runs.  On the card each session's
  server launch is audited too (:func:`program_audit.audit_server`).

:func:`analysis_report` bundles the outcome as per-checker severity
counts plus a ``clean`` verdict.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from repro_torch.analysis import concurrency_lint, plan_check, program_audit
from repro_torch.analysis.findings import Finding, count_by_severity, errors

__all__ = [
    "sweep_lint",
    "sweep_plans",
    "sweep_programs",
    "analysis_report",
    "PLAN_SWEEP_SHAPE",
    "PROGRAM_SWEEP_SHAPE",
    "PROGRAM_SWEEP_CONFIGS",
    "CARD_SWEEP_CONFIGS",
]

# The paper's design point: 360-row frames in 60-row bands.
PLAN_SWEEP_SHAPE: Tuple[int, int, int] = (360, 640, 3)

# Small enough to serve everywhere in seconds (one 24-row band); the audit
# rules are shape-independent.
PROGRAM_SWEEP_SHAPE: Tuple[int, int, int] = (24, 16, 3)

# (backend, precision, vertical policy) grid the program sweep serves on
# every device (the JAX package's PROGRAM_SWEEP_CONFIGS, under its default
# policy).
PROGRAM_SWEEP_CONFIGS: Tuple[Tuple[str, str, str], ...] = (
    ("tilted", "fp32", "zero"),
    ("tilted", "bf16", "zero"),
    ("tilted", "int8", "zero"),
    ("reference", "fp32", "zero"),
)

# Added on the card: the kernel backend, where K1 runs and where the rule
# against host waits matters; ``halo`` builds its band slabs and bounds on
# the device, the one policy where a host copy could come back.
CARD_SWEEP_CONFIGS: Tuple[Tuple[str, str, str], ...] = (
    ("kernel", "fp32", "zero"),
    ("kernel", "bf16", "zero"),
    ("kernel", "int8", "zero"),
    ("kernel", "fp32", "halo"),
    ("kernel", "bf16", "halo"),
)


def sweep_lint() -> List[Finding]:
    """Concurrency-lint the port's serving sources."""
    return concurrency_lint.lint_files()


def sweep_plans(lr_shape: Tuple[int, int, int] = PLAN_SWEEP_SHAPE) -> List[Finding]:
    """Statically verify the full legal plan grid at the design point."""
    from repro_torch.engine.plan import BACKENDS, PRECISIONS, VERTICAL_POLICIES, SRPlan

    findings: List[Finding] = []
    for backend in BACKENDS:
        for policy in VERTICAL_POLICIES:
            for precision in PRECISIONS:
                plan = SRPlan.from_request(
                    lr_shape,
                    num_layers=7,
                    backend=backend,
                    vertical_policy=policy,
                    precision=precision,
                )
                findings.extend(plan_check.verify_plan(plan))
    return findings


def sweep_programs(
    lr_shape: Tuple[int, int, int] = PROGRAM_SWEEP_SHAPE,
    configs: Optional[Tuple[Tuple[str, str, str], ...]] = None,
    *,
    device=None,
) -> List[Finding]:
    """Serve one frame through each configuration's session on ``device``
    (default: the CUDA card; raises without one unless ``device="cpu"``)
    and audit every cached executor, and on a CUDA device the session's
    server launch.  ``configs`` (``(backend, precision, policy)``) defaults
    to :data:`PROGRAM_SWEEP_CONFIGS`, plus :data:`CARD_SWEEP_CONFIGS` on a
    CUDA device."""
    import numpy as np

    from repro_torch.engine.executor import default_device
    from repro_torch.engine.session import SRSession

    dev = default_device(device)
    if configs is None:
        configs = PROGRAM_SWEEP_CONFIGS + (CARD_SWEEP_CONFIGS if dev.type == "cuda" else ())
    findings: List[Finding] = []
    frame = np.zeros(lr_shape, np.float32)
    for backend, precision, policy in configs:
        session = SRSession.open(
            "abpn_x3",
            backend=backend,
            precision=precision,
            vertical_policy=policy,
            autotune="off",
            cache_capacity=4,
            device=dev,
        )
        session.upscale(frame)  # populate the cache: one real build
        findings.extend(program_audit.audit_session(session))
        if dev.type == "cuda":
            findings.extend(program_audit.audit_server(
                session._host_server(), lambda: session.submit(frame)))
    return findings


def analysis_report(*, programs: bool = True, device=None) -> Dict:
    """Run every sweep; per-checker severity counts + a ``clean`` verdict
    (no error-level findings anywhere).  ``device`` is the program sweep's
    (:func:`sweep_programs`)."""
    by_checker = {
        "concurrency": sweep_lint(),
        "plan": sweep_plans(),
        "program": sweep_programs(device=device) if programs else [],
    }
    all_findings = [f for fs in by_checker.values() for f in fs]
    return {
        "concurrency": count_by_severity(by_checker["concurrency"]),
        "plan": count_by_severity(by_checker["plan"]),
        "program": count_by_severity(by_checker["program"]),
        "clean": not errors(all_findings),
    }
