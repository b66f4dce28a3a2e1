"""``python -m repro_torch.analysis`` — run the static checkers as a CI gate.

Selects checkers via ``--lint`` / ``--plans`` / ``--programs`` (or
``--all``, the default when no selector is given), prints every finding
grouped by checker, and exits 1 when any ERROR-level finding survives —
warnings and infos are reported but do not fail the build.  The program
sweep serves on the CUDA card (and adds the ``kernel`` backend there);
``--device cpu`` runs it on the CPU.
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional

from repro_torch.analysis import sweep
from repro_torch.analysis.findings import Finding, count_by_severity, errors, format_findings


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="Static verification: plan geometry, program audit, "
                    "concurrency lint.",
    )
    ap.add_argument("--all", action="store_true",
                    help="run every checker (default when none selected)")
    ap.add_argument("--lint", action="store_true",
                    help="concurrency-lint the serving sources")
    ap.add_argument("--plans", action="store_true",
                    help="statically verify the design-point plan grid")
    ap.add_argument("--programs", action="store_true",
                    help="serve representative sessions and audit their "
                         "executors (the slow sweep)")
    ap.add_argument("--device", default=None,
                    help="device of the program sweep (default: the CUDA card; "
                         "'cpu' for the CPU)")
    args = ap.parse_args(argv)
    run_all = args.all or not (args.lint or args.plans or args.programs)

    findings: List[Finding] = []
    if run_all or args.lint:
        got = sweep.sweep_lint()
        print(format_findings(got, header="concurrency lint (serving sources):"))
        findings.extend(got)
    if run_all or args.plans:
        got = sweep.sweep_plans()
        print(format_findings(got, header="plan verification (design-point grid):"))
        findings.extend(got)
    if run_all or args.programs:
        got = sweep.sweep_programs(device=args.device)
        print(format_findings(got, header="program audit (representative sessions):"))
        findings.extend(got)

    counts = count_by_severity(findings)
    errs = errors(findings)
    print(
        f"\n{counts['error']} error(s), {counts['warning']} warning(s), "
        f"{counts['info']} info — {'FAIL' if errs else 'OK'}"
    )
    return 1 if errs else 0


if __name__ == "__main__":
    sys.exit(main())
