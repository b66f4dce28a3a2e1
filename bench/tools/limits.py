#!/usr/bin/env python3
"""The readings a cell's correctness limit is set from, on the card.

    python3 bench/tools/limits.py --workload x3_fp32_vod --seconds 3 \\
        --seeds 11 12 ... [--control-seeds 11 12 13] [--out PATH]

For each seed, one run of the cell as ``bench/run.py`` makes it (its own
weights and frames, set-up, a window of ``--seconds`` at the cell's load,
the check), all in one process: the program's ``max_abs_err`` over the
frames the check samples, and whether the run is correct.  For each
control seed, the correctness control on the same sampled frames: the
reference computed in the nearest precision below the configuration's
(``harness.check.CONTROL``: TF32 for fp32, float8 e4m3 for bf16), put in
the program's place and judged by ``check.correct`` as a run is.  Prints a
JSON line per reading and a summary: the program's largest reading (the
lower one) and the control's smallest (the upper one).
"""

import argparse
import json
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(BENCH))
sys.path.insert(0, str(BENCH.parent / "src"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch

    from harness import cell, check, registry

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    bench = registry.load_benchmark()
    wl = registry.workload(bench, args.workload)
    cfg = registry.config(bench, wl["config"])
    tr = registry.traffic(wl["traffic"])
    control = check.CONTROL[cfg["serving"]["precision"]]
    device = torch.device("cuda", 0)
    controls = set(args.seeds[:3] if args.control_seeds is None else args.control_seeds)
    rows = []
    for seed in args.seeds:
        record, checks, _ = cell.run(wl, cfg, tr, seed, args.seconds, False, device, time.time())
        row = {"seed": seed, "program": checks["max_abs_err"]["value"],
               "frames": checks["frames_compared"]["value"],
               "failed": checks["failed_requests"]["value"],
               "correct": check.correct(checks)}
        if seed in controls:
            sample = [(req, pos, None) for req, pos in record.sampled]
            res = check.compare(sample, cfg, record.family, int(tr["pool_frames"]), seed,
                                device, precision=control)
            row[control] = res["max_abs_err"]
            # the control in the program's place, judged as a run is
            row[f"{control}_correct"] = check.correct(
                check.checks(res, 0, float(cfg["limits"]["max_abs_err"])))
        rows.append(row)
        print(json.dumps(row), flush=True)
    lower = max(r["program"] for r in rows)
    ctl = [r[control] for r in rows if control in r]
    summary = {"workload": args.workload, "control": control, "lower": lower,
               "upper": min(ctl) if ctl else None,
               "limit_now": cfg["limits"]["max_abs_err"], "rows": rows,
               "card": torch.cuda.get_device_name(device)}
    print(json.dumps(summary))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(summary, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
