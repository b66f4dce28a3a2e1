#!/usr/bin/env python3
"""Run one cell of the port's benchmark once, on the card this process sees.

    python3 bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>
                         [--record PATH]

Run from the root of a checkout that holds ``src/repro_torch``.  The cell
(``BENCHMARK.json``'s ``workloads``) names a configuration
(``bench/configs/``) and a traffic mix (``bench/traffic/``).  The run makes
its weights and frames from ``--seed``, opens the port's ``SRServer``,
warms every shape the traffic uses (set-up), measures for ``--seconds``,
and checks a seeded sample of the HR frames served against the plain
reference (``bench/reference/``).  ``--trace 0`` prints the cell's
end-to-end metrics; ``--trace 1`` records the window with
``torch.profiler`` and prints its per-layer metrics (``bench/metrics/``)
with the device's busy time and a breakdown.

The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number compared beside its
limit); the checks are also the last lines of standard error.  Everything
else (counters, set-up's stages, the card's power limit) goes to
standard error and to a JSON file under ``$TMPDIR`` (or ``--record``).

Exits non-zero, printing no result, without CUDA or with fewer cards than
the cell asks for, and when the process holds ``jax``, ``jaxlib``,
``flax`` or the JAX package ``repro`` once the window has closed.
"""

from __future__ import annotations

import os
import time


def _process_start() -> float:
    """When this process started (``time.time()`` seconds), from
    ``/proc``; the module's own import time where that cannot be read."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            boot = next(int(line.split()[1]) for line in f if line.startswith("btime"))
        return boot + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return time.time()


T_START = _process_start()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
REPO = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")  # top-level module names, compared whole


def forbidden_modules() -> list:
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--record", default=None, help="also write the run's record here")
    args = ap.parse_args(argv)

    sys.path.insert(0, str(BENCH))
    from harness import registry

    bench = registry.load_benchmark(REPO)
    cell = registry.workload(bench, args.workload)
    cfg = registry.config(bench, cell["config"], REPO)
    tr = registry.traffic(cell["traffic"])

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        print(f"needs {cell['chips']} CUDA device(s); this process sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    src = REPO / "src"
    if not (src / "repro_torch").is_dir():
        print(f"the program under test is not here: no {src / 'repro_torch'}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    from harness import cell as cell_mod, stats

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    record, checks, peak = cell_mod.run(cell, cfg, tr, args.seed, args.seconds,
                                        bool(args.trace), device, T_START)
    found = forbidden_modules()
    if found:
        print(f"the process holds {found} after the window: the port must not load "
              "JAX or the JAX package", file=sys.stderr)
        return 3

    from harness import check

    metrics = registry.read_metrics(registry.metrics_for(bench, cell["name"], bool(args.trace)),
                                    record)
    out = {
        "correct": check.correct(checks),
        "attempted": len(record.window.requests),
        "failed": checks["failed_requests"]["value"],
        "metrics": metrics,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
                   "count": int(cell["chips"]), "memory_peak_bytes": int(peak)},
    }
    side = {
        "workload": cell["name"], "seed": args.seed, "seconds": args.seconds,
        "trace": args.trace, "card": card_line(), "torch": torch.__version__,
        "cuda": torch.version.cuda, "setup_s": record.setup_s,
        "setup_stages": record.setup_stages,
        "window_s": record.window.seconds, "frames_done": record.frames_done,
        "sched": record.sched, "session": record.session, "k1_launches": record.k1_launches,
        "window_builds": record.window_builds, "metrics": metrics,
    }
    if record.trace is not None:
        tr_ = record.trace
        out["device"]["busy_s"] = tr_.busy_s()
        out["device"]["window_s"] = tr_.window_s
        out["breakdown"] = tr_.breakdown()
        from harness.kernels import is_k1_main

        side["trace"] = {"device_events": len(tr_.device), "host_events": len(tr_.host),
                         "all_threads": tr_.all_threads,
                         "k1_kernels": tr_.count(is_k1_main),
                         "k1_launches_counted": record.k1_launches,
                         "buckets": None if record.buckets is None else len(record.buckets),
                         "k1_executed_flops": record.k1_executed_flops}
    out["checks"] = {k: {"value": stats.finite(v["value"]), "limit": v["limit"]}
                     for k, v in checks.items()}
    side["result"] = out
    text = json.dumps(side, indent=1, default=str)
    path = Path(args.record) if args.record else Path(tempfile.gettempdir()) / (
        f"bench-{cell['name']}-seed{args.seed}-trace{args.trace}.json")
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(text)
    summary = {k: side[k] for k in ("card", "setup_s", "setup_stages", "window_s",
                                    "frames_done", "sched", "k1_launches", "window_builds",
                                    "trace") if k in side}
    print(json.dumps(summary, default=str), file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
