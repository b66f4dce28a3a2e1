#!/usr/bin/env python3
"""Hold the program's own serving counters against the device trace, in one
traced run of a cell.

    python3 bench/tools/span_check.py --workload x3_fp32_vod --seed N
                                      [--seconds 20] [--out PATH] [--small]

Runs the cell as ``bench/run.py --trace 1`` does and prints one JSON object:

* ``k1``: the program's K1 stage (``SRSession.stats()["k1_device_ms"]``,
  K1's launch between two CUDA events) against the trace's K1 seconds
  (``harness.kernels.is_k1``);
* ``stages``: the device seconds of every stage the program counts
  (upload, marshal, K1, epilogue, join) against the trace's busy seconds;
* ``little``: the mean request latency times the requests finished per
  second of the window, against the traffic's clients (Little's law);
* ``idle_by_span``: the window's idle device seconds by the ``sr.*`` span
  open on the host at each gap's midpoint (the shortest, where several
  are; ``none`` where none is), and ``idle_under``: for each span name, the
  idle seconds during which one was open on some thread;
* ``frames_per_s``, the per-layer metrics, the session's counters and
  ``correct``.

``--small`` runs the cell's configuration at a test's size on the CPU
(``tilted`` backend), as ``bench/tests/test_bench_control.py`` does, for a
rehearsal; its times are the host's.
"""

import argparse
import json
import sys
import time
from collections import defaultdict
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(BENCH))
sys.path.insert(0, str(BENCH.parent / "src"))


def idle_by_span(trace, prefix: str = "sr."):
    spans = sorted((h for h in trace.host if h[0].startswith(prefix)), key=lambda h: h[1])
    shortest, under = defaultdict(float), defaultdict(float)
    for a, b in trace.gaps():
        mid = (a + b) // 2
        open_ = [h for h in spans if h[1] <= mid <= h[2]]
        secs = (b - a) / 1e9
        shortest[min(open_, key=lambda h: h[2] - h[1])[0] if open_ else "none"] += secs
        for name in {h[0] for h in open_}:
            under[name] += secs
    order = lambda d: dict(sorted(d.items(), key=lambda kv: -kv[1]))  # noqa: E731
    return order(shortest), order(under)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", default="x3_fp32_vod")
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--out", default=None)
    ap.add_argument("--small", action="store_true", help="a test's size, on the CPU")
    args = ap.parse_args(argv)

    import torch

    from harness import cell as cell_mod
    from harness import check, registry
    from harness.kernels import is_k1

    bench = registry.load_benchmark()
    wl = registry.workload(bench, args.workload)
    cfg = registry.config(bench, wl["config"])
    tr = registry.traffic(wl["traffic"])
    device, backend = "cuda", None
    if args.small:
        cfg.update(lr_height=60, lr_width=40)
        cfg["serving"].update(band_rows=30, max_bucket=4)
        tr.update(pool_frames=24, warm_seconds=0.2, warm_max_bucket=4, sample_requests=4,
                  sample_frames=4, clients=2, frames_per_request=6)
        device, backend = "cpu", "tilted"
    record, checks, _ = cell_mod.run(wl, cfg, tr, args.seed, args.seconds, True,
                                     device, time.time(), backend=backend)
    t, s = record.trace, record.session
    window_s = record.window.seconds
    k1_prog = s.get("k1_device_ms", 0.0) / 1e3
    k1_trace = t.device_seconds(is_k1)
    stages = sum(s.get(f"{st}_device_ms", 0.0)
                 for st in ("upload", "marshal", "k1", "epilogue", "join"))
    busy = t.busy_s()
    in_system = s.get("latency_mean_ms", 0.0) / 1e3 * s.get("requests", 0) / window_s
    shortest, under = idle_by_span(t)
    out = {
        "workload": args.workload, "seed": args.seed,
        "device": torch.cuda.get_device_name(0) if device == "cuda" else "cpu",
        "correct": check.correct(checks),
        "window_s": window_s, "frames_done": record.frames_done,
        "frames_per_s": record.frames_done / window_s,
        "k1": {"program_s": k1_prog, "trace_s": k1_trace,
               "ratio": k1_prog / k1_trace if k1_trace else None},
        "stages": {"program_s": stages / 1e3, "busy_s": busy,
                   "ratio": stages / 1e3 / busy if busy else None},
        "little": {"in_system": in_system, "clients": int(tr["clients"]),
                   "ratio": in_system / int(tr["clients"])},
        "idle_s": t.window_s - busy, "idle_by_span": shortest, "idle_under": under,
        "metrics": registry.read_metrics(registry.metrics_for(bench, wl["name"], True), record),
        "session": s,
    }
    text = json.dumps(out, default=str)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text)
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
