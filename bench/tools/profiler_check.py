#!/usr/bin/env python3
"""Does ``torch.profiler`` see K1?  Counts K1's kernels four ways over the
same served requests, on the card.

    python3 bench/tools/profiler_check.py [--workload x3_fp32_vod] [--requests 6]

Opens the cell's server as ``bench/run.py`` does, then profiles
``--requests`` requests of the cell's size and counts K1's main kernels
(``harness.kernels.is_k1_main``) in the exported Chrome trace
(``export_chrome_trace``, written under ``$TMPDIR``), in the profiler's
Kineto events (what ``harness.trace`` reads), and in ``prof.events()``,
beside how far ``tilted_fusion_call.launches`` moved.  Prints one JSON line.
"""

import argparse
import json
import sys
import tempfile
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(BENCH))
sys.path.insert(0, str(BENCH.parent / "src"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", default="x3_fp32_vod")
    ap.add_argument("--requests", type=int, default=6)
    args = ap.parse_args(argv)

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from harness import cell, inputs, registry, traffic
    from harness.kernels import is_k1_main
    from harness.trace import annotation
    from repro_torch.kernels.tilted_fusion import tilted_fusion_call

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    bench = registry.load_benchmark()
    wl = registry.workload(bench, args.workload)
    cfg = registry.config(bench, wl["config"])
    tr = dict(registry.traffic(wl["traffic"]), warm_seconds=0)
    device = torch.device("cuda", 0)
    pool = inputs.make_pool(cfg, int(tr["pool_frames"]), 3)
    family = registry.family(cfg)
    server = family.open_server(cfg, family.make_weights(cfg, 3, device), device)
    cell.warm(server, cfg, tr, pool, 3)
    n = traffic.frames_per_request(tr)
    torch.cuda.synchronize()
    before = tilted_fusion_call.launches
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function("bench.result"):
            futs = [server.submit(pool[i:i + n]) for i in range(args.requests)]
            for f in futs:
                f.result()
            torch.cuda.synchronize()
    launches = tilted_fusion_call.launches - before
    path = Path(tempfile.gettempdir()) / "bench-profiler-check.json"
    prof.export_chrome_trace(str(path))
    chrome = json.loads(path.read_text())["traceEvents"]
    kinds = sorted({e.get("cat") for e in chrome if is_k1_main(e.get("name", ""))})
    out = {
        "launches_counted": launches,
        "chrome_trace": sum(1 for e in chrome
                            if e.get("cat") == "kernel" and is_k1_main(e.get("name", ""))),
        "chrome_categories_of_k1": kinds,
        "kineto_events": sum(1 for e in prof.profiler.kineto_results.events()
                             if is_k1_main(e.name())),
        "prof_events": sum(1 for e in prof.events() if is_k1_main(e.name)),
        "k1_names": sorted({e.get("name") for e in chrome if is_k1_main(e.get("name", ""))}),
        "torch": torch.__version__,
        # the device-side events harness.trace drops as spans, not work
        "device_spans_dropped": sorted({e.name()[:60] for e in prof.profiler.kineto_results.events()
                                        if e.device_type() == DeviceType.CUDA and annotation(e)}),
    }
    print(json.dumps(out))
    server.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
