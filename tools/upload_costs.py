#!/usr/bin/env python3
"""What uploading a request's host frames costs on one CUDA card.

Run from the root of a checkout, on a machine with an NVIDIA card and nvcc:

    python3 tools/upload_costs.py [--src PATH]

``--src`` names the ``src`` directory whose ``repro_torch`` is timed
(default: this checkout's).  For one request of 8 host frames of 360x640
(fp32, numpy) it times, each to a device sync, median of 10 after a
warm-up: ``pin_memory()``, a copy into a held pinned buffer, a pageable
``.to("cuda")``, a pinned ``.to("cuda", non_blocking=True)`` and both
steps together.  Then it sends 20 closed-loop requests to an ABPN x3
server (``kernel`` backend, fp32, random weights from seed 0) and prints
the frames/s, the median time of ``submit`` and of ``result``, and, where
the tree has it, each request's time in ``SRServer._pinned_for``.  It
prints the card's name and power limit first and one JSON line last.

Exits 2 without a CUDA device.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.src))

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    from repro_torch import engine
    from repro_torch.engine.server import SRServer
    from repro_torch.models.abpn import init_abpn

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}; src: {os.path.abspath(args.src)}")
    x = np.random.default_rng(0).uniform(size=(8, 360, 640, 3)).astype(np.float32)
    t = torch.from_numpy(x)
    held = torch.empty_like(t, pin_memory=True)
    out = {"card": card, "src": os.path.abspath(args.src)}

    def timed(name, fn, n=10):
        fn()
        torch.cuda.synchronize()
        ms = []
        for _ in range(n):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        out[name] = {"median_ms": statistics.median(ms), "min_ms": min(ms), "max_ms": max(ms)}
        print(f"{name}: median {statistics.median(ms):.3f} ms, min {min(ms):.3f}, "
              f"max {max(ms):.3f}")

    timed("pin_memory", lambda: t.pin_memory())
    timed("copy_into_held_pinned", lambda: held.copy_(t))
    timed("pageable_to_cuda", lambda: t.to("cuda"))
    timed("pinned_to_cuda_non_blocking", lambda: held.to("cuda", non_blocking=True))
    timed("pin_then_to_cuda_non_blocking",
          lambda: t.pin_memory().to("cuda", non_blocking=True))

    layers = init_abpn(torch.Generator().manual_seed(0))
    server = engine.SRServer.open("abpn_x3", backend="kernel", precision="fp32", layers=layers)
    server.submit(x).result()
    pin_ms = []
    pinned_for = getattr(SRServer, "_pinned_for", None)
    if pinned_for is not None:
        def timed_pin(session, flat):
            t0 = time.perf_counter()
            r = pinned_for(session, flat)
            pin_ms.append((time.perf_counter() - t0) * 1e3)
            return r
        server._pinned_for = timed_pin
    submit_ms, result_ms = [], []
    t0 = time.perf_counter()
    for _ in range(20):
        a = time.perf_counter()
        fut = server.submit(x)
        b = time.perf_counter()
        fut.result()
        submit_ms.append((b - a) * 1e3)
        result_ms.append((time.perf_counter() - b) * 1e3)
    wall = time.perf_counter() - t0
    server.close()
    out["server"] = {"frames_per_s": 160 / wall, "submit_median_ms": statistics.median(submit_ms),
                     "result_median_ms": statistics.median(result_ms), "pin_ms": pin_ms}
    print(f"server, 20 closed-loop 8-frame requests: {160 / wall:.2f} frames/s; submit median "
          f"{statistics.median(submit_ms):.3f} ms, result median "
          f"{statistics.median(result_ms):.3f} ms; pinning per request (ms): "
          f"{[round(v, 3) for v in pin_ms] or 'not in this tree'}")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
