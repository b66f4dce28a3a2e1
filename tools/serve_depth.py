#!/usr/bin/env python3
"""Served frames/s at pipeline depth 1 and 2, with concurrent clients, on
one CUDA card.

Run from the root of a checkout, on a machine with an NVIDIA card and nvcc:

    python3 tools/serve_depth.py [--src PATH] [--clients 4] [--requests 12]

``--src`` names the ``src`` directory whose ``repro_torch`` is timed
(default: this checkout's), so one call can time two trees with the same
script.  For each vertical policy (``zero``, ``halo``) and depth (1, 2) it
opens an ABPN x3 server on the ``kernel`` backend (fp32, random weights
from seed 0, ``autotune="off"``), warms it, and has ``--clients`` threads
each send ``--requests`` closed-loop requests of 8 host frames of 360x640
(numpy, as a client sends them).  It prints the frames/s over the wall
clock of all clients, the p50 launch-to-completion latency, and the card's
name and power limit, then one JSON line.  Depth 2 can only beat depth 1
when a launch, which runs under the server lock, does not wait for the
card.

Exits 2 without a CUDA device.
"""

import argparse
import json
import os
import subprocess
import sys
import threading
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--requests", type=int, default=12)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.src))

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    from repro_torch import engine
    from repro_torch.models.abpn import init_abpn

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}; src: {os.path.abspath(args.src)}")
    layers = init_abpn(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    batches = [rng.uniform(size=(8, 360, 640, 3)).astype(np.float32)
               for _ in range(args.clients)]
    results = []
    for policy in ("zero", "halo"):
        for depth in (1, 2):
            session = engine.SRSession(layers, backend="kernel", precision="fp32",
                                       vertical_policy=policy, pipeline_depth=depth,
                                       autotune="off", device="cuda")
            server = engine.SRServer({"abpn_x3": session})
            for b in batches[:2]:
                server.submit(b).result()  # warm: build, executor, pinned blocks
            torch.cuda.synchronize()
            session.reset_stats()
            errors = []

            def client(frames):
                try:
                    for _ in range(args.requests):
                        server.submit(frames).result()
                except BaseException as e:  # reported below, fails the run
                    errors.append(e)

            threads = [threading.Thread(target=client, args=(b,)) for b in batches]
            t0 = time.perf_counter()
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
            if errors:
                raise errors[0]
            frames = args.clients * args.requests * 8
            st = session.stats()
            row = {"policy": policy, "depth": depth, "frames_per_s": frames / wall_s,
                   "wall_s": wall_s, "p50_ms": st["p50_ms"],
                   "peak_inflight": st.get("peak_inflight")}
            results.append(row)
            print(f"{policy} depth {depth}: {row['frames_per_s']:.2f} frames/s over "
                  f"{wall_s:.3f} s ({args.clients} clients x {args.requests} requests of 8 "
                  f"frames), p50 {st['p50_ms']:.2f} ms, peak in flight {row['peak_inflight']}")
            server.close()
    print(json.dumps({"card": card, "src": os.path.abspath(args.src), "results": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
