#!/usr/bin/env python3
"""K1's device time at the ABPN x3 design point (and, where the tree has the
wide instances, at ABPN x4) on one CUDA card, for one source tree.

Run from the root of a checkout, on a machine with an NVIDIA card and nvcc:

    python3 tools/k1_times.py [--src PATH] [--rounds 5]

``--src`` names the ``src`` directory whose ``repro_torch`` is timed
(default: this checkout's); its kernels build into that tree's own
``build/``.  To compare two trees on one card, unpack the other with
``git archive`` into a directory ``.gitignore`` lists and run this script
once a tree, in turns (A, B, B, A).  For 1 and 8 frames of 360x640 (6
bands of 60 rows a frame, ``zero``, tile 8) it times
``tilted_fusion_call`` with its automatic segment plan in fp32 and bf16:
five launches queued behind a ~20 ms device sleep between two CUDA events,
the median of ``--rounds`` rounds, as ``chip_smoke.py``'s ``device_ms``.
The weights are ``init_abpn`` from seed 0 (x3) and seeded He weights
(x4).  ABPN x4 is timed on both of its paths where the tree has them: the
wide Chp 48 instance (``x4-wide``, the call without ``hidden_channels``)
and the mixed launch the serving path makes (``x4-mixed``: the hidden
layers on the Chp 32 instance, ``hidden_channels`` from ``pack_stack``).
It prints the card's name and power limit, one line a shape, and one JSON
line.

Exits 2 without a CUDA device.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def device_ms(torch, fn, calls=5, rounds=5):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(40_000_000)  # cycles: ~20 ms at the H100's ~2 GHz
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--rounds", type=int, default=5)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.src))

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import ops
    from repro_torch.kernels import tilted_fusion as ttf
    from repro_torch.models.abpn import ABPNConfig, init_abpn, layers_from_numpy

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}; src: {os.path.abspath(args.src)}")
    dev = torch.device("cuda")
    x3 = init_abpn(torch.Generator().manual_seed(0), device=dev)
    stacks = {"x3": (x3, False)}
    if 48 in getattr(ttf, "SUPPORTED_CHP", ()):
        ch = ABPNConfig(scale=4).channels
        rng = np.random.default_rng(40)
        x4 = layers_from_numpy(
            [((rng.normal(size=(3, 3, ch[i], ch[i + 1])) * (2.0 / (9 * ch[i])) ** 0.5)
              .astype(np.float32), (rng.normal(size=(ch[i + 1],)) * 0.1).astype(np.float32),
              i < len(ch) - 2) for i in range(len(ch) - 1)], device=dev)
        stacks["x4-wide"] = (x4, False)
        if hasattr(ttf, "hidden_chp"):
            stacks["x4-mixed"] = (x4, True)
    gen = torch.Generator().manual_seed(1)
    out = {"card": card, "src": os.path.abspath(args.src)}
    for name, (layers, mixed) in stacks.items():
        L = len(layers)
        for n in (1, 8):
            xb = torch.rand((n * 6, 60, 640, 3), generator=gen).to(dev)
            kw = dict(width=640, tile_cols=8, relu_flags=[l.relu for l in layers],
                      in_channels=3, add_anchor=False)
            for prec, dt in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
                packed = ops.pack_stack([l.to(dtype=dt) for l in layers], dtype=dt)
                if mixed:
                    kw["hidden_channels"] = packed.hidden_channels
                xs, first = ops.band_streams(xb.to(dt), 8, L)
                ms = device_ms(torch, lambda: ttf.tilted_fusion_call(
                    xs, first, packed.w, packed.b, **kw), rounds=args.rounds)
                out[f"{name}/{prec}/{n}"] = ms
                print(f"K1 {name} {prec} {n} frame{'s' if n > 1 else ''}: {ms:.4f} ms queued")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
