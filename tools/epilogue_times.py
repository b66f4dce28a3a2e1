#!/usr/bin/env python3
"""ABPN's epilogue on one CUDA card, for one source tree: the HR frame from
K1's output, timed as the serving path runs it, beside its byte bound.

Run from the root of a checkout, on a machine with an NVIDIA card and nvcc:

    python3 tools/epilogue_times.py [--src PATH] [--rounds 5] [--frames 1 8 128] [--out FILE]

``--src`` names the ``src`` directory whose ``repro_torch`` is timed
(default: this checkout's); its kernels build into that tree's own
``build/``.  To compare two trees on one card, unpack the other with
``git archive`` into a directory ``.gitignore`` lists and run this script
once a tree, in turns (A, B, B, A).

The cells are the benchmark's two configurations on 360x640 frames at 1, 8
and 128 frames (``--frames``): ABPN x3 in fp32 (K1's output a view of Chp
32 channels a pixel, 27 read; an fp32 HR frame) and ABPN x4 in bf16 (K1's
mixed launch, 48 channels; the features and LR in bf16, an fp32 HR frame),
``zero`` bands of 60 rows, seeded He weights.  Each times, queued behind a
~20 ms device sleep between two CUDA events (the median of ``--rounds``
rounds of 5 calls, as ``tools/k1_times.py``):

* ``epilogue_ms`` -- the tree's ``engine.sr_epilogue`` on K1's output view,
  what a dispatch's epilogue stage runs (the parent's five PyTorch passes,
  or the kernel);
* where the tree has ``kernels.epilogue``: ``kernel_ms`` (``sr_epilogue_call``)
  and ``plain_ms`` (``sr_epilogue_plain``, the PyTorch chain), and whether
  the two give the same bits;
* ``bound_ms`` -- the bytes the epilogue has to move at 3.35 TB/s
  (``_stacks.epilogue_bytes``): each pixel's record of the features as K1
  lays it out (Chp channels), the LR input and the HR frame, each once.

Prints the card's name and power limit, one line a cell and one JSON line
(also written to ``--out``).  Exits 2 without a CUDA device.
"""

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BYTES_PER_S = 3.35e12  # H100 SXM's HBM3 (NVIDIA's data sheet)
H, W = 360, 640


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--frames", type=int, nargs="+", default=[1, 8, 128])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.src))

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    from repro_torch import engine
    from repro_torch.models.abpn import ABPNConfig, layers_from_numpy

    try:
        from repro_torch.kernels import epilogue
    except ImportError:  # a tree before the kernel: its chain alone
        epilogue = None
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    from _stacks import device_ms, epilogue_bytes, he_arrays

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}; src: {os.path.abspath(args.src)}")
    dev = torch.device("cuda")
    out = {"card": card, "src": os.path.abspath(args.src)}
    for name, scale, prec in (("x3", 3, "fp32"), ("x4", 4, "bf16")):
        layers = layers_from_numpy(he_arrays(np, ABPNConfig(scale=scale).channels, 40 + scale),
                                   device=dev)
        plan = engine.make_plan(layers, (H, W, 3), backend="kernel", band_rows=60,
                                precision=prec, scale=scale)
        stack = engine.prepare_stack(plan, layers)
        dt = engine.compute_dtype_for(prec)
        for n in args.frames:
            gen = torch.Generator().manual_seed(n)
            x = torch.rand((n, H, W, 3), generator=gen).to(dev).to(dt)
            feats = engine.sr_features(plan, stack.layers, x, packed=stack.packed)
            chp = feats.stride(2)
            bound = 1e3 * epilogue_bytes(n, H, W, chp, 3, scale, feats.element_size(),
                                         4) / BYTES_PER_S
            cell = dict(chp=chp, bound_ms=bound)
            cell["epilogue_ms"] = device_ms(
                torch, lambda: engine.sr_epilogue(plan, x, feats, torch.float32),
                rounds=args.rounds)
            if epilogue is not None:
                kw = dict(scale=scale, clip=plan.clip, out_dtype=torch.float32)
                cell["kernel_ms"] = device_ms(
                    torch, lambda: epilogue.sr_epilogue_call(feats, x, **kw), rounds=args.rounds)
                cell["plain_ms"] = device_ms(
                    torch, lambda: epilogue.sr_epilogue_plain(feats, x, **kw), rounds=args.rounds)
                cell["equal"] = bool(torch.equal(epilogue.sr_epilogue_call(feats, x, **kw),
                                                 epilogue.sr_epilogue_plain(feats, x, **kw)))
            out[f"{name}/{prec}/{n}"] = cell
            print(f"epilogue {name} {prec} {n} frame{'s' if n > 1 else ''} (Chp {chp}): "
                  f"sr_epilogue {cell['epilogue_ms']:.4f} ms "
                  f"({1e3 * cell['epilogue_ms'] / n:.2f} us a frame); "
                  + (f"kernel {cell['kernel_ms']:.4f} ms, plain chain {cell['plain_ms']:.4f} "
                     f"ms, equal {cell['equal']}; " if "kernel_ms" in cell else "")
                  + f"bound {bound:.4f} ms -> "
                  f"{100 * bound / cell.get('kernel_ms', cell['epilogue_ms']):.1f}%", flush=True)
            del feats, x
            torch.cuda.empty_cache()
    line = json.dumps(out)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            fh.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
