#!/usr/bin/env python3
"""RLFN's ESA stage (an RLFB's c5 and ESA) on one CUDA card, for one source
tree: timed as the serving path runs it, beside its bound.

Run from the root of a checkout, on a machine with an NVIDIA card and nvcc:

    python3 tools/esa_times.py [--src PATH] [--rounds 5] [--frames 1 8 128] [--out FILE]

``--src`` names the ``src`` directory whose ``repro_torch`` is timed
(default: this checkout's); its kernels build into that tree's own
``build/``.  To compare two trees on one card, unpack the other with
``git archive`` into a directory ``.gitignore`` lists and run this script
once a tree, in turns (A, B, B, A).

The cell is ``x4_bf16_rlfn_vod``'s: 360x640 frames of 52 bf16 channels (a
segment's output) at 1, 8 and 128 frames (``--frames``), block 1's weights
from ``init_rlfn`` with biases that are not zero.  Each times, queued behind
a ~20 ms device sleep between two CUDA events (the median of ``--rounds``
rounds of 5 calls, as ``tools/epilogue_times.py``):

* ``stage_ms`` -- the tree's ``ESAStage`` on the frames, what a dispatch's
  ``esa`` stage runs (the parent's PyTorch chain, or the kernels);
* where the tree has ``kernels.esa``: ``kernel_ms`` (``esa_call``) and
  ``plain_ms`` (``esa_plain``, the PyTorch chain), and at 8 frames or fewer
  each one's largest difference from the fp32 chain (``kernel_err``,
  ``plain_err``);
* ``bound_ms`` -- the family's ``esa_work`` for one block (each stage's
  input and output once, the convolutions' FLOPs) at 3.35 TB/s or 989
  TFLOP/s, whichever is longer, and ``floor_ms``, the bytes the kernels'
  passes move (h twice, c1_ and cf written and read, the output) at 3.35
  TB/s.

Prints the card's name and power limit, one line a frame count and one JSON
line (also written to ``--out``).  Exits 2 without a CUDA device.
"""

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BYTES_PER_S = 3.35e12  # H100 SXM's HBM3 (NVIDIA's data sheet)
BF16_FLOPS = 989e12  # its dense bf16 tensor-core peak
H, W, F, E = 360, 640, 52, 16


def esa_block_work(height, width, itemsize):
    """(FLOPs, bytes, the passes' bytes) of one block's ESA stage on one
    frame: ``bench/families/rlfn.py::esa_work`` over six blocks is six of
    these; the passes read h twice (52 channels), write and read c1_ and
    cf (16 each), and write the output."""
    h2, w2 = (height - 3) // 2 + 1, (width - 3) // 2 + 1
    h3, w3 = (h2 - 7) // 3 + 1, (w2 - 7) // 3 + 1
    px = height * width
    flops = 2 * (F * F + F * E + E * E + E * F) * px + 2 * 9 * E * E * (h2 * w2 + h3 * w3)
    return flops, px * 2 * F * itemsize, px * (3 * F + 4 * E) * itemsize


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--frames", type=int, nargs="+", default=[1, 8, 128])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.src))

    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    from repro_torch.models.rlfn import ESAStage, init_rlfn

    try:
        from repro_torch.kernels import esa
    except ImportError:  # a tree before the kernels: its chain alone
        esa = None
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    from _stacks import device_ms

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}; src: {os.path.abspath(args.src)}")
    dev, dt = torch.device("cuda"), torch.bfloat16
    gen = torch.Generator().manual_seed(31)
    sd = init_rlfn(gen)
    names = ("c5", "esa.conv1", "esa.conv_f", "esa.conv2", "esa.conv3", "esa.conv4")
    pairs32 = tuple((sd[f"block_1.{n}.weight"].to(dev),
                     (torch.randn(sd[f"block_1.{n}.bias"].shape, generator=gen) * 0.05).to(dev))
                    for n in names)
    stage = ESAStage(*pairs32).to(dtype=dt)
    pairs = tuple(getattr(stage, f) for f in ("c5", "conv1", "conv_f", "conv2", "conv3", "conv4"))
    flops, nbytes, floor = esa_block_work(H, W, 2)
    out = {"card": card, "src": os.path.abspath(args.src)}
    for n in args.frames:
        x = (torch.randn((n, H, W, F), generator=torch.Generator().manual_seed(n)) * 0.5).to(
            dev).to(dt)
        cell = dict(bound_ms=1e3 * n * max(flops / BF16_FLOPS, nbytes / BYTES_PER_S),
                    floor_ms=1e3 * n * floor / BYTES_PER_S)
        cell["stage_ms"] = device_ms(torch, lambda: stage(x), rounds=args.rounds)
        if esa is not None:
            cell["kernel_ms"] = device_ms(torch, lambda: esa.esa_call(x, *pairs),
                                          rounds=args.rounds)
            cell["plain_ms"] = device_ms(torch, lambda: esa.esa_plain(x, *pairs),
                                         rounds=args.rounds)
            if n <= 8:
                want = esa.esa_plain(x.float(), *pairs32)
                for key, fn in (("kernel_err", esa.esa_call), ("plain_err", esa.esa_plain)):
                    cell[key] = (fn(x, *pairs).float() - want).abs().max().item()
                del want
        out[f"bf16/{n}"] = cell
        ms = cell.get("kernel_ms", cell["stage_ms"])
        print(f"esa bf16 {n} frame{'s' if n > 1 else ''}: stage {cell['stage_ms']:.4f} ms "
              f"({cell['stage_ms'] / n:.4f} a frame); "
              + (f"kernels {cell['kernel_ms']:.4f} ms, plain chain {cell['plain_ms']:.4f} ms; "
                 if "kernel_ms" in cell else "")
              + (f"vs the fp32 chain: kernels {cell['kernel_err']:.3e}, bf16 chain "
                 f"{cell['plain_err']:.3e}; " if "kernel_err" in cell else "")
              + f"bound {cell['bound_ms']:.4f} ms -> {100 * cell['bound_ms'] / ms:.1f}%, "
              f"the passes' floor {cell['floor_ms']:.4f} ms", flush=True)
        del x
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
