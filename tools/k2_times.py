#!/usr/bin/env python3
"""K2's device time on one CUDA card, for one source tree: the wide layer
shapes of ABPN x3 at wider feature maps, ABPN x4's last layer, the 7-launch
wide stacks and the narrow ABPN x3 shapes, each beside cuDNN's layer.

Run from the root of a checkout, on a machine with an NVIDIA card and nvcc:

    python3 tools/k2_times.py [--src PATH] [--rounds 5] [--out FILE]

``--src`` names the ``src`` directory whose ``repro_torch`` is timed
(default: this checkout's); its kernels build into that tree's own
``build/``.  To compare two trees on one card, unpack the other with
``git archive`` into a directory ``.gitignore`` lists and run this script
once a tree, in turns (A, B, B, A).  Every cell is one 360x640 map, timed
as ``conv3x3_call`` (``ops.conv3x3`` on the card) in fp32 and bf16: five
calls queued behind a ~20 ms device sleep between two CUDA events, the
median of ``--rounds`` rounds.

The cells:

* ``F{48,64,96,128}/3->F``, ``F->F``, ``F->27`` -- the wide layer shapes of
  ABPN x3 with ``ABPNConfig(feature_channels=F)`` (the first and the hidden
  layers with ReLU, the last without);
* ``x4/28->48`` -- ABPN x4's last layer;
* ``stack-F64``, ``stack-F128`` -- ABPN x3 at F = 64 and 128 layer by layer:
  7 launches a frame on the seeded He weights of ``chip_smoke.py``'s phase
  4w (``tools/_stacks.py``), each layer fed the previous layer's features;
* ``x3/3->28``, ``x3/28->28``, ``x3/28->27`` -- the narrow ABPN x3 shapes
  (the persistent instances), a control.

Weights are He-initialised from a seed, biases N(0, 0.1), inputs uniform in
[0, 1).  Beside each cell: cuDNN's ``conv2d`` (+ ReLU) on the same layer or
stack in NCHW (TF32 off; bf16 in bf16 with the weights cast before
timing); the bound of the useful work (2 FLOP a multiply-add, fp32 as
3xTF32 at the TF32 peak, bf16 at the bf16 peak; the input, the output and
the weights moved once at the memory rate; the published H100 SXM rates);
and, for a wide layer, the CTA-chunks of the launch and the bytes it
copies into shared memory (``conv3x3.wide_copies`` where the tree has it,
else the count of the wide instance that ran one CTA a (tile, 32 outputs)
pair).  It prints the card's name and power limit, one line a cell, and one
JSON line (also written to ``--out``).

Exits 2 without a CUDA device.
"""

import argparse
import json
import os
import subprocess
import sys

from _stacks import cudnn_stack, device_ms, he_arrays, useful_bound

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# H100 SXM, dense (NVIDIA's data sheet): TF32 and bf16 tensor cores, HBM3
PEAKS = {"tf32": 495e12, "bf16": 989e12, "bytes": 3.35e12}
H, W = 360, 640
WIDE_F = (48, 64, 96, 128)
STACK_F = (64, 128)


def pr26_copies(ci, co, dtype_bytes):
    """CTA-chunks and bytes copied into shared memory by the wide instance
    that ran one CTA a (8x32 tile, 32 outputs) pair: each CTA-chunk copies
    its (10, 34) window of the chunk's 32 channels and the chunk's packed
    weights of its 32 outputs (fp32 as TF32 hi and lo words)."""
    tiles = -(-H // 8) * -(-W // 32)
    chunks, groups = -(-ci // 32), -(-co // 32)
    n = tiles * groups * chunks
    window, weights = n * 340 * 32 * dtype_bytes, n * 9 * 32 * 32 * (8 if dtype_bytes == 4 else 2)
    return {"cta_chunks": n, "window_bytes": window, "weight_bytes": weights,
            "smem_bytes": window + weights}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.src))

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import conv3x3 as k2
    from repro_torch.models.abpn import ABPNConfig, layers_from_numpy

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}; src: {os.path.abspath(args.src)}")
    dev = torch.device("cuda")

    def layer(ci, co, relu, seed):
        (w, b, _), = he_arrays(np, [ci, co], seed)
        (l,) = layers_from_numpy([(w, b, relu)], device=dev)
        return l

    # name -> (layers, single layer)
    cells = {}
    for f in WIDE_F:
        cells[f"F{f}/3->{f}"] = [layer(3, f, True, 100 + f)]
        cells[f"F{f}/{f}->{f}"] = [layer(f, f, True, 200 + f)]
        cells[f"F{f}/{f}->27"] = [layer(f, 27, False, 300 + f)]
    cells["x4/28->48"] = [layer(28, 48, False, 448)]
    for f in STACK_F:
        ch = ABPNConfig(feature_channels=f).channels
        cells[f"stack-F{f}"] = layers_from_numpy(he_arrays(np, ch, 60 + f), device=dev)
    cells["x3/3->28"] = [layer(3, 28, True, 328)]
    cells["x3/28->28"] = [layer(28, 28, True, 2828)]
    cells["x3/28->27"] = [layer(28, 27, False, 2827)]

    gen = torch.Generator().manual_seed(1)
    out = {"card": card, "src": os.path.abspath(args.src)}
    copies = getattr(k2, "wide_copies", None)
    for name, layers in cells.items():
        x32 = torch.rand((H, W, layers[0].ci), generator=gen).to(dev)
        for prec, dt in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
            ls = [l.to(dtype=dt) for l in layers]
            x = x32.to(dt)

            def run(x=x, ls=ls):
                for l in ls:
                    x = k2.conv3x3_call(x, l.w, l.b, relu=l.relu)
                return x

            nchw = x.permute(2, 0, 1)[None].contiguous()
            cudnn = cudnn_stack(torch, layers, dt)
            ms = device_ms(torch, run, rounds=args.rounds)
            lib_ms = device_ms(torch, lambda: cudnn(nchw), rounds=args.rounds)
            useful = useful_bound(layers, H * W, prec, dt.itemsize, PEAKS)
            cell = dict(ms=ms, cudnn_ms=lib_ms, gflop=useful["flops"] / 1e9,
                        bound_ms=useful["bound_ms"], bound_by=useful["bound_by"],
                        bytes_bound_ms=useful["bytes_bound_ms"])
            if len(layers) == 1 and k2.is_wide(layers[0].ci, layers[0].co):
                l = layers[0]
                cell.update(copies(l.ci, l.co, H, W, dt) if copies is not None
                            else pr26_copies(l.ci, l.co, dt.itemsize))
            out[f"{name}/{prec}"] = cell
            extra = (f"; {cell['cta_chunks']} CTA-chunks, {cell['smem_bytes'] / 1e6:.1f} MB "
                     f"into shared memory" if "cta_chunks" in cell else "")
            print(f"K2 {name} {prec}: {ms:.4f} ms queued; cuDNN {lib_ms:.4f} ms "
                  f"({lib_ms / ms:.2f}x K2's time); bound {cell['bound_ms']:.4f} ms "
                  f"({cell['bound_by']}; bytes {cell['bytes_bound_ms']:.4f}) -> "
                  f"{100 * cell['bound_ms'] / ms:.1f}%; {cell['gflop']:.2f} GFLOP{extra}",
                  flush=True)
    line = json.dumps(out)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            fh.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
