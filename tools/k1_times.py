#!/usr/bin/env python3
"""K1's device time on one CUDA card, for one source tree: ABPN x3, ABPN x4
(where the tree has the wide instances) and ABPN x3 at wider feature maps,
each beside cuDNN's conv stack on the same layers.

Run from the root of a checkout, on a machine with an NVIDIA card and nvcc:

    python3 tools/k1_times.py [--src PATH] [--rounds 5] [--stacks x3 x4-mixed ...] [--out FILE]
                              [--band-rows R ...]

``--src`` names the ``src`` directory whose ``repro_torch`` is timed
(default: this checkout's); its kernels build into that tree's own
``build/``.  To compare two trees on one card, unpack the other with
``git archive`` into a directory ``.gitignore`` lists and run this script
once a tree, in turns (A, B, B, A).  For 1 and 8 frames of 360x640 (6
bands of 60 rows a frame, ``zero``, tile 8) it times
``tilted_fusion_call`` with its automatic segment plan in fp32 and bf16:
five launches queued behind a ~20 ms device sleep between two CUDA events,
the median of ``--rounds`` rounds, as ``chip_smoke.py``'s ``device_ms``.

The stacks:

* ``x3`` -- ``init_abpn`` from seed 0 (Chp 32, the narrow instance);
* ``x4-wide`` / ``x4-mixed`` -- ABPN x4 from seeded He weights, on the wide
  Chp 48 instance (the call without ``hidden_channels``) and on the mixed
  launch the serving path makes (``hidden_channels`` from ``pack_stack``),
  where the tree has them;
* ``x3-F48``, ``x3-F64``, ``x3-F96``, ``x3-F128`` -- ABPN x3 with
  ``ABPNConfig(feature_channels=F)`` (3 -> F x6 -> 27), seeded He weights
  through ``models.abpn.layers_from_numpy``, on the wide Chp F instance;
  F = 48 and 96 at one frame only;
* ``rlfb`` -- RLFN's residual-block segment as ``rlfn_x4`` serves it (where
  the tree has it): 3 layers 52 -> 52, LeakyReLU(0.05), the block's input
  added after the last, on the Chp 64 instance over ``halo`` slabs (6 of
  66 rows a frame, their row bounds, the residual on each band's own 60
  rows), at 1, 8 and 128 frames, beside cuDNN's segment (three ``conv2d``
  and ``leaky_relu``, the add) on whole NCHW frames.

Beside each: cuDNN's conv stack on the same layers (NCHW ``conv2d`` + ReLU,
TF32 off, bf16 for bf16, the weights cast before timing), timed the same
way; for ``x3`` and ``x4-mixed``, K2's layer-by-layer stack on the same
layers and frames (``conv3x3_call`` once a layer and a 360x640 frame, each
layer fed the one before: the unfused path), timed the same way; the
bounds of the stack's useful work (fp32 as 3xTF32 at the TF32 peak, bf16
at the bf16 peak, and the bytes of the input, the output and the weights
at the memory rate, the published H100 SXM rates; ``tools/_stacks.py`` has
these and the seeded He weights); and ``launch_cost``'s executed GFLOP and
bytes for the launch's own segment plan, as the tree counts them: (a), the
arguments and the result, and (b), the workspace's.  It prints the card's
name and power limit, one line a cell, and one JSON line (also written to
``--out``).

``--band-rows R ...`` (default 60, the cells above) times K1 alone at any
other R, on bands of R rows, ceil(360 / R) of them a frame (86: the shape
of the five halo slabs of 72-row bands that the tuner tries; 360: the
one-band fallback), with the launch's own segment plan and
``launch_cost``'s (b): the heights past the on-chip route's, where a launch
keeps its feature maps in device memory.

Exits 2 without a CUDA device.
"""

import argparse
import itertools
import json
import os
import subprocess
import sys

from _stacks import cudnn_stack, device_ms, he_arrays, useful_bound

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# H100 SXM, dense (NVIDIA's data sheet): TF32 and bf16 tensor cores, HBM3
PEAKS = {"tf32": 495e12, "bf16": 989e12, "bytes": 3.35e12}
WIDE_F = {48: (1,), 64: (1, 8), 96: (1,), 128: (1, 8)}  # feature widths -> frame counts
K2_STACKS = ("x3", "x4-mixed")  # the stacks timed layer by layer through K2 as well


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--stacks", nargs="*", default=None,
                    help="time only these stacks (default: all the tree has)")
    ap.add_argument("--out", default=None)
    ap.add_argument("--band-rows", type=int, nargs="+", default=[60])
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.src))

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import conv3x3 as k2
    from repro_torch.kernels import ops
    from repro_torch.kernels import tilted_fusion as ttf
    from repro_torch.models.abpn import ABPNConfig, init_abpn, layers_from_numpy

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}; src: {os.path.abspath(args.src)}")
    dev = torch.device("cuda")
    # name -> (layers, mixed, frame counts)
    stacks = {"x3": (init_abpn(torch.Generator().manual_seed(0), device=dev), False, (1, 8))}
    wide = 48 in getattr(ttf, "SUPPORTED_CHP", ())
    if wide:
        x4 = layers_from_numpy(he_arrays(np, ABPNConfig(scale=4).channels, 40), device=dev)
        stacks["x4-wide"] = (x4, False, (1, 8))
        if hasattr(ttf, "hidden_chp"):
            stacks["x4-mixed"] = (x4, True, (1, 8))
        for f, counts in WIDE_F.items():
            ch = ABPNConfig(feature_channels=f).channels
            stacks[f"x3-F{f}"] = (layers_from_numpy(he_arrays(np, ch, 60 + f), device=dev),
                                  False, counts)
    if args.stacks:
        stacks = {k: v for k, v in stacks.items() if k in args.stacks}
    rlfb = hasattr(ttf, "EPI_CHP") and (not args.stacks or "rlfb" in args.stacks)
    gen = torch.Generator().manual_seed(1)
    out = {"card": card, "src": os.path.abspath(args.src)}
    for R, (name, (layers, mixed, counts)) in itertools.product(args.band_rows, stacks.items()):
        per_frame = -(-360 // R)  # bands of R rows a frame
        L = len(layers)
        cudnn = {dt: cudnn_stack(torch, layers, dt) for dt in (torch.float32, torch.bfloat16)}
        for n in counts:
            xb = torch.rand((n * per_frame, R, 640, 3), generator=gen).to(dev)
            nchw = xb.permute(0, 3, 1, 2).contiguous()
            kw = dict(width=640, tile_cols=8, relu_flags=[l.relu for l in layers],
                      in_channels=3, add_anchor=False)
            for prec, dt in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
                packed = ops.pack_stack([l.to(dtype=dt) for l in layers], dtype=dt)
                if mixed:
                    kw["hidden_channels"] = packed.hidden_channels
                xs, first = ops.band_streams(xb.to(dt), 8, L)
                ms = device_ms(torch, lambda: ttf.tilted_fusion_call(
                    xs, first, packed.w, packed.b, **kw), rounds=args.rounds)
                if R != 60:  # K1 alone, at this band height
                    plan = ttf.launch_plan(xs, packed.w, tile_cols=8, compute_dtype=dt,
                                           hidden_channels=kw.get("hidden_channels"))
                    hid = (ttf.hidden_chp(packed.chp, packed.hidden_channels, xs.shape[3], dt)
                           if mixed else None)
                    cost = ttf.launch_cost(plan, band_rows=R, tile_cols=8, c0p=xs.shape[3],
                                           chp=ttf.launch_chp(packed.chp, dt), num_layers=L,
                                           dtype=dt, **({"hidden_chp": hid} if mixed else {}))
                    route = getattr(ttf.tilted_fusion_call, "last_launch", None)
                    cell = dict(ms=ms, segments=plan.segments, ctas=plan.ctas,
                                workspace_mb=cost["workspace_bytes"] / 1e6,
                                route=route["route"] if route else "device")
                    out[f"{name}/{prec}/{n}/R{R}"] = cell
                    print(f"K1 {name} {prec} {n} frame{'s' if n > 1 else ''}, "
                          f"{xb.shape[0]} bands of {R} rows: {ms:.4f} ms queued "
                          f"(S={plan.segments}, {cell['route']} route, (b) "
                          f"{cell['workspace_mb']:.1f} MB)", flush=True)
                    continue
                nx = nchw.to(dt)
                lib_ms = device_ms(torch, lambda: cudnn[dt](nx), rounds=args.rounds)
                useful = useful_bound(layers, n * 360 * 640, prec, dt.itemsize, PEAKS)
                flops, bytes_ms = useful["flops"], useful["bytes_bound_ms"]
                cell = dict(ms=ms, cudnn_ms=lib_ms, gflop=flops / 1e9,
                            bound_ms=useful["bound_ms"], bound_by=useful["bound_by"],
                            bytes_bound_ms=bytes_ms)
                if name in K2_STACKS:
                    ls = [l.to(dtype=dt) for l in layers]
                    frames = [xb[6 * i:6 * i + 6].reshape(360, 640, 3).to(dt) for i in range(n)]

                    def k2_stack(frames=frames, ls=ls):
                        for x in frames:
                            for l in ls:
                                x = k2.conv3x3_call(x, l.w, l.b, relu=l.relu)

                    cell["k2_stack_ms"] = device_ms(torch, k2_stack, rounds=args.rounds)
                plan = ttf.launch_plan(xs, packed.w, tile_cols=8, compute_dtype=dt,
                                       hidden_channels=kw.get("hidden_channels"))
                if hasattr(ttf, "launch_cost"):
                    extra = {}
                    if mixed:
                        extra["hidden_chp"] = ttf.hidden_chp(packed.chp, packed.hidden_channels,
                                                             xs.shape[3], dt)
                    cost = ttf.launch_cost(plan, band_rows=60, tile_cols=8, c0p=xs.shape[3],
                                           chp=ttf.launch_chp(packed.chp, dt), num_layers=L,
                                           dtype=dt, **extra)
                    cell.update(executed_gflop=cost["flops"] / 1e9,
                                executed_mb=cost["bytes"] / 1e6,
                                io_mb=cost["io_bytes"] / 1e6,
                                workspace_mb=cost["workspace_bytes"] / 1e6)
                cell.update(segments=plan.segments, ctas=plan.ctas)
                out[f"{name}/{prec}/{n}"] = cell
                print(f"K1 {name} {prec} {n} frame{'s' if n > 1 else ''}: {ms:.4f} ms queued "
                      f"(S={plan.segments}); cuDNN stack {lib_ms:.4f} ms "
                      f"({lib_ms / ms:.2f}x K1's time); "
                      + (f"K2 stack {cell['k2_stack_ms']:.4f} ms ({cell['k2_stack_ms'] / ms:.2f}x "
                         f"K1's time); " if "k2_stack_ms" in cell else "")
                      + f"bound {cell['bound_ms']:.4f} ms "
                      f"({cell['bound_by']}; bytes {bytes_ms:.4f}) -> "
                      f"{100 * cell['bound_ms'] / ms:.1f}%; {flops / 1e9:.2f} GFLOP of the "
                      f"stack" + (f", K1 executes {cell['executed_gflop']:.2f} GFLOP "
                                  f"({cell['executed_gflop'] / ms:.1f} TFLOP/s) and moves "
                                  f"{cell['executed_mb']:.1f} MB ((a) {cell['io_mb']:.1f}, (b) "
                                  f"{cell['workspace_mb']:.1f})" if "executed_gflop" in cell
                                  else ""), flush=True)
    if rlfb:
        _time_rlfb(torch, np, ttf, ops, layers_from_numpy, dev, args.rounds, out)
    line = json.dumps(out)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            fh.write(line + "\n")
    print(line)
    return 0


def _time_rlfb(torch, np, ttf, ops, layers_from_numpy, dev, rounds, out):
    """The ``rlfb`` cells: K1's launch as the serving path makes it for an
    RLFB segment (``halo`` slabs, bounds, residual), and cuDNN's segment."""
    import dataclasses

    import torch.nn.functional as F
    from repro_torch.core.fusion import exact_fp32

    layers = [dataclasses.replace(l, relu=True, slope=0.05)
              for l in layers_from_numpy(he_arrays(np, [52] * 4, 52), device=dev)]
    L, R = len(layers), 60
    for n in (1, 8, 128):
        bands = 6 * n
        bounds = torch.tensor([[L, R + 2 * L]] + [[0, R + 2 * L]] * 4 + [[0, R + L]],
                              dtype=torch.int32, device=dev).repeat(n, 1)
        for prec, dt in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
            torch.manual_seed(n)
            xb = torch.rand((bands, R + 2 * L, 640, 52), device=dev).to(dt)
            res = torch.rand((bands, R, 640, 52), device=dev).to(dt)
            ls = [l.to(dtype=dt) for l in layers]
            packed = ops.pack_stack(ls, chp=64, dtype=dt)
            xs, first = ops.band_streams(xb, 8, L)
            del xb
            ms = device_ms(torch, lambda: ttf.tilted_fusion_call(
                xs, first, packed.w, packed.b, width=640, tile_cols=8,
                relu_flags=[True] * L, add_anchor=False, in_channels=52,
                hidden_channels=packed.hidden_channels, slopes=packed.slopes, residual=res,
                residual_offset=L, row_bounds=bounds), rounds=rounds)
            plan = ttf.launch_plan(xs, packed.w, tile_cols=8, compute_dtype=dt,
                                   hidden_channels=packed.hidden_channels)
            cost = ttf.launch_cost(plan, band_rows=R + 2 * L, tile_cols=8, c0p=xs.shape[3],
                                   chp=64, num_layers=L, dtype=dt, bounds=True,
                                   residual_elems=R * 640 * 52)
            del xs, first, res
            oihw = [(l.w.permute(3, 2, 0, 1).contiguous(), l.b) for l in ls]
            x = torch.rand((n, 52, 360, 640), device=dev).to(dt)

            def segment(x=x, oihw=oihw):
                with exact_fp32():
                    h = x
                    for w, b in oihw:
                        h = F.leaky_relu(F.conv2d(h, w, b, padding=1), 0.05)
                    return h + x

            lib_ms = device_ms(torch, segment, rounds=rounds)
            del x
            useful = useful_bound(layers, n * 360 * 640, prec, dt.itemsize, PEAKS)
            # the residual is read once more than a plain stack's input
            bytes_ms = useful["bytes_bound_ms"] + 1e3 * n * 360 * 640 * 52 * dt.itemsize / \
                PEAKS["bytes"]
            ops_ms = useful["bound_ms"] if useful["bound_by"] == "operations" else 0.0
            bound = max(ops_ms, bytes_ms)
            cell = dict(ms=ms, cudnn_ms=lib_ms, gflop=useful["flops"] / 1e9, bound_ms=bound,
                        executed_gflop=cost["flops"] / 1e9, executed_mb=cost["bytes"] / 1e6,
                        segments=plan.segments, ctas=plan.ctas)
            out[f"rlfb/{prec}/{n}"] = cell
            print(f"K1 rlfb {prec} {n} frame{'s' if n > 1 else ''}: {ms:.4f} ms queued "
                  f"(S={plan.segments}, {ms / n:.4f} ms a frame); cuDNN segment "
                  f"{lib_ms:.4f} ms ({lib_ms / ms:.2f}x K1's time); bound {bound:.4f} ms -> "
                  f"{100 * bound / ms:.1f}%; K1 executes {cell['executed_gflop']:.2f} GFLOP "
                  f"({cell['executed_gflop'] / ms:.1f} TFLOP/s), moves "
                  f"{cell['executed_mb']:.1f} MB", flush=True)
            torch.cuda.empty_cache()


if __name__ == "__main__":
    sys.exit(main())
