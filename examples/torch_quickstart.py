"""Quickstart: tilted layer fusion in three executors, with the PyTorch
package (``repro_torch``) — the twin of ``examples/quickstart.py``.

Runs the paper's ABPN x3 super-resolution model over a synthetic image via
(1) the plain layer-by-layer reference, (2) the tilted fusion in plain
PyTorch (``halo`` bands), and (3) the ``kernel`` backend, which launches the
hand-written CUDA kernel on the card (on the CPU it runs the kernel's plain
version), then prints the equivalence deltas, an ``SRSession``'s plan-cache
counters and the modeled buffer/bandwidth numbers of the paper's Tables
I/II.  Runs on the CUDA card unless ``--device cpu`` is given:

    PYTHONPATH=src python examples/torch_quickstart.py
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu
"""

import argparse
import sys

import torch

from repro_torch import engine
from repro_torch.config import resolve_device
from repro_torch.core.analysis import buffer_sizes, dram_reduction, pe_throughput_model
from repro_torch.data.synthetic import sr_pair_batch
from repro_torch.models.abpn import ABPNConfig, init_abpn


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--height", type=int, default=120)
    ap.add_argument("--width", type=int, default=64)
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default cuda; cpu runs on the CPU)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = ABPNConfig()
    layers = init_abpn(0, cfg, device=device)
    lr, _ = sr_pair_batch(0, 1, lr_shape=(args.height, args.width), scale=cfg.scale,
                          device=device)
    print(f"LR {tuple(lr.shape[1:])} -> HR x{cfg.scale} on {device}")

    # One plan per backend; each runs the (here: single-frame) batch in one
    # engine call.
    def plan(backend, policy="zero"):
        return engine.make_plan(layers, tuple(lr.shape[1:]), backend=backend,
                                vertical_policy=policy, scale=cfg.scale)

    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):  # fp32 is fp32
        ref = engine.run(plan("reference"), layers, lr, device=device)[0]
        tilted = engine.run(plan("tilted", "halo"), layers, lr, device=device)[0]
    kernel = engine.run(plan("kernel"), layers, lr, device=device)[0]
    print(f"reference vs tilted(halo): max|d| = {float((ref - tilted).abs().max()):.2e}  (exact)")
    print(f"reference vs kernel: max|d| = {float((ref - kernel).abs().max()):.2e}  "
          f"(band-boundary rows only)")

    # Shape/batch-agnostic serving: the same weights behind an SRSession —
    # any request shape, plans derived and built on demand into the cache.
    session = engine.SRSession.open("abpn_x3", layers=layers, backend="tilted",
                                    device=device, autotune="off")
    session.upscale(lr)                          # (T, H, W, C) clip
    session.upscale(lr[0, :args.height // 2])    # a single half-height frame, new plan
    c = session.cache_stats()
    print(f"SRSession: {c['misses']} compiles, {c['hits']} hits for "
          f"{[tuple(e['lr_shape'][:2]) for e in c['entries']]}")

    b = buffer_sizes()
    print(f"\non-chip buffers: {b['total_kb']:.2f} KB (paper: 102.36 KB)")
    print(f"DRAM bandwidth reduction: {dram_reduction()*100:.1f}% (paper: 92%)")
    pe = pe_throughput_model()
    print(f"throughput model: {pe['mpix_s_at_target']:.1f} Mpix/s @ "
          f"{pe['utilization']*100:.0f}% MAC utilisation (paper: 124.4 @ 87%)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
