#!/usr/bin/env python3
"""The full-width LM train step with the stacked blocks sliced two ways, on
one CUDA card.

Run from the root of a checkout, on a machine with an NVIDIA card:

    python3 tools/train_step_ablation.py [--steps 8]

``models.lm`` slices the stacked block parameters into layers with one
``unbind`` per leaf, whose backward writes the stacked gradient once.  The
``select`` variant indexes each layer apart (``t[i]``), whose backward adds
a zero-filled gradient of the whole stack per layer.  Both compute the same
gradient.  For qwen2-0.5b at full width and depth (bf16 activations, fp32
parameters, ``remat="full"``, random weights from seed 0), one fixed batch
of 4 x 128 tokens, it runs the variants in the order select, unbind,
unbind, select: two warm-up steps, ``--steps`` steps timed with CUDA events
(the median), then the card's busy ms and kernels per step over 3 steps
under ``torch.profiler``.  It prints the card's name and power limit, one
line per run and one JSON line.

Exits 2 without a CUDA device.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=8)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("train_step_ablation: no CUDA device is available", file=sys.stderr)
        return 2
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.config import TrainConfig
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import lm_batch
    from repro_torch.distributed.steps import init_train_state, make_train_step
    from repro_torch.layers.params import tree_map
    from repro_torch.models import lm

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60,
                         check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    dev = torch.device("cuda")
    cfg = get_config("qwen2-0.5b")
    tcfg = TrainConfig(learning_rate=1e-3, warmup_steps=2, total_steps=30)
    state = init_train_state(cfg, tcfg, torch.Generator(device=dev).manual_seed(0), dev)
    step = make_train_step(cfg, tcfg)
    batch = lm_batch(cfg, 0, 4, 128, device=dev)
    unbind = lm._unstack

    def select(tree, n):
        return [tree_map(lambda t: t[i], tree, is_leaf=lambda t: not isinstance(t, dict))
                for i in range(n)]

    runs = []
    for name in ("select", "unbind", "unbind", "select"):
        lm._unstack = {"select": select, "unbind": unbind}[name]
        for _ in range(2):
            step(state, batch)
        times = []
        for _ in range(args.steps):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            step(state, batch)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                step(state, batch)
            torch.cuda.synchronize()
        spans = [e.time_range.end - e.time_range.start for e in prof.events()
                 if e.device_type == DeviceType.CUDA]
        run = {"variant": name, "ms": statistics.median(times), "step_ms": times,
               "busy_ms": sum(spans) / 1e3 / 3 if spans else None,
               "kernels_per_step": len(spans) / 3}
        runs.append(run)
        busy = "not measured" if run["busy_ms"] is None else f"{run['busy_ms']:.3f} ms"
        print(f"{name}: {run['ms']:.3f} ms a step (median of {args.steps}), card busy {busy}, "
              f"{run['kernels_per_step']:.0f} kernels and copies a step ({smi})", flush=True)
    lm._unstack = unbind
    print(json.dumps({"card": smi, "runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
