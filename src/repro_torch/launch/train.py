"""Training entry point: ``python -m repro_torch.launch.train --arch qwen2-0.5b ...``
— the port of ``repro.launch.train``.

Runs the resilient training loop (checkpoint/restart, straggler detection)
on the CUDA card (``--device cpu`` runs it on the CPU).  ``--reduced`` (the
default) shrinks the model for laptop-scale runs; ``--full`` trains the
published widths.  Every LM family is ported (an encoder-decoder model
trains on a random ``src`` of ``--seq`` frame embeddings a step).  Prints
the reference's lines and
returns 0 when the mean loss of the last half of the steps is at most 1.05x
that of the first half.
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time

import torch

from repro_torch.config import TrainConfig, resolve_device
from repro_torch.configs import LM_ARCH_IDS, get_config
from repro_torch.data.synthetic import lm_batch, step_generator, to_device
from repro_torch.distributed.steps import init_train_state, make_train_step
from repro_torch.layers.params import tree_leaves
from repro_torch.runtime.resilience import resilient_train_loop


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b", choices=LM_ARCH_IDS)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--checkpoint-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (default cuda; cpu runs on the CPU)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced(remat="none")
    tcfg = TrainConfig(
        learning_rate=args.lr, total_steps=args.steps,
        warmup_steps=max(args.steps // 20, 5),
        checkpoint_every=args.checkpoint_every, seed=args.seed,
    )
    devices = torch.cuda.device_count() if device.type == "cuda" else 1
    print(f"arch={cfg.name} reduced={args.reduced} devices={devices}")
    gen = torch.Generator(device=device).manual_seed(args.seed)
    state = init_train_state(cfg, tcfg, gen, device)
    n_params = sum(x.numel() for x in tree_leaves(state["params"]))
    print(f"params: {n_params/1e6:.2f}M")

    step_fn = make_train_step(cfg, tcfg)
    losses = []

    def batch_fn(step):
        b = lm_batch(cfg, step, args.batch, args.seq, args.seed, device=device)
        if cfg.family == "vlm":
            front = torch.randn((args.batch, cfg.frontend_tokens, cfg.d_model),
                                generator=step_generator(99, step))
            b["frontend"] = to_device(front, device)
        if cfg.family == "encdec":
            src = torch.randn((args.batch, args.seq, cfg.d_model),
                              generator=step_generator(98, step))
            b["src"] = to_device(src, device)
        return b

    t0 = time.time()

    def on_metrics(step, metrics):
        losses.append(float(metrics["total_loss"]))
        if step % args.log_every == 0:
            dt = (time.time() - t0) / max(len(losses), 1)
            print(f"step {step:5d} loss {losses[-1]:.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f} ({dt:.2f}s/step)")

    state, report = resilient_train_loop(
        init_state=state, train_step=step_fn, batch_fn=batch_fn,
        total_steps=args.steps, ckpt_dir=args.ckpt_dir, cfg=cfg,
        checkpoint_every=args.checkpoint_every, on_metrics=on_metrics,
    )
    half = max(len(losses) // 2, 1)
    first = sum(losses[:half]) / half
    last = sum(losses[-half:]) / half
    print(f"done: loss {first:.4f} -> {last:.4f} "
          f"(restarts={report['restarts']}, stragglers={len(report['stragglers'])})")
    # success = training ran to completion without divergence
    return 0 if (last <= first * 1.05 and last == last) else 1


if __name__ == "__main__":
    raise SystemExit(main())
