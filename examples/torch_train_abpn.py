"""End to end: train the paper's ABPN model on synthetic SR pairs with
the PyTorch package (``repro_torch``) — the twin of ``examples/train_abpn.py``.

Plain SGD in fp32 on the L1 loss, by autograd through
``models.abpn.apply_abpn(method="reference")``, the layer-by-layer conv
stack; PSNR against the nearest-neighbour anchor is printed every 25 steps.
Runs on the CUDA card unless ``--device cpu`` is given:

    PYTHONPATH=src python examples/torch_train_abpn.py --steps 300
    PYTHONPATH=src python examples/torch_train_abpn.py --steps 4 --batch 2 --device cpu
"""

import argparse
import math
import sys
import time

import torch

from repro_torch.config import resolve_device
from repro_torch.core.fusion import ConvLayer
from repro_torch.data.synthetic import sr_pair_batch
from repro_torch.models.abpn import ABPNConfig, apply_abpn, depth_to_space, init_abpn, make_anchor


def psnr(a, b) -> float:
    mse = float(torch.mean((a - b) ** 2))
    return 10 * math.log10(1.0 / max(mse, 1e-12))


def upscale(layers, lr_b, cfg):
    """HR batch through ``apply_abpn(method="reference")``, one image at a
    time (the reference vmaps the same call)."""
    return torch.stack([apply_abpn(layers, im, cfg, method="reference", device=im.device)
                        for im in lr_b])


def trainable(layers):
    """The stack with every weight and bias a leaf tensor that records
    gradients."""
    return [ConvLayer(w=l.w.detach().clone().requires_grad_(),
                      b=l.b.detach().clone().requires_grad_(), relu=l.relu) for l in layers]


def sgd_step(layers, lr_b, hr_b, cfg, lr: float) -> torch.Tensor:
    """One step of plain SGD on the mean absolute error; updates ``layers``
    in place and returns the loss before the step (a 0-d tensor)."""
    loss = torch.mean(torch.abs(upscale(layers, lr_b, cfg) - hr_b))
    params = [t for l in layers for t in (l.w, l.b)]
    grads = torch.autograd.grad(loss, params)
    with torch.no_grad():
        for p, g in zip(params, grads):
            p.sub_(lr * g)
    return loss.detach()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=2e-3)
    ap.add_argument("--size", type=int, default=24)
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (default cuda; cpu runs on the CPU)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = ABPNConfig()
    layers = trainable(init_abpn(0, cfg, device=device))
    size = (args.size, args.size)

    val_lr, val_hr = sr_pair_batch(10_000, 8, lr_shape=size, device=device)
    anchor_up = depth_to_space(make_anchor(val_lr, cfg.scale), cfg.scale)
    print(f"anchor (nearest-neighbour) baseline PSNR: {psnr(anchor_up, val_hr):.2f} dB")

    t0 = time.time()
    for i in range(args.steps):
        lr_b, hr_b = sr_pair_batch(i, args.batch, lr_shape=size, device=device)
        loss = sgd_step(layers, lr_b, hr_b, cfg, args.lr)
        if i % 25 == 0 or i == args.steps - 1:
            with torch.no_grad():
                out = upscale(layers, val_lr, cfg)
            print(f"step {i:4d}  loss {float(loss):.4f}  val PSNR {psnr(out, val_hr):.2f} dB"
                  f"  ({(time.time()-t0)/(i+1):.2f}s/step)")
    print("done — the model beats its anchor whenever PSNR exceeds the baseline")
    return 0


if __name__ == "__main__":
    sys.exit(main())
