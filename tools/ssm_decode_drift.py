#!/usr/bin/env python3
"""Where fp32 decode drifts from the forward in a deep Mamba stack.

Run from the root of a checkout:

    python3 tools/ssm_decode_drift.py [--arch zamba2-2.7b] [--device cuda]
        [--width W] [--ssd fp32 fp64]

For the config of ``--arch`` (mamba2-130m or zamba2-2.7b; full width and
depth, or ``--width W`` with the heads scaled to it, for a CPU run), random
fp32 weights from seed 0 and 4 x 129 random tokens, it runs ``forward``
over 129 tokens and ``prefill`` over 128 then ``decode_step`` of token 128,
and records the hidden state of the last token after every Mamba layer
and shared-block application in both.  It prints, for every sixth block
and the last, their relative L2 distance, then the logits' max abs diff,
the largest |logit|, the worst row's relative L2 and the excess over
``atol 2e-4, rtol 1e-3`` (unscaled, and with atol scaled by the largest
|logit| above 1, as ``chip_smoke.py`` phase 4h holds it).  ``--ssd fp64``
runs ``layers.ssd``'s chunked and decode functions in float64 (a copy of
their source with float32 replaced), to show whether the SSD or the rest
of the block carries the drift.  Each variant prints one JSON line.
"""

import argparse
import dataclasses
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

S, B = 128, 4


def _ssd_in_fp64(ssd):
    """Swap ``ssd.ssd_chunked`` / ``ssd.ssd_decode_step`` for float64
    copies; returns a function that puts the originals back."""
    ns = {}
    with open(ssd.__file__) as f:
        exec(compile(f.read().replace("torch.float32", "torch.float64"), "ssd_fp64", "exec"), ns)
    real = ssd.ssd_chunked, ssd.ssd_decode_step

    def chunked(x, dt, A, Bm, Cm, chunk, h0=None):
        y, h = ns["ssd_chunked"](x.double(), dt, A, Bm, Cm, chunk, h0)
        return y.to(x.dtype), h.float()

    def step(h, x, dt, A, Bm, Cm):
        h2, y = ns["ssd_decode_step"](h, x.double(), dt, A, Bm, Cm)
        return h2.float(), y.to(x.dtype)

    ssd.ssd_chunked, ssd.ssd_decode_step = chunked, step

    def restore():
        ssd.ssd_chunked, ssd.ssd_decode_step = real
    return restore


def run(torch, arch, device, width, ssd_dtype):
    from repro_torch.configs import get_config
    from repro_torch.distributed.steps import init_cache
    from repro_torch.layers import ssd
    from repro_torch.layers.params import init_params
    from repro_torch.models import mamba_lm, zamba
    from repro_torch.models.registry import get_model

    cfg = dataclasses.replace(get_config(arch), dtype="float32")
    if width:
        heads = max(1, width // cfg.head_dim)
        cfg = dataclasses.replace(cfg, d_model=width, d_ff=4 * width, num_heads=heads,
                                  num_kv_heads=heads)
    model = get_model(cfg)
    gen = torch.Generator(device=device).manual_seed(0)
    params = init_params(model.schema(cfg), gen, torch.float32, device)
    tokens = torch.randint(0, cfg.vocab_size, (B, S + 1), generator=gen, dtype=torch.int32,
                           device=device)
    module = zamba if cfg.family == "hybrid" else mamba_lm
    seen = []
    real_layer = module.mamba_layer
    real_shared = zamba._shared_apply

    def layer(lp, c, x, lc, mode):
        y = real_layer(lp, c, x, lc, mode)
        seen.append((f"mamba {sum(k == 'm' for _, k, _ in seen)}", "m", y[:, -1].clone()))
        return y

    def shared(sp, c, x, pos, kv, cache_pos, mode):
        y = real_shared(sp, c, x, pos, kv, cache_pos, mode)
        seen.append((f"shared {sum(k == 's' for _, k, _ in seen)}", "s", y[:, -1].clone()))
        return y

    restore = _ssd_in_fp64(ssd) if ssd_dtype == "fp64" else (lambda: None)
    module.mamba_layer, zamba._shared_apply = layer, shared
    try:
        with torch.no_grad():
            seen.clear()
            want = model.forward(params, cfg, tokens)[0][:, S]
            fwd = list(seen)
            cache = init_cache(cfg, B, S + 4, device)
            _, cache = model.prefill(params, cfg, {"tokens": tokens[:, :S]}, cache)
            seen.clear()
            got, _ = model.decode_step(params, cfg, tokens[:, S:S + 1], cache, S)
            dec = list(seen)
    finally:
        module.mamba_layer, zamba._shared_apply = real_layer, real_shared
        restore()
    drift = [(name, float((a - b).norm() / a.norm()))
             for (name, _, a), (_, _, b) in zip(fwd, dec)]
    for i, (name, rel) in enumerate(drift):
        if i % 6 == 0 or i == len(drift) - 1:
            print(f"  {name}: last token's hidden state, decode vs forward, relative L2 {rel:.3e}")
    err = (got - want).abs()
    largest = float(want.abs().max())
    plain = float((err / (2e-4 + 1e-3 * want.abs())).max())
    scaled = float((err / (2e-4 * max(1.0, largest) + 1e-3 * want.abs())).max())
    rows = float(((got - want).norm(dim=-1) / want.norm(dim=-1)).max())
    rec = {"arch": arch, "d_model": cfg.d_model, "ssd": ssd_dtype, "device": str(device),
           "block_drift_first": drift[0][1], "block_drift_last": drift[-1][1],
           "logits_max_abs": float(err.max()), "largest_logit": largest,
           "logits_row_rel_l2": rows, "excess_unscaled": plain, "excess_scaled": scaled}
    print(f"{arch} (d_model {cfg.d_model}, SSD in {ssd_dtype}, {device}): logits max abs diff "
          f"{rec['logits_max_abs']:.3e}, largest |logit| {largest:.3f}, worst row relative L2 "
          f"{rows:.3e}; excess {plain:.3f} unscaled, {scaled:.3f} scaled")
    print(json.dumps(rec))
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="zamba2-2.7b", choices=["zamba2-2.7b", "mamba2-130m"])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--width", type=int, default=0, help="d_model (default: the published one)")
    ap.add_argument("--ssd", nargs="+", default=["fp32", "fp64"], choices=["fp32", "fp64"])
    args = ap.parse_args(argv)
    import torch

    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            print("ssm_decode_drift: no CUDA device is available", file=sys.stderr)
            return 2
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip())
    for ssd_dtype in args.ssd:
        run(torch, args.arch, device, args.width, ssd_dtype)
    return 0


if __name__ == "__main__":
    sys.exit(main())
