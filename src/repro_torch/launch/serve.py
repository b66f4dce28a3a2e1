"""Serving entry point: batched prefill + greedy decode with KV caches — the
port of ``repro.launch.serve``.

``python -m repro_torch.launch.serve --arch qwen2-0.5b --batch 4
--prompt-len 64 --gen 32`` serves the reduced model of ``--arch`` on the
CUDA card (``--device cpu`` runs it on the CPU).  Every LM family is
ported; an encoder-decoder model encodes a random ``src`` of
``--prompt-len`` frame embeddings, and its cache holds exactly that many.
Tokens stay on the device between decode steps: the loop makes no host
copy, and the times end with a device synchronize.
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.config import resolve_device
from repro_torch.configs import LM_ARCH_IDS, get_config
from repro_torch.distributed.steps import init_cache, make_decode_step, make_prefill_step
from repro_torch.layers.params import init_params
from repro_torch.models.registry import get_model


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b", choices=LM_ARCH_IDS)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (default cuda; cpu runs on the CPU)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch).reduced()
    model = get_model(cfg)
    gen = torch.Generator(device=device)
    params = init_params(model.schema(cfg), gen.manual_seed(args.seed), cfg.weight_dtype, device)
    B, S = args.batch, args.prompt_len
    extra = cfg.frontend_tokens if cfg.family == "vlm" else 0
    max_len = S + extra + args.gen
    cache = init_cache(cfg, B, max_len, device,
                       enc_len=S if cfg.family == "encdec" else None)

    gen.manual_seed(args.seed + 1)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                                     dtype=torch.int32, device=device)}
    if cfg.family == "vlm":
        batch["frontend"] = torch.randn((B, cfg.frontend_tokens, cfg.d_model),
                                        generator=gen, device=device)
    if cfg.family == "encdec":
        batch["src"] = torch.randn((B, S, cfg.d_model), generator=gen, device=device)

    prefill = make_prefill_step(cfg)
    decode = make_decode_step(cfg)

    t0 = time.time()
    logits, cache = prefill(params, batch, cache)
    _sync(device)
    t_prefill = time.time() - t0
    tokens = torch.argmax(logits, -1)[:, None].to(torch.int32)
    generated = [tokens]
    t1 = time.time()
    for i in range(args.gen - 1):
        logits, cache = decode(params, tokens, cache, S + extra + i)
        tokens = torch.argmax(logits, -1)[:, None].to(torch.int32)
        generated.append(tokens)
    _sync(device)
    t_decode = time.time() - t1
    out = torch.cat(generated, dim=1)
    tok_s = B * (args.gen - 1) / max(t_decode, 1e-9)
    print(f"arch={cfg.name} batch={B} prompt={S} gen={args.gen}")
    print(f"prefill: {t_prefill*1e3:.1f} ms   decode: {tok_s:.1f} tok/s "
          f"({t_decode/max(args.gen-1,1)*1e3:.1f} ms/step)")
    print("sample token ids:", out[0, :12].tolist())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
