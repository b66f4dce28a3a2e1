#!/usr/bin/env python3
"""Smoke run of the PyTorch package (src/repro_torch) on one CUDA card.

Run from the root of a checkout, on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, each printing its lines; any failed check raises and the script
exits non-zero (nothing is caught, except that phase 4h runs each of its
parts to the end and then fails with every failure listed):

1. environment — ``nvidia-smi`` name and power limit, torch and CUDA versions;
2. build — compiles every CUDA kernel from ``src/repro_torch/kernels/csrc``
   with nvcc (one process per source, started together) and prints each
   template instance's registers, stack, shared and local memory, K1's
   resident CTAs per SM for each instance, and K2's shared memory per CTA
   and resident CTAs per SM;
3. K1 vs plain — K1 against ``tilted_fusion_plain`` on the card at the
   design point (the 6 bands of a 360x640 frame under zero and replicate,
   the 74-row halo slabs with bounds, the anchor) in fp32 (max abs diff
   <= 5e-4) and bf16 (<= 5e-2), on ABPN x3 weights from seed 0 with
   seeded non-zero biases (``init_abpn`` zeroes them); and K1 with
   ``segments`` 1, 2, 3, the automatic plan and K must be bit-identical;
3b. K2 vs plain — K2 against ``conv3x3_plain`` on the card at the seven
   ABPN x3 layer shapes over one 360x640 frame (the stack of phase 3, each
   layer fed the previous layer's features) and at a width that is not a
   tile multiple, in fp32 (|diff| <= 2e-5 + 1e-5 |want|, K2's 3xTF32 held
   to the fp32 tolerance) and bf16 (<= 2e-2 + 2e-2 |want|, the JAX
   package's K2 tolerances);
4. main path — ``SRServer.open("abpn_x3", backend="kernel", precision=p,
   layers=...)`` at full ABPN x3 width (the stack of phase 3) serves a 4-frame
   360x640 request, two 2-frame requests that coalesce into one dispatch,
   and a 180x320 frame, for fp32/bf16/int8 under zero and halo and fp32
   under replicate; every HR result is held against the package's
   ``tilted`` backend on the card (TF32 off) at 5e-4 (fp32, int8) / 5e-2
   (bf16), a frame served alone must equal the same frame served in the
   batch bit for bit, and K1's launch counter, zeroed just before, must
   have moved;
4b. layer-by-layer path — ABPN x3 over two 360x640 frames as 7
   ``ops.conv3x3`` launches per frame plus ``engine.sr_epilogue``, fp32 and
   bf16, held against ``engine.run`` on the ``reference`` backend (TF32
   off) at 5e-4 / 5e-2; K2's launch counter, zeroed just before, must have
   moved;
4c. temporal delta path — K1 against its plain version at the delta path's
   shapes (one dirty band; three halo bands padded to four slots, the pad's
   bounds (0, 0)), each real band bit-identical to the same band of the
   full-frame launch; then ``SRServer.open("abpn_x3", backend="kernel")``
   serves a six-frame 360x640 clip (random, static, a patch in band 2,
   patches in bands 0 and 5, random, static) through
   ``server.stream(clip, delta=True)`` for fp32 under zero, replicate and
   halo and bf16 under zero: every HR frame must equal
   ``server.submit(frame).result()`` bit for bit, the bands skipped per
   frame must be the clip's, no splice rule may fail, K1's launch counter
   (zeroed just before) must move, and a stream abandoned after two frames
   must leave no pinned cache entry and no queued request; once (fp32,
   zero): a request past its deadline fails while its neighbour serves, an
   injected dispatch failure fails only its request, and degrade level 1
   serves fp32 requests in bf16 within 5e-2 of ``tilted``;
4d. autotune and static analysis — ``RooflinePeaks.detect`` on the card
   (printed beside the data-sheet ``PEAKS``); ``engine.autotune.tune`` for
   fp32 ``halo`` at batch 8 on the ``kernel`` backend at 360x640: every
   candidate's predicted and measured ms per frame, the winner, default vs
   tuned ms per frame (the tuned must not be slower) and the sweep's
   seconds; a ``halo`` session at every candidate ``band_rows`` must equal
   the default's output bit for bit in fp32 and bf16; a server opened with
   ``autotune="full"`` (a tuning sweep on its first request) must serve
   that request bit-identical to an ``autotune="off"`` server; the tuned
   sessions' program audit and ``analysis_report()`` (the lint, the plan
   grid, and the program sweep with the ``kernel`` backend in fp32, bf16
   and int8) must hold no error; K1's launch counter, zeroed just before,
   must move.  The tuning DBs are ``build/chip_smoke_tuning*.json``, made
   afresh each run;
4e. sharded serving — every mesh position is this card, each with its own
   stream (``make_sr_mesh(R, S, devices=[cuda:0] * (R * S))``), so the
   positions are streams of one GPU, not GPUs.  ``build_sharded_executor``
   at 8 frames of 360x640 must equal the single-device kernel executor
   bit for bit (``torch.equal``) for fp32/bf16/int8 under zero, halo and
   replicate at S = 2 (R = 60) and S = 4 (re-banded to R = 45, against a
   single-device plan with the same R), launching K1 once per shard; K1's
   segment plan per shard is printed.  A ``(2, 2)`` mesh session behind
   ``SRServer`` (fp32, halo and zero) serves 8 closed-loop 2-frame
   requests ``torch.equal`` to an unsharded server's, with both replicas
   dispatched (``sharding_stats()`` printed); ``server.stream(clip,
   delta=True)`` on it gives every frame ``torch.equal`` to
   ``server.submit(frame).result()`` with the clip's bands skipped; and
   ``program_audit.audit_server`` finds its launch clean.  K1's launch
   counter, zeroed just before the served part, must move.  Times: the
   sharded executor at 8 frames (fp32, zero and halo, S = 1, 2, 4, queued)
   beside the single-device executor at the same R, and the ``(2, 2)``
   server's frames/s over 20 closed-loop 8-frame requests of host frames
   beside an unsharded server's;
4f. LM serving — ``launch/serve.py``'s step functions
   (``make_prefill_step``/``make_decode_step``) over qwen2-0.5b at its full
   width and depth (24 layers, d_model 896, 14/2 heads of 64, d_ff 4864,
   vocab 151936, tied, fp32 weights from a ``torch.Generator`` on the card,
   QKV biases seeded non-zero): batch 4, a 128-token random prompt, 32
   greedy tokens, in bf16 (the config's) and fp32 activations; logits
   finite and (4, 151936) after prefill and every decode step; bf16 vs fp32
   prefill logits within a relative L2 of 0.05 and a max abs diff of 0.1 of
   the largest logit (the greedy tokens printed); fp32 prefill over 128
   then decode of token 128 == ``forward`` over 129 at position 128
   (``atol 2e-4, rtol 1e-3``, the reference's); fp32 prefill logits of a
   16-token prompt on the card == on the CPU (the same tolerance).  Times:
   prefill ms, decode ms per step and tokens/s (CUDA events), the device's
   busy time per step (``torch.profiler``), each decode step's HBM bound
   (weights as stored + the bf16 copies that casting at use writes and
   reads + the KV cache, at the calibrated rate of phase 4d) and the
   prefill's bound;
4g. training — qwen2-0.5b at full width and depth (``remat="full"``): the
   flash backward in fp32 with the config's head layout (Kh 2, G 7, D 64),
   batch 2, causal, S = 128 (one KV chunk) and 512 (four of 128), ``dq``,
   ``dk``, ``dv`` against autograd through a direct softmax (``atol 5e-5,
   rtol 1e-3``, the reference's); ``steps.compute_grads`` in fp32 at batch
   1 x 32 tokens on the card vs the CPU on the same weights (every leaf
   within a relative L2 of 1e-4), and ``remat="full"`` vs ``"none"`` on the
   card (within 1e-5; the peak memory of each call above what was allocated
   before it);
   ``launch.train.main(["--full", "--steps", "8", "--batch", "4", "--seq",
   "128", "--checkpoint-every", "0", ...])`` returns 0 with finite losses
   and grad norms; ``make_train_step`` on one fixed 4 x 128 batch (bf16
   activations, fp32 parameters, lr 1e-3) brings the loss below 0.9x its
   first within 12 steps, every step finite.  Times: the step's ms (CUDA
   events, median of steps 3-12) and tokens/s, its peak memory, the card's
   busy ms and kernels per step over a 3-step ``torch.profiler`` window with
   the five costliest kernels, beside the step's bounds (its operations at
   the bf16 tensor-core peak; AdamW's bytes at the calibrated HBM rate).
   Then ``resilient_train_loop`` on the card (2 layers of width 32, failures
   injected at steps 7 and 13, a checkpoint every 5 in a temporary
   directory): 2 restarts, step 20 reached, the optimizer at >= 18, and the
   final parameters' max abs diff from an uninterrupted run.  Then ABPN
   training through ``examples/torch_train_abpn.py``'s step (12 channels,
   4 layers, 24x24, 60 SGD steps at lr 0.02, fp32, TF32 off) must gain more
   than 0.5 dB of PSNR, and ``examples/torch_quickstart.py`` on the card
   must print ``reference vs tilted(halo)`` as ``0.00e+00`` (its ``kernel``
   backend launches K1 once, outside the counted paths);
4h. LM families — ``make_prefill_step``/``make_decode_step`` over
   deepseek-v2-236b (3 layers: the dense MLA prologue and 2 MoE+MLA
   layers), arctic-480b (1 layer), mamba2-130m and zamba2-2.7b at their
   published widths (mamba2 and zamba2 at full depth), weights from a
   ``torch.Generator`` in fp32: batch 4, a 128-token prompt, 32 greedy
   tokens in fp32, then in bf16 activations (the MoE configs' parameters
   cast to bf16 in place, as they store them); logits finite and (4, V) at
   every step; fp32 decode of token 128 after prefill == ``forward`` over
   129 (the MoE configs at capacity factor E, since decode is dropless)
   and fp32 prefill logits of a 16-token prompt at batch 1 card == CPU
   (not arctic), both at ``rtol 1e-3`` and ``atol 2e-4`` per unit of the
   largest |logit| above 1 (the unscaled excess printed beside it); the
   MoE metrics of ``forward`` finite; bf16 vs fp32: for the MoE configs
   the share of agreeing top-k
   picks, and the forward logits over the positions whose picks and kept
   claims agree in every layer within a relative L2 of 0.05 and a max abs
   diff of 0.1 of the largest logit; for mamba2 and zamba2 the same rule
   layer by layer (each Mamba layer and shared-block application on the
   fp32 run's input; the end-to-end logits printed, not held).  Then
   ``compute_grads`` for deepseek-v2 at 2 layers in bf16 over 1 x 32
   tokens (every leaf finite, the router's non-zero) and ``make_train_step``
   on mamba2-130m over one fixed 4 x 128 batch (the loss below 0.9x its
   first within 12 steps).  Times per architecture and precision: prefill
   ms, decode ms per step and tokens/s (CUDA events), the card's busy ms
   and kernels per step (``torch.profiler``), peak memory, and the decode
   step's HBM bound (weights as stored, every expert included, + the
   copies casting at use writes and reads + the cache); a
   ``lm_families: {...}`` JSON line;
5. times — CUDA events, median of repeats after warm-up.  K1 at 1 and 8
   frames (fp32 and bf16, automatic segment plan: its segments, CTAs,
   warm-up tiles and their share of the executed tiles) four ways: one
   launch between two events, host time of the wrapper included (the
   kernels line's ``ms``); launches queued behind a
   device sleep (device time only); the wrapper's host time per call; the
   kernel's duration in ``torch.profiler``.  Beside it its plain version,
   the same conv stack as cuDNN calls (``library_ms``, the yardstick only,
   timed both ways) and K1's bound from the unpadded ABPN work.  K1 at
   forced segment counts 1..81 (device time) beside the plan's cost model.
   K2 per launch at the 3->28, 28->28 and 28->27 shapes and the 7-launch
   stack per 360x640 frame, fp32 and bf16, each beside its tensor-core
   bound (fp32 as 3xTF32), the CUDA-core bound, its plain version and
   cuDNN ``conv2d`` (+ ReLU) in fp32 (TF32 off) and bf16, timed over
   launches queued behind a sleep (the frame also as one call between two
   events), with its tiles and persistent CTAs; the stack's per-layer
   split under ``torch.profiler`` (the last 35 of 42 kernels, cut by name);
   the bytes per frame of the layer-by-layer stack and of K1; the server's
   frames/s over the wall clock of 20 closed-loop 8-frame requests, and
   their p50 launch-to-completion latency; the delta path (fp32, zero): ms
   per frame of a full re-upscale, and of a delta frame with 0, 1 and 6
   dirty bands split into digest, dispatch and splice; K1 at 1, 3 and 4 (3
   real + 1 padded) bands beside its bound for that work;
6. the kernels line, then the card's name and power limit, then the result.

Exits 2 and prints no result when no CUDA device is present.
"""

import dataclasses
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

H, W, SCALE = 360, 640, 3  # the paper's design point: 360x640 -> 1080x1920
TOL = {"fp32": 5e-4, "int8": 5e-4, "bf16": 5e-2}

# Published peaks of the H100 SXM5 (NVIDIA data sheet; dense, without
# sparsity): FP32 on the CUDA cores, TF32 and bf16 on the tensor cores in
# FLOP/s, device memory in bytes/s.  K1 runs fp32 FMAs on the CUDA cores for
# fp32 and bf16 plans alike; K2 runs on the tensor cores (fp32 as 3xTF32).
PEAKS = {"H100 80GB HBM3": dict(fp32=67e12, tf32=495e12, bf16=989e12, bytes=3.35e12)}


def require(cond, msg):
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def phase(name):
    print(f"== {name}", flush=True)


def peaks_for(name):
    for key, val in PEAKS.items():
        if key in name:
            return key, val
    raise RuntimeError(f"no published peaks recorded for {name!r}")


def time_ms(torch, fn, reps, warmup=1):
    """Median milliseconds of ``fn`` on the current stream (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(torch, fn, calls=20, rounds=5):
    """Median device milliseconds per call of ``fn``: each round queues
    ``calls`` calls behind a ~20 ms device sleep, so the host enqueues them
    all before the card reaches the start event and host time between
    launches is not measured."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(40_000_000)  # cycles: ~20 ms at the H100's ~2 GHz
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def host_ms(torch, fn, calls=10):
    """Host milliseconds per call of ``fn`` while the card is busy behind a
    ~20 ms device sleep: what the caller's thread spends before ``fn``
    returns, none of it waiting for the card."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(40_000_000)
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    elapsed = time.perf_counter() - t0
    torch.cuda.synchronize()
    return elapsed * 1e3 / calls


def profiler_kernel_ms(torch, fn, kernel, calls=5):
    """Median device milliseconds of the kernels named ``kernel`` that
    ``calls`` calls of ``fn`` launch, as ``torch.profiler`` records them
    (None when it records none)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    spans = [e.time_range.end - e.time_range.start for e in prof.events() if kernel in e.name]
    return statistics.median(spans) / 1e3 if spans else None


def conv_cost(ci, co, pixels, esize=4):
    """One SAME 3x3 conv layer's own work over ``pixels`` output pixels
    stored in ``esize``-byte elements: 2 FLOP per MAC, and the input map
    read, the output map written and the weights and bias read, each
    once."""
    flops = 2 * pixels * 9 * ci * co
    nbytes = esize * (pixels * (ci + co) + 9 * ci * co + co)
    return flops, nbytes


def bound(flops, nbytes, peak_flops, peak_bw):
    """The least milliseconds for ``flops`` at ``peak_flops`` and
    ``nbytes`` at ``peak_bw``, and which of the two bounds it."""
    t_ops, t_bytes = flops / peak_flops, nbytes / peak_bw
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


# Phase 4f: the LM serving path at the full width and depth of qwen2-0.5b.
LM_ARCH, LM_BATCH, LM_PROMPT, LM_GEN = "qwen2-0.5b", 4, 128, 32
LM_PROFILED_STEPS = 3  # decode steps in the profiler's window
LM_TOL = dict(atol=2e-4, rtol=1e-3)  # fp32: the reference's decode-vs-forward tolerance
# bf16 vs fp32 prefill logits: bf16 keeps 8 significant bits (a rounding
# step of 2^-8 = 0.39 %) and the activations are rounded some ten times a
# layer over 24 layers; at 24 layers of widths 128-448 the CPU gives a
# relative L2 error of 1.8-2.1 % and a max abs diff of 1.6-2.0 % of the
# largest logit.  The bounds leave 2.5x and 5x of that.
LM_BF16_REL_L2, LM_BF16_MAX_FRAC = 0.05, 0.1


def _leaves(tree, prefix=""):
    """(path, tensor) of every leaf of a nested dict."""
    for key in sorted(tree):
        if isinstance(tree[key], dict):
            yield from _leaves(tree[key], f"{prefix}{key}/")
        else:
            yield prefix + key, tree[key]


def profiler_device_ms(torch, fn):
    """(milliseconds the card spends in kernels and copies, their count)
    during one call of ``fn``, from ``torch.profiler``; (None, 0) when it
    records no device event.  Keep ``fn`` short: the profiler's events are
    read back in Python."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    spans = [e.time_range.end - e.time_range.start for e in prof.events()
             if e.device_type == DeviceType.CUDA]
    return (sum(spans) / 1e3 if spans else None), len(spans)


def lm_serve(torch, dev, cfg, params, tokens, S, G):
    """``make_prefill_step`` over ``tokens[:, :S]``, then ``G - 1`` greedy
    ``make_decode_step`` steps; every step's logits finite and ``(B, V)``.
    Returns (prefill logits fp32, the greedy tokens (B, G))."""
    from repro_torch.distributed.steps import init_cache, make_decode_step, make_prefill_step

    B, V = tokens.shape[0], cfg.vocab_size
    prefill, decode = make_prefill_step(cfg), make_decode_step(cfg)
    cache = init_cache(cfg, B, S + G, dev)
    logits, cache = prefill(params, {"tokens": tokens[:, :S]}, cache)
    first = logits.float()
    out = []
    for i in range(G):
        require(tuple(logits.shape) == (B, V), f"{cfg.name} {cfg.dtype} step {i}: logits "
                f"{tuple(logits.shape)}")
        require(bool(torch.isfinite(logits).all()), f"{cfg.name} {cfg.dtype} step {i}: "
                "non-finite logits")
        tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
        out.append(tok)
        if i < G - 1:
            logits, cache = decode(params, tok, cache, S + i)
    return first, torch.cat(out, dim=1)


def lm_serving(torch, dev, smi, hbm_bytes_per_s, peaks, cfg):
    """Phase 4f: ``launch/serve.py``'s code (``make_prefill_step`` /
    ``make_decode_step``) over ``cfg`` (qwen2-0.5b at its full width and
    depth): checks, then times beside the bounds."""
    from repro_torch.distributed.steps import init_cache, make_decode_step, make_prefill_step
    from repro_torch.layers.params import init_params, tree_map
    from repro_torch.models import lm
    from repro_torch.models.registry import get_model

    B, S, G, V = LM_BATCH, LM_PROMPT, LM_GEN, cfg.vocab_size
    gen = torch.Generator(device=dev).manual_seed(0)
    t0 = time.perf_counter()
    params = init_params(get_model(cfg).schema(cfg), gen, cfg.weight_dtype, dev)
    # the schema zeroes the QKV biases; seeded non-zero ones check the bias path
    for key in ("bq", "bk", "bv"):
        params["blocks"]["attn"][key].normal_(0.0, 0.1, generator=gen)
    tokens = torch.randint(0, V, (B, S + 1), generator=gen, dtype=torch.int32, device=dev)
    torch.cuda.synchronize()
    leaves = list(_leaves(params))
    n_params = sum(t.numel() for _, t in leaves)
    stored = sum(t.numel() * t.element_size() for _, t in leaves)
    print(f"{LM_ARCH}: {cfg.num_layers} layers, d_model {cfg.d_model}, {cfg.num_heads} query / "
          f"{cfg.num_kv_heads} KV heads of {cfg.head_dim}, d_ff {cfg.d_ff}, vocab {V}, tied, QKV "
          f"bias; {n_params} parameters ({stored / 1e9:.3f} GB {cfg.param_dtype}) from a "
          f"torch.Generator on {dev} in {time.perf_counter() - t0:.2f} s")
    cfgs = {"bf16": cfg, "fp32": dataclasses.replace(cfg, dtype="float32")}
    cfg32 = cfgs["fp32"]

    t0 = time.perf_counter()
    served = {prec: lm_serve(torch, dev, c, params, tokens, S, G) for prec, c in cfgs.items()}
    print(f"served [bf16, fp32]: prefill of {B}x{S} tokens, then {G - 1} greedy decode steps; "
          f"logits finite and ({B}, {V}) after prefill and after every step ({time.perf_counter() - t0:.1f} s)")

    # bf16 against fp32 prefill logits on the card
    ref, got = served["fp32"][0], served["bf16"][0]
    rel_l2 = float(((got - ref).norm(dim=-1) / ref.norm(dim=-1)).max())
    max_frac = float((got - ref).abs().max() / ref.abs().max())
    agree = float((served["bf16"][1] == served["fp32"][1]).float().mean())
    print(f"bf16 vs fp32 prefill logits: relative L2 (worst row) {rel_l2:.5f} (bound "
          f"{LM_BF16_REL_L2}), max abs diff {max_frac:.5f} of the largest |logit| (bound "
          f"{LM_BF16_MAX_FRAC}); greedy tokens agree at {agree:.4f} of {B}x{G}")
    for prec in ("bf16", "fp32"):
        print(f"  greedy tokens [{prec}], row 0: {served[prec][1][0].tolist()}")
    require(rel_l2 <= LM_BF16_REL_L2 and max_frac <= LM_BF16_MAX_FRAC,
            "bf16 prefill logits are out of their bound from fp32's")

    # fp32 cache consistency: prefill over S, decode token S == forward over S + 1
    t0 = time.perf_counter()
    with torch.no_grad():
        full, _, _ = lm.forward(params, cfg32, tokens, mode="train")
    want = full[:, S]
    del full
    cache = init_cache(cfg32, B, S + 4, dev)
    _, cache = make_prefill_step(cfg32)(params, {"tokens": tokens[:, :S]}, cache)
    dec, _ = make_decode_step(cfg32)(params, tokens[:, S:S + 1], cache, S)
    err = (dec - want).abs()
    excess = float((err / (LM_TOL["atol"] + LM_TOL["rtol"] * want.abs())).max())
    print(f"fp32 decode at position {S} vs forward over {S + 1} tokens: max abs diff "
          f"{float(err.max()):.3e} ({excess:.3f} of atol {LM_TOL['atol']} + rtol "
          f"{LM_TOL['rtol']} |want|; {time.perf_counter() - t0:.1f} s)")
    require(excess <= 1.0, "fp32 decode after prefill must match forward over S + 1 tokens")

    # the card against the CPU: fp32 weights, a 16-token prompt at batch 1
    t0 = time.perf_counter()
    params_cpu = tree_map(lambda t: t.cpu(), params, is_leaf=lambda t: not isinstance(t, dict))
    prompt = tokens[:1, :16]
    on_card, _ = make_prefill_step(cfg32)(params, {"tokens": prompt},
                                          init_cache(cfg32, 1, 16, dev))
    on_cpu, _ = make_prefill_step(cfg32)(params_cpu, {"tokens": prompt.cpu()},
                                         init_cache(cfg32, 1, 16, "cpu"))
    del params_cpu
    err = (on_card.cpu() - on_cpu).abs()
    cpu_excess = float((err / (LM_TOL["atol"] + LM_TOL["rtol"] * on_cpu.abs())).max())
    print(f"fp32 prefill logits, card vs CPU (batch 1, 16 tokens): max abs diff "
          f"{float(err.max()):.3e} ({cpu_excess:.3f} of the tolerance; {time.perf_counter() - t0:.1f} s)")
    require(cpu_excess <= 1.0, "fp32 prefill logits on the card must match the CPU's")

    # times (CUDA events, median of repeats after warm-up) beside the bounds
    norm_keys = ("ln1", "ln2", "final_norm", "q_norm", "k_norm")
    tokens_in = B * S
    layer_matmul = sum(t[0].numel() for k, t in leaves if k.startswith("blocks/")
                       and not k.endswith(norm_keys))
    attn_flops = cfg.num_layers * 4 * B * cfg.num_heads * cfg.head_dim * S * (S + 1) // 2
    prefill_flops = 2 * tokens_in * cfg.num_layers * layer_matmul + 2 * B * V * cfg.d_model \
        + attn_flops
    times = {}
    for prec, c in cfgs.items():
        act_size = torch.empty((), dtype=c.activation_dtype).element_size()
        cast = sum(2 * t.numel() * act_size for k, t in leaves
                   if not k.endswith(norm_keys) and t.dtype != c.activation_dtype)
        prefill, decode = make_prefill_step(c), make_decode_step(c)
        cache = init_cache(c, B, S + G, dev)
        kv = sum(t.numel() * t.element_size() for _, t in _leaves(cache))
        batch = {"tokens": tokens[:, :S]}
        # serve() above ran these shapes already: one warm-up call is enough
        prefill_ms = time_ms(torch, lambda: prefill(params, batch, cache), reps=5, warmup=1)
        logits, _ = prefill(params, batch, cache)
        tok0 = torch.argmax(logits, -1)[:, None].to(torch.int32)

        def loop(steps=G - 1):
            tok = tok0
            for i in range(steps):
                out, _ = decode(params, tok, cache, S + i)
                tok = torch.argmax(out, -1)[:, None].to(torch.int32)

        t0 = time.perf_counter()
        loop_ms = time_ms(torch, loop, reps=3, warmup=0)
        busy_ms, kernels = profiler_device_ms(torch, lambda: loop(LM_PROFILED_STEPS))
        step_ms = loop_ms / (G - 1)
        decode_bytes = stored + cast + kv
        decode_bound = decode_bytes / hbm_bytes_per_s * 1e3
        peak = peaks["bf16" if prec == "bf16" else "fp32"]
        pre_bound, pre_by = bound(prefill_flops, stored + cast + kv, peak, hbm_bytes_per_s)
        busy = None if busy_ms is None else busy_ms / LM_PROFILED_STEPS
        times[prec] = dict(prefill_ms=prefill_ms, prefill_bound_ms=pre_bound,
                           prefill_bound_by=pre_by, prefill_flops=prefill_flops,
                           decode_ms_per_step=step_ms, tokens_per_s=B * (G - 1) / loop_ms * 1e3,
                           decode_bound_ms=decode_bound, decode_bytes=decode_bytes,
                           weight_bytes=stored, cast_bytes=cast, kv_cache_bytes=kv,
                           decode_device_busy_ms_per_step=busy,
                           decode_device_events_per_step=kernels / LM_PROFILED_STEPS)
        print(f"LM serving [{prec}, B={B}, prompt {S}, {G - 1} decode steps]: prefill "
              f"{prefill_ms:.3f} ms (bound {pre_bound:.3f} ms, {pre_by}: {prefill_flops / 1e9:.1f} "
              f"GFLOP at {peak / 1e12:.0f} TFLOP/s); decode {step_ms:.3f} ms/step, "
              f"{times[prec]['tokens_per_s']:.1f} tokens/s; decode HBM bound "
              f"{decode_bound:.3f} ms/step ({decode_bytes / 1e9:.4f} GB: weights {stored / 1e9:.4f}"
              f" + cast copies {cast / 1e9:.4f} + KV cache {kv / 1e6:.3f} MB, at the calibrated "
              f"{hbm_bytes_per_s / 1e12:.3f} TB/s) -> {100 * decode_bound / step_ms:.1f}% of "
              f"bound; device busy per step (torch.profiler, {LM_PROFILED_STEPS} steps): "
              f"{'not measured' if busy is None else f'{busy:.3f} ms'}, "
              f"{kernels / LM_PROFILED_STEPS:.0f} kernels and copies a step; "
              f"{time.perf_counter() - t0:.1f} s ({smi})")
    return {"arch": LM_ARCH, "batch": B, "prompt": S, "generated": G, "parameters": n_params,
            "bf16_vs_fp32": {"rel_l2": rel_l2, "max_frac": max_frac, "token_agreement": agree},
            "decode_vs_forward_fp32_excess": excess, "card_vs_cpu_fp32_excess": cpu_excess,
            "times": times}


# Phase 4g: training.  The gradient of the full-width model on the card
# against the CPU: fp32 sums in another order, and the embedding's gradient
# is summed by atomics on the card (index_put_ with accumulation), whose
# order varies from run to run; at relative L2 1e-4 a leaf may differ by
# about 1e-4 of its norm, some 10^3 fp32 roundings of each element.
TRAIN_BATCH, TRAIN_SEQ = 4, 128
TRAIN_GRAD_REL_L2 = 1e-4  # card vs CPU, per leaf (fp32)
TRAIN_REMAT_REL_L2 = 1e-5  # remat "full" vs "none" on the card, per leaf (fp32)
TRAIN_LR = 1e-3  # the fixed-batch check's peak learning rate (warm-up 2 steps)
TRAIN_PROFILED_STEPS = 3  # train steps in the profiler's window
FLASH_TOL = dict(atol=5e-5, rtol=1e-3)  # the reference's VJP tolerance


def _rel_l2(got, want):
    return float((got.double() - want.double()).norm() / want.double().norm().clamp_min(1e-30))


def _profile_window(torch, fn):
    """(device ms in kernels and copies, their count, the 5 kernels that
    took the most device time with their ms) over one call of ``fn``, after
    one warm-up call; (None, 0, []) when the profiler records no device
    event."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name.setdefault(e.name, []).append(e.time_range.end - e.time_range.start)
    if not by_name:
        return None, 0, []
    total = sum(sum(v) for v in by_name.values()) / 1e3
    count = sum(len(v) for v in by_name.values())
    top = sorted(((sum(v) / 1e3, len(v), n) for n, v in by_name.items()), reverse=True)[:5]
    return total, count, [{"ms": ms, "count": c, "name": n[:100]} for ms, c, n in top]


def lm_training(torch, dev, smi, hbm_bytes_per_s, peaks, cfg):
    """Phase 4g: the flash backward, gradients card vs CPU and remat at full
    width, ``launch/train.py`` and ``make_train_step`` at full width (times
    beside the bounds), the resilient loop, and ABPN training through
    ``examples/torch_train_abpn.py``; returns the JSON record."""
    import contextlib
    import importlib.util
    import io
    import tempfile

    from repro_torch.config import TrainConfig
    from repro_torch.data.synthetic import lm_batch, sr_pair_batch
    from repro_torch.distributed.steps import compute_grads, init_train_state, make_train_step
    from repro_torch.launch import train as train_cli
    from repro_torch.layers.attention import flash_attention
    from repro_torch.layers.params import tree_leaves, tree_leaves_with_path, tree_map
    from repro_torch.models.abpn import ABPNConfig, init_abpn
    from repro_torch.runtime.resilience import FailureInjector, resilient_train_loop

    record = {"arch": cfg.name, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ}

    # 1. the flash backward on the card, fp32, the full config's head layout
    kh, g = cfg.num_kv_heads, cfg.num_heads // cfg.num_kv_heads
    flash = {}
    for S in (128, 512):
        gen = torch.Generator(device=dev).manual_seed(S)
        q = torch.randn((2, S, kh, g, cfg.head_dim), generator=gen, device=dev)
        k = torch.randn((2, S, kh, cfg.head_dim), generator=gen, device=dev)
        v = torch.randn((2, S, kh, cfg.head_dim), generator=gen, device=dev)
        cot = torch.randn((2, S, kh, g, cfg.head_dim), generator=gen, device=dev)

        def direct(q, k, v):
            s = torch.einsum("bqkgd,bskd->bqkgs", q, k) / cfg.head_dim ** 0.5
            mask = torch.arange(S, device=dev)[:, None] >= torch.arange(S, device=dev)[None, :]
            s = torch.where(mask[None, :, None, None, :], s, -1e30)
            return torch.einsum("bqkgs,bskd->bqkgd", torch.softmax(s, -1), v)

        args = [t.clone().requires_grad_() for t in (q, k, v)]
        got = torch.autograd.grad(flash_attention(*args, causal=True, chunk=128), args, cot)
        args = [t.clone().requires_grad_() for t in (q, k, v)]
        want = torch.autograd.grad(direct(*args), args, cot)
        tol = [FLASH_TOL["atol"] + FLASH_TOL["rtol"] * b.abs() for b in want]
        excess = max(float(((a - b).abs() / t).max()) for a, b, t in zip(got, want, tol))
        flash[S] = {"excess": excess, "max_abs": max(float((a - b).abs().max())
                                                      for a, b in zip(got, want))}
        print(f"flash backward [fp32, B=2, S={S}, {S // 128} KV chunk(s) of 128, Kh {kh}, G {g}, "
              f"D {cfg.head_dim}, causal]: dq/dk/dv vs autograd through a direct softmax, max "
              f"abs diff {flash[S]['max_abs']:.3e} ({excess:.3f} of atol {FLASH_TOL['atol']} + "
              f"rtol {FLASH_TOL['rtol']} |want|)")
        require(excess <= 1.0, f"flash backward at S={S} vs the direct softmax's gradient")
    record["flash_backward"] = flash

    # 2. gradients at full width, fp32, card vs CPU, the same weights
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    gen = torch.Generator(device=dev).manual_seed(0)
    t0 = time.perf_counter()
    state = init_train_state(cfg32, TrainConfig(), gen, dev)
    params = state["params"]
    for key in ("bq", "bk", "bv"):  # the schema zeroes them; non-zero ones check the bias path
        params["blocks"]["attn"][key].normal_(0.0, 0.1, generator=gen)
    n_params = sum(t.numel() for t in tree_leaves(params))
    batch1 = lm_batch(cfg, 0, 1, 32, device=dev)
    _, g_card = compute_grads(cfg32, params, batch1)
    params_cpu = tree_map(lambda t: t.cpu(), params, is_leaf=lambda t: not isinstance(t, dict))
    _, g_cpu = compute_grads(cfg32, params_cpu, {k: v.cpu() for k, v in batch1.items()})
    del params_cpu
    errs = {"/".join(p): _rel_l2(a.cpu(), b) for (p, a), (_, b)
            in zip(tree_leaves_with_path(g_card), tree_leaves_with_path(g_cpu))}
    del g_cpu
    worst = max(errs, key=errs.get)
    print(f"gradient [fp32, full width, batch 1 x 32 tokens, {n_params} parameters], card vs "
          f"CPU: worst leaf {worst} relative L2 {errs[worst]:.3e}, embed "
          f"{errs['embed']:.3e} (bound {TRAIN_GRAD_REL_L2}; {time.perf_counter() - t0:.1f} s)")
    require(max(errs.values()) <= TRAIN_GRAD_REL_L2, "full-width gradients, card vs CPU")
    record["grad_card_vs_cpu_rel_l2"] = {"worst": errs[worst], "worst_leaf": worst,
                                         "embed": errs["embed"]}

    # 3. remat "full" against "none", fp32, on the card; each call's peak
    # is read above the memory allocated just before it
    del g_card
    peak = {}
    grads = {}
    for remat in ("full", "none"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        before = torch.cuda.memory_allocated(dev)
        _, grads[remat] = compute_grads(dataclasses.replace(cfg32, remat=remat), params, batch1)
        torch.cuda.synchronize()
        peak[remat] = torch.cuda.max_memory_allocated(dev) - before
    errs = [_rel_l2(a, b) for a, b in zip(tree_leaves(grads["full"]), tree_leaves(grads["none"]))]
    grad_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(grads["full"]))
    print(f"remat [fp32, full width, batch 1 x 32 tokens]: gradients full vs none, worst leaf "
          f"relative L2 {max(errs):.3e} (bound {TRAIN_REMAT_REL_L2}); peak memory of the call "
          f"above what was allocated before it (its {grad_bytes / 1e9:.3f} GB of gradients "
          f"included): full {peak['full'] / 1e9:.3f} GB, none {peak['none'] / 1e9:.3f} GB")
    require(max(errs) <= TRAIN_REMAT_REL_L2, "remat full vs none gradients")
    record["remat"] = {"rel_l2_worst": max(errs), "peak_bytes_above_before": peak}
    del grads, state, params
    torch.cuda.empty_cache()

    # 4a. launch/train.py at full width on the card
    ckpt_dir = os.path.join(ROOT, "build", "chip_smoke_ckpt")
    if os.path.isdir(ckpt_dir):
        import shutil
        shutil.rmtree(ckpt_dir)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = train_cli.main(["--arch", cfg.name, "--full", "--steps", "8", "--batch",
                             str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ), "--checkpoint-every",
                             "0", "--log-every", "1", "--ckpt-dir", ckpt_dir, "--device", "cuda"])
    cli_s = time.perf_counter() - t0
    cli_peak = torch.cuda.max_memory_allocated(dev)
    lines = out.getvalue().splitlines()
    for line in lines:
        print(f"  train.py: {line}")
    losses = [float(l.split()[3]) for l in lines if l.startswith("step ")]
    gnorms = [float(l.split()[5]) for l in lines if l.startswith("step ")]
    print(f"launch.train.main(--full, 8 steps of {TRAIN_BATCH}x{TRAIN_SEQ}) returned {rc} in "
          f"{cli_s:.1f} s; peak memory {cli_peak / 1e9:.3f} GB (the loop's copy of the initial "
          f"state included)")
    require(rc == 0, "launch.train.main at full width must return 0")
    require(len(losses) == 8 and all(math.isfinite(x) for x in losses + gnorms),
            "launch.train: loss and grad norm finite at every step")
    record["train_cli"] = {"rc": rc, "losses": losses, "grad_norms": gnorms, "seconds": cli_s,
                           "peak_bytes": cli_peak}

    # 4b. make_train_step on one fixed batch: the loss must fall below 0.9x
    tcfg = TrainConfig(learning_rate=TRAIN_LR, warmup_steps=2, total_steps=30)
    gen = torch.Generator(device=dev).manual_seed(1)
    state = init_train_state(cfg, tcfg, gen, dev)
    step = make_train_step(cfg, tcfg)
    batch = lm_batch(cfg, 0, TRAIN_BATCH, TRAIN_SEQ, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    losses, gnorms, step_ms = [], [], []
    for i in range(12):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        state, metrics = step(state, batch)
        end.record()
        end.synchronize()
        step_ms.append(start.elapsed_time(end))
        losses.append(float(metrics["total_loss"]))
        gnorms.append(float(metrics["grad_norm"]))
    train_peak = torch.cuda.max_memory_allocated(dev)
    print(f"fixed batch [{cfg.dtype} activations, {cfg.param_dtype} parameters, remat "
          f"{cfg.remat!r}, lr {TRAIN_LR}, warm-up 2]: losses {[round(x, 4) for x in losses]}; "
          f"grad norms {[round(x, 3) for x in gnorms]}")
    require(all(math.isfinite(x) for x in losses + gnorms), "fixed batch: non-finite loss or norm")
    require(losses[-1] < 0.9 * losses[0], "fixed batch: the loss must fall below 0.9x the first")

    # times beside the bounds
    ms = statistics.median(step_ms[2:])
    busy, kernels, top = _profile_window(
        torch, lambda: [step(state, batch) for _ in range(TRAIN_PROFILED_STEPS)])
    busy_step = None if busy is None else busy / TRAIN_PROFILED_STEPS
    tokens = TRAIN_BATCH * TRAIN_SEQ
    leaves = list(tree_leaves_with_path(state["params"]))
    norms = ("ln1", "ln2", "final_norm", "q_norm", "k_norm")
    block_mm = sum(t[0].numel() for p, t in leaves if p[0] == "blocks" and p[-1] not in norms
                   and p[-1] not in ("bq", "bk", "bv"))
    unembed = cfg.vocab_size * cfg.d_model
    attn = cfg.num_layers * 4 * TRAIN_BATCH * cfg.num_heads * cfg.head_dim \
        * TRAIN_SEQ * (TRAIN_SEQ + 1) // 2  # causal QK^T and PV, one forward
    fwd = 2 * tokens * (cfg.num_layers * block_mm + unembed) + attn
    remat_fwd = 2 * tokens * cfg.num_layers * block_mm + attn  # the blocks once more
    flops = 3 * fwd + remat_fwd
    n_params = sum(t.numel() for _, t in leaves)
    opt_bytes = n_params * (4 * 4 + 3 * 4)  # p, g, m, v read; p, m, v written (fp32)
    t_ops = flops / peaks["bf16"] * 1e3
    t_bytes = opt_bytes / hbm_bytes_per_s * 1e3
    bound_ms = max(t_ops, t_bytes)
    print(f"train step [{cfg.name} full width, {TRAIN_BATCH}x{TRAIN_SEQ} tokens, "
          f"{cfg.dtype}]: {ms:.3f} ms (CUDA events, median of steps 3-12), "
          f"{tokens / ms * 1e3:.1f} tokens/s; peak memory {train_peak / 1e9:.3f} GB; device busy "
          f"per step (torch.profiler, {TRAIN_PROFILED_STEPS} steps) "
          f"{'not measured' if busy_step is None else f'{busy_step:.3f} ms'}"
          + ("" if busy_step is None else f" -> idle {100 * (1 - busy_step / ms):.1f}%")
          + f", {kernels / TRAIN_PROFILED_STEPS:.0f} kernels and copies a step ({smi})")
    print(f"  top kernels over the window: " + "; ".join(
        f"{t['ms']:.2f} ms x{t['count']} {t['name']}" for t in top))
    print(f"  bounds: operations {flops / 1e12:.3f} TFLOP (6 N tokens + one more forward of "
          f"the blocks for remat + causal attention) at {peaks['bf16'] / 1e12:.0f} TFLOP/s "
          f"bf16 -> {t_ops:.3f} ms; AdamW bytes {opt_bytes / 1e9:.2f} GB at the calibrated "
          f"{hbm_bytes_per_s / 1e12:.3f} TB/s -> {t_bytes:.3f} ms; bound {bound_ms:.3f} ms "
          f"({'operations' if t_ops >= t_bytes else 'bytes'}) -> {100 * bound_ms / ms:.1f}% of "
          f"bound")
    record["fixed_batch"] = {"lr": TRAIN_LR, "losses": losses, "grad_norms": gnorms}
    record["step"] = {"ms": ms, "step_ms": step_ms, "tokens_per_s": tokens / ms * 1e3,
                      "peak_bytes": train_peak, "device_busy_ms": busy_step,
                      "device_events_per_step": kernels / TRAIN_PROFILED_STEPS,
                      "top_kernels": top, "flops": flops, "ops_bound_ms": t_ops,
                      "adamw_bytes": opt_bytes, "bytes_bound_ms": t_bytes,
                      "bound_ms": bound_ms, "card": smi}
    del state, step
    torch.cuda.empty_cache()

    # 5. the resilient loop on the card: injected failures, restarts
    small = cfg.reduced(num_layers=2, d_model=32, d_ff=64, vocab_size=128, remat="none")
    tcfg = TrainConfig(learning_rate=1e-3, warmup_steps=2, total_steps=30)
    runs = {}
    for name, fail_at in (("injected", {7, 13}), ("clean", set())):
        gen = torch.Generator(device=dev).manual_seed(0)
        with tempfile.TemporaryDirectory() as d:
            runs[name] = resilient_train_loop(
                init_state=init_train_state(small, tcfg, gen, dev),
                train_step=make_train_step(small, tcfg),
                batch_fn=lambda s: lm_batch(small, s, 2, 16, device=dev),
                total_steps=20, ckpt_dir=d, cfg=small, checkpoint_every=5,
                injector=FailureInjector(fail_at_steps=fail_at))
    (st, report), (clean, _) = runs["injected"], runs["clean"]
    diff = max(float((a - b).abs().max()) for a, b in zip(tree_leaves(st["params"]),
                                                        tree_leaves(clean["params"])))
    print(f"resilient loop [2 layers, d_model 32, failures at steps 7 and 13, checkpoint every "
          f"5]: restarts {report['restarts']}, finished step {report['finished_step']}, "
          f"optimizer step {int(st['opt']['step'])}; final parameters vs an uninterrupted run: "
          f"max abs diff {diff:.3e}")
    require(report["restarts"] == 2 and report["finished_step"] == 20
            and int(st["opt"]["step"]) >= 18, "the resilient loop on the card")
    record["resilience"] = {"restarts": report["restarts"],
                            "finished_step": report["finished_step"],
                            "opt_step": int(st["opt"]["step"]), "max_abs_diff_vs_clean": diff}

    # 6. ABPN training through examples/torch_train_abpn.py (fp32, TF32 off)
    def example(name):
        spec = importlib.util.spec_from_file_location(
            name, os.path.join(ROOT, "examples", f"{name}.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    ex = example("torch_train_abpn")
    acfg = ABPNConfig(feature_channels=12, num_layers=4)
    t0 = time.perf_counter()
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        layers = ex.trainable(init_abpn(0, acfg, device=dev))
        lr_img, hr_img = sr_pair_batch(0, 4, lr_shape=(24, 24), scale=3, device=dev)
        with torch.no_grad():
            before = ex.psnr(ex.upscale(layers, lr_img, acfg), hr_img)
        for i in range(60):
            lr_b, hr_b = sr_pair_batch(i, 4, lr_shape=(24, 24), scale=3, device=dev)
            loss = ex.sgd_step(layers, lr_b, hr_b, acfg, 0.02)
        with torch.no_grad():
            after = ex.psnr(ex.upscale(layers, lr_img, acfg), hr_img)
    print(f"ABPN training [12 channels, 4 layers, 24x24, 60 SGD steps at lr 0.02, fp32 on the "
          f"card]: PSNR {before:.3f} -> {after:.3f} dB (last loss {float(loss):.4f}; "
          f"{time.perf_counter() - t0:.1f} s)")
    require(after > before + 0.5, "ABPN training must gain more than 0.5 dB")
    record["abpn"] = {"psnr_before": before, "psnr_after": after}

    qs = example("torch_quickstart")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = qs.main(["--device", "cuda"])
    for line in out.getvalue().splitlines():
        print(f"  torch_quickstart: {line}")
    require(rc == 0 and "reference vs tilted(halo): max|d| = 0.00e+00" in out.getvalue(),
            "examples/torch_quickstart.py on the card")
    return record


# Phase 4h: the remaining decoder-only families at their published widths.
# (arch, depth override): deepseek-v2 keeps its dense MLA prologue and two
# stacked MoE+MLA layers (9.17 G parameters, 36.7 GB in fp32), arctic one
# layer (14.07 G, 56.3 GB in fp32: two stacked layers' routed experts would
# not fit beside their fp32 draw); mamba2-130m and zamba2-2.7b are not cut.
FAMILY_RUNS = (("mamba2-130m", None), ("zamba2-2.7b", None), ("deepseek-v2-236b", 3),
               ("arctic-480b", 1))
FAMILY_GRAD_LAYERS = 2  # deepseek-v2's compute_grads check: the prologue + one MoE layer
FAMILY_GRAD_SEQ = 32
FAMILY_TRAIN_LR = 3e-3  # mamba2's fixed-batch check: the reference test's lr (warm-up 2)
NORM_LEAVES = ("ln", "ln1", "ln2", "final_norm", "q_norm", "k_norm", "kv_norm", "norm")


def _to_param_dtypes_(tree, schema, dtype):
    """Cast ``tree``'s leaves to ``dtype`` where the schema sets no dtype of
    its own (the router stays fp32), one leaf at a time in place: at most
    one leaf is held in both dtypes."""
    for key in sorted(tree):
        if isinstance(tree[key], dict):
            _to_param_dtypes_(tree[key], schema[key], dtype)
        elif schema[key].dtype is None:
            tree[key] = tree[key].to(dtype)


def _routed(fn):
    """(``fn()``, the top-k expert ids ``(B, S, k)`` of every MoE layer it
    ran, in order), recorded around ``layers.moe._router``."""
    from repro_torch.layers import moe as moe_lib

    picks, real = [], moe_lib._router

    def recording(p, cfg, x):
        out = real(p, cfg, x)
        picks.append(out[1][1])
        return out

    moe_lib._router = recording
    try:
        return fn(), picks
    finally:
        moe_lib._router = real


def _kept(torch, idx, num_experts, cap):
    """Which (token, choice) claims of ``idx (B, S, k)`` fit their expert's
    buffer: ``layers.moe``'s capacity rule (slots in (token, choice) order)."""
    onehot = torch.nn.functional.one_hot(idx, num_experts).float()
    B, S, k, _ = onehot.shape
    claims = onehot.reshape(B, S * k, num_experts)
    pos = ((claims.cumsum(1) - claims).reshape(B, S, k, num_experts) * onehot).sum(-1)
    return pos < cap


def _decode_bytes(torch, params, cfg, cache):
    """(weights a decode step reads as stored, the bytes that casting them
    to the activation dtype at use writes and reads, the cache's bytes).
    An untied embedding is read a row a token (not counted); every expert
    is read, as the dense decode path runs them all."""
    act = torch.empty((), dtype=cfg.activation_dtype).element_size()
    stored = cast = 0
    for path, t in _leaves(params):
        if path == "embed" and not cfg.tie_embeddings:
            continue
        stored += t.numel() * t.element_size()
        key = path.rsplit("/", 1)[-1]
        if key not in NORM_LEAVES + ("router",) and t.dtype != cfg.activation_dtype:
            cast += 2 * t.numel() * act
    kv = sum(t.numel() * t.element_size() for _, t in _leaves(cache))
    return stored, cast, kv


def _family_times(torch, dev, smi, hbm_bytes_per_s, cfg, params, tokens, S, G):
    """Prefill ms and decode ms a step (CUDA events), the card's busy ms and
    kernels a step (``torch.profiler``), peak memory, and the decode step's
    HBM bound."""
    from repro_torch.distributed.steps import init_cache, make_decode_step, make_prefill_step

    B = tokens.shape[0]
    prefill, decode = make_prefill_step(cfg), make_decode_step(cfg)
    cache = init_cache(cfg, B, S + G, dev)
    batch = {"tokens": tokens[:, :S]}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    prefill_ms = time_ms(torch, lambda: prefill(params, batch, cache), reps=3, warmup=1)
    logits, _ = prefill(params, batch, cache)
    tok0 = torch.argmax(logits, -1)[:, None].to(torch.int32)

    def loop(steps=G - 1):
        tok = tok0
        for i in range(steps):
            out, _ = decode(params, tok, cache, S + i)
            tok = torch.argmax(out, -1)[:, None].to(torch.int32)

    loop_ms = time_ms(torch, loop, reps=2, warmup=0)
    busy_ms, events = profiler_device_ms(torch, lambda: loop(LM_PROFILED_STEPS))
    peak = torch.cuda.max_memory_allocated(dev)
    step_ms = loop_ms / (G - 1)
    stored, cast, kv = _decode_bytes(torch, params, cfg, cache)
    bound_ms = (stored + cast + kv) / hbm_bytes_per_s * 1e3
    busy = None if busy_ms is None else busy_ms / LM_PROFILED_STEPS
    rec = dict(prefill_ms=prefill_ms, decode_ms_per_step=step_ms,
               tokens_per_s=B * (G - 1) / loop_ms * 1e3, decode_bound_ms=bound_ms,
               weight_bytes=stored, cast_bytes=cast, cache_bytes=kv,
               decode_device_busy_ms_per_step=busy,
               decode_device_events_per_step=events / LM_PROFILED_STEPS, peak_bytes=peak)
    print(f"  times [{cfg.dtype}, B={B}, prompt {S}, {G - 1} decode steps]: prefill "
          f"{prefill_ms:.3f} ms; decode {step_ms:.3f} ms/step, {rec['tokens_per_s']:.1f} "
          f"tokens/s; HBM bound {bound_ms:.3f} ms/step (weights {stored / 1e9:.4f} GB + cast "
          f"copies {cast / 1e9:.4f} GB + cache {kv / 1e6:.3f} MB at {hbm_bytes_per_s / 1e12:.3f} "
          f"TB/s) -> {100 * bound_ms / step_ms:.1f}% of bound; device busy per step "
          f"{'not measured' if busy is None else f'{busy:.3f} ms'}"
          + ("" if busy is None else f" (idle {100 * (1 - busy / step_ms):.1f}%)")
          + f", {rec['decode_device_events_per_step']:.0f} kernels and copies a step; peak "
          f"memory {peak / 1e9:.3f} GB ({smi})")
    return rec


def _logit_gap(got, ref):
    """(worst row's relative L2, max abs diff over the largest |logit|)."""
    got, ref = got.float(), ref.float()
    rel = float(((got - ref).norm(dim=-1) / ref.norm(dim=-1)).max())
    return rel, float((got - ref).abs().max() / ref.abs().max())


def _family_excess(got, want):
    """(the excess over LM_TOL, the excess over LM_TOL with its atol scaled
    by the largest |logit| where that is above 1): 1.0 is the bound.  The
    scaled form is the one held in phase 4h: at these widths the logits
    reach ~5, and fp32 GEMMs blocked differently for 4 rows (decode) than
    for 516 (the forward), or on the CPU, differ by ~1e-6 of a layer's
    output, which 54 random Mamba layers carry to ~1e-4 of the logits'
    scale (the SSD itself in fp64 changes nothing)."""
    err = (got - want).abs()
    scale = max(1.0, float(want.abs().max()))
    plain = float((err / (LM_TOL["atol"] + LM_TOL["rtol"] * want.abs())).max())
    scaled = float((err / (LM_TOL["atol"] * scale + LM_TOL["rtol"] * want.abs())).max())
    return plain, scaled


def _ssm_layer_gaps(torch, cfg32, cfg16, params, tokens):
    """bf16 against fp32 layer by layer, for mamba2 and zamba2: each Mamba
    layer and each shared-block application runs in bf16 on the bf16
    rounding of the fp32 run's input to it; returns the worst (relative L2
    over the layer's whole (B, S, d) output, of its worst row, max abs diff
    over the largest |value|) of its residual increment against the fp32
    layer's, each with the layer where it is worst.  The whole output's
    relative L2 is held (a row whose increment is small is all rounding).
    The end-to-end logits are no test of the port here: a random-weight
    Mamba stack compounds each layer's ~1 % bf16 error, in the JAX package
    as in the port (PERF.md §6)."""
    from repro_torch.layers.common import embed_lookup
    from repro_torch.models import zamba
    from repro_torch.models.lm import _unstack
    from repro_torch.models.mamba_lm import mamba_layer

    B, S = tokens.shape
    positions = torch.arange(S, dtype=torch.int32, device=tokens.device).expand(B, S)
    steps = []
    for i, lp in enumerate(_unstack(params["blocks"], cfg32.num_layers)):
        steps.append((f"mamba layer {i}", lambda c, h, lp=lp: mamba_layer(lp, c, h, None, "train")))
        if cfg32.family == "hybrid" and (i + 1) % cfg32.shared_attn_period == 0 \
                and i // cfg32.shared_attn_period < zamba._num_apps(cfg32):
            app = i // cfg32.shared_attn_period
            sp = _unstack(params["shared"], cfg32.num_shared_blocks)[app % cfg32.num_shared_blocks]
            steps.append((f"shared application {app}", lambda c, h, sp=sp: zamba._shared_apply(
                sp, c, h, positions, None, None, "train")))
    worst = {"rel_l2": (0.0, None), "row_rel_l2": (0.0, None), "max_frac": (0.0, None)}
    x = embed_lookup(params["embed"], tokens, torch.float32)
    with torch.no_grad():
        for label, step in steps:
            y32 = step(cfg32, x)
            x16 = x.to(torch.bfloat16)
            y16 = step(cfg16, x16)
            got, want = y16.float() - x16.float(), y32 - x
            row, frac = _logit_gap(got, want)
            gaps = {"rel_l2": float((got - want).norm() / want.norm()), "row_rel_l2": row,
                    "max_frac": frac}
            for key, val in gaps.items():
                worst[key] = max(worst[key], (val, label), key=lambda t: t[0])
            x = y32
    return worst


def lm_family(torch, dev, smi, hbm_bytes_per_s, name, layers):
    """Phase 4h for one architecture at its published width (``layers``
    cuts the depth, None keeps it): fp32 first (serving, decode vs
    forward, card vs CPU, the MoE metrics, times), then bf16 activations
    (the MoE configs' parameters cast to bf16 in place, as their configs
    store them), against fp32; returns the JSON record."""
    from repro_torch.configs import get_config as lm_config
    from repro_torch.distributed.steps import init_cache, make_decode_step, make_prefill_step
    from repro_torch.layers import moe as moe_lib
    from repro_torch.layers.params import init_params, tree_map
    from repro_torch.models.registry import get_model

    full = lm_config(name)
    cfg = full if layers is None else dataclasses.replace(full, num_layers=layers)
    model = get_model(cfg)
    B, S, G, V = LM_BATCH, LM_PROMPT, LM_GEN, cfg.vocab_size
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    gen = torch.Generator(device=dev).manual_seed(0)
    t0 = time.perf_counter()
    params = init_params(model.schema(cfg), gen, torch.float32, dev)
    tokens = torch.randint(0, V, (B, S + 1), generator=gen, dtype=torch.int32, device=dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for _, t in _leaves(params))
    rec = {"arch": name, "layers": cfg.num_layers, "published_layers": full.num_layers,
           "parameters": n_params, "batch": B, "prompt": S, "generated": G}
    print(f"{name}: {cfg.num_layers} of {full.num_layers} layers, d_model {cfg.d_model}, vocab "
          f"{V}; {n_params} parameters ({n_params * 4 / 1e9:.3f} GB fp32) from a "
          f"torch.Generator on {dev} in {time.perf_counter() - t0:.2f} s")

    # fp32: serving, decode vs forward, card vs CPU, the MoE metrics
    t0 = time.perf_counter()
    first32, greedy32 = lm_serve(torch, dev, cfg32, params, tokens, S, G)
    print(f"  served [fp32]: prefill of {B}x{S}, {G - 1} greedy decode steps, logits finite "
          f"and ({B}, {V}) at every step ({time.perf_counter() - t0:.1f} s)")
    # decode's MoE path is dropless: hold it to a forward that drops nothing
    # (capacity factor E gives every expert room for all S * k claims)
    exact = dataclasses.replace(cfg32, capacity_factor=float(cfg.num_experts)) \
        if cfg.is_moe else cfg32
    with torch.no_grad():
        full_logits, _, _ = model.forward(params, exact, tokens, mode="train")
    want = full_logits[:, S].clone()
    del full_logits
    cache = init_cache(exact, B, S + 4, dev)
    _, cache = make_prefill_step(exact)(params, {"tokens": tokens[:, :S]}, cache)
    dec, _ = make_decode_step(exact)(params, tokens[:, S:S + 1], cache, S)
    del cache
    plain, excess = _family_excess(dec, want)
    rec["decode_vs_forward_fp32"] = {"max_abs": float((dec - want).abs().max()),
                                     "largest_logit": float(want.abs().max()),
                                     "excess_unscaled": plain, "excess": excess}
    print(f"  fp32 decode at position {S} vs forward over {S + 1} tokens"
          + (" (capacity factor E)" if cfg.is_moe else "") + f": max abs diff "
          f"{float((dec - want).abs().max()):.3e}, largest |logit| {float(want.abs().max()):.3f}; "
          f"{excess:.3f} of atol {LM_TOL['atol']} x max(1, largest |logit|) + rtol "
          f"{LM_TOL['rtol']} |want| ({plain:.3f} of the unscaled tolerance)")
    require(excess <= 1.0, f"{name}: fp32 decode after prefill must match forward over S + 1")

    if name != "arctic-480b":  # arctic's 56 GB fp32 tree is not copied to the host
        t0 = time.perf_counter()
        params_cpu = tree_map(lambda t: t.cpu(), params, is_leaf=lambda t: not isinstance(t, dict))
        prompt = tokens[:1, :16]
        on_card, _ = make_prefill_step(cfg32)(params, {"tokens": prompt},
                                              init_cache(cfg32, 1, 16, dev))
        on_cpu, _ = make_prefill_step(cfg32)(params_cpu, {"tokens": prompt.cpu()},
                                             init_cache(cfg32, 1, 16, "cpu"))
        del params_cpu
        plain, cpu_excess = _family_excess(on_card.cpu(), on_cpu)
        err = float((on_card.cpu() - on_cpu).abs().max())
        rec["card_vs_cpu_fp32"] = {"max_abs": err, "largest_logit": float(on_cpu.abs().max()),
                                   "excess_unscaled": plain, "excess": cpu_excess}
        print(f"  fp32 prefill logits, card vs CPU (batch 1, 16 tokens): max abs diff "
              f"{err:.3e}, largest |logit| {float(on_cpu.abs().max()):.3f}; {cpu_excess:.3f} of "
              f"the scaled tolerance ({plain:.3f} of the unscaled; "
              f"{time.perf_counter() - t0:.1f} s)")
        require(cpu_excess <= 1.0, f"{name}: fp32 prefill logits on the card vs the CPU")

    def moe_forward(c):
        """forward over the prompt: (logits, MoE metrics, per-layer picks)."""
        with torch.no_grad():
            (logits, _, metrics), picks = _routed(
                lambda: model.forward(params, c, tokens[:, :S], mode="train"))
        shown = {k: float(v) for k, v in metrics.items()}
        require(all(math.isfinite(v) for v in shown.values()), f"{name} {c.dtype}: MoE metrics")
        print(f"  forward [{c.dtype}, {B}x{S}] MoE metrics (mean over the stacked layers): "
              + ", ".join(f"{k} {v:.6f}" for k, v in sorted(shown.items())))
        return logits.float(), shown, picks

    if cfg.is_moe:
        logits32, rec["moe_metrics_fp32"], picks32 = moe_forward(cfg32)
    rec["fp32"] = _family_times(torch, dev, smi, hbm_bytes_per_s, cfg32, params, tokens, S, G)

    # bf16 activations: the MoE configs store bf16 parameters (cast from
    # the fp32 tree in place); mamba2 and zamba2 keep fp32 ones
    if cfg.weight_dtype != torch.float32:
        _to_param_dtypes_(params, model.schema(cfg), cfg.weight_dtype)
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    first16, greedy16 = lm_serve(torch, dev, cfg, params, tokens, S, G)
    agree_tok = float((greedy16 == greedy32).float().mean())
    print(f"  served [bf16, {cfg.param_dtype} parameters]: logits finite and ({B}, {V}) at every "
          f"step; greedy tokens agree with fp32's at {agree_tok:.4f} of {B}x{G} "
          f"({time.perf_counter() - t0:.1f} s)")
    if cfg.is_moe:
        # A bf16 rounding can flip a top-k pick (and with it which claims
        # fit a buffer); the rule holds over the positions whose picks and
        # kept claims agree with fp32's in every layer, the others differ
        # by design.
        logits16, rec["moe_metrics_bf16"], picks16 = moe_forward(cfg)
        cap = moe_lib.capacity(cfg, S)
        same_pick = torch.stack([a == b for a, b in zip(picks16, picks32)])  # (L, B, S, k)
        same_keep = torch.stack([_kept(torch, a, cfg.num_experts, cap)
                                 == _kept(torch, b, cfg.num_experts, cap)
                                 for a, b in zip(picks16, picks32)])
        pick_share = float(same_pick.float().mean())
        ok = (same_pick & same_keep).all(dim=-1).all(dim=0)  # (B, S)
        rel, frac = _logit_gap(logits16[ok], logits32[ok])
        rec["bf16_vs_fp32"] = {"pick_agreement": pick_share, "positions_held": int(ok.sum()),
                               "positions": B * S, "rel_l2": rel, "max_frac": frac,
                               "token_agreement": agree_tok}
        print(f"  bf16 vs fp32: {pick_share:.4f} of the {same_pick.numel()} (token, layer, "
              f"choice) picks agree; over the {int(ok.sum())} of {B * S} positions whose picks "
              f"and kept claims agree in every layer, forward logits relative L2 (worst row) "
              f"{rel:.5f} (bound {LM_BF16_REL_L2}), max abs diff {frac:.5f} of the largest "
              f"|logit| (bound {LM_BF16_MAX_FRAC})")
        require(int(ok.sum()) > 0, f"{name}: no position's picks agree between bf16 and fp32")
        del logits16, logits32
    else:
        e2e_rel, e2e_frac = _logit_gap(first16, first32)
        worst = _ssm_layer_gaps(torch, cfg32, cfg, params, tokens[:, :S])
        (rel, rel_at), (frac, frac_at) = worst["rel_l2"], worst["max_frac"]
        row, row_at = worst["row_rel_l2"]
        rec["bf16_vs_fp32"] = {"prefill_logits_rel_l2": e2e_rel, "prefill_logits_max_frac":
                               e2e_frac, "layer_rel_l2": rel, "layer_rel_l2_at": rel_at,
                               "layer_row_rel_l2": row, "layer_row_rel_l2_at": row_at,
                               "layer_max_frac": frac, "layer_max_frac_at": frac_at,
                               "token_agreement": agree_tok}
        print(f"  bf16 vs fp32 prefill logits (not held: the stack compounds each layer's "
              f"error): relative L2 (worst row) {e2e_rel:.5f}, max abs diff {e2e_frac:.5f} of "
              f"the largest |logit|; layer by layer on the fp32 run's inputs, the worst residual "
              f"increment: relative L2 {rel:.5f} at {rel_at} (bound {LM_BF16_REL_L2}; worst "
              f"row {row:.5f} at {row_at}), max abs diff {frac:.5f} of the largest at "
              f"{frac_at} (bound {LM_BF16_MAX_FRAC})")
    require(rel <= LM_BF16_REL_L2 and frac <= LM_BF16_MAX_FRAC,
            f"{name}: bf16 logits are out of their bound from fp32's")
    rec["bf16"] = _family_times(torch, dev, smi, hbm_bytes_per_s, cfg, params, tokens, S, G)
    return rec


def lm_family_grads(torch, dev, smi):
    """deepseek-v2 at FAMILY_GRAD_LAYERS layers, full width, bf16:
    ``compute_grads`` over 1 x FAMILY_GRAD_SEQ tokens; every gradient leaf
    finite, the router's non-zero."""
    from repro_torch.configs import get_config as lm_config
    from repro_torch.data.synthetic import lm_batch
    from repro_torch.distributed.steps import compute_grads
    from repro_torch.layers.params import init_params
    from repro_torch.models.registry import get_model

    cfg = dataclasses.replace(lm_config("deepseek-v2-236b"), num_layers=FAMILY_GRAD_LAYERS)
    gen = torch.Generator(device=dev).manual_seed(2)
    params = init_params(get_model(cfg).schema(cfg), gen, cfg.weight_dtype, dev)
    batch = lm_batch(cfg, 0, 1, FAMILY_GRAD_SEQ, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    metrics, grads = compute_grads(cfg, params, batch)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    leaves = list(_leaves(grads))
    bad = [p for p, g in leaves if not bool(torch.isfinite(g).all())]
    router = float(grads["blocks"]["moe"]["router"].abs().max())
    rec = {"layers": cfg.num_layers, "tokens": FAMILY_GRAD_SEQ, "leaves": len(leaves),
           "non_finite": bad, "router_max_abs_grad": router,
           "total_loss": float(metrics["total_loss"]), "seconds": seconds,
           "peak_bytes": torch.cuda.max_memory_allocated(dev)}
    print(f"deepseek-v2-236b compute_grads [{cfg.num_layers} layers (the dense prologue + 1 "
          f"MoE), full width, {cfg.dtype} activations, {cfg.param_dtype} parameters, remat "
          f"{cfg.remat!r}, 1x{FAMILY_GRAD_SEQ} tokens]: total loss {rec['total_loss']:.4f} "
          f"(moe_aux_loss {float(metrics['moe_aux_loss']):.4f}, moe_z_loss "
          f"{float(metrics['moe_z_loss']):.4f}); {len(leaves)} leaves, non-finite {bad}; "
          f"router max |grad| {router:.3e}; {seconds:.1f} s, peak memory "
          f"{rec['peak_bytes'] / 1e9:.3f} GB ({smi})")
    require(not bad, "deepseek-v2 gradients must be finite")
    require(router > 0, "deepseek-v2's router gradient must be non-zero")
    return rec


def lm_family_train(torch, dev, smi):
    """mamba2-130m at full width and depth: ``make_train_step`` on one fixed
    LM_BATCH x LM_PROMPT batch; the loss falls below 0.9x its first within
    12 steps (the twin of tests/test_models_smoke.py's)."""
    from repro_torch.config import TrainConfig
    from repro_torch.configs import get_config as lm_config
    from repro_torch.data.synthetic import lm_batch
    from repro_torch.distributed.steps import init_train_state, make_train_step

    cfg = lm_config("mamba2-130m")
    tcfg = TrainConfig(learning_rate=FAMILY_TRAIN_LR, warmup_steps=2, total_steps=30)
    state = init_train_state(cfg, tcfg, torch.Generator(device=dev).manual_seed(1), dev)
    step = make_train_step(cfg, tcfg)
    batch = lm_batch(cfg, 0, LM_BATCH, LM_PROMPT, device=dev)
    losses, step_ms = [], []
    for _ in range(12):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        state, metrics = step(state, batch)
        end.record()
        end.synchronize()
        step_ms.append(start.elapsed_time(end))
        losses.append(float(metrics["total_loss"]))
    ms = statistics.median(step_ms[2:])
    print(f"mamba2-130m fixed batch [{LM_BATCH}x{LM_PROMPT}, {cfg.dtype} activations, "
          f"{cfg.param_dtype} parameters, lr {FAMILY_TRAIN_LR}]: losses "
          f"{[round(x, 4) for x in losses]}; a step {ms:.3f} ms (median of steps 3-12), "
          f"{LM_BATCH * LM_PROMPT / ms * 1e3:.1f} tokens/s ({smi})")
    require(all(math.isfinite(x) for x in losses), "mamba2 fixed batch: non-finite loss")
    require(losses[-1] < 0.9 * losses[0], "mamba2 fixed batch: the loss must fall below 0.9x")
    return {"lr": FAMILY_TRAIN_LR, "losses": losses, "step_ms": ms,
            "tokens_per_s": LM_BATCH * LM_PROMPT / ms * 1e3}


def lm_families(torch, dev, smi, hbm_bytes_per_s):
    """Phase 4h: every architecture of FAMILY_RUNS, then deepseek-v2's
    gradients and mamba2's training steps.  Each part runs to its end even
    when another failed; the phase then fails with every failure listed."""
    record, failures = {}, []
    parts = [(name, lambda n=name, l=layers: lm_family(torch, dev, smi, hbm_bytes_per_s, n, l))
             for name, layers in FAMILY_RUNS]
    parts += [("deepseek-v2-236b grads", lambda: lm_family_grads(torch, dev, smi)),
              ("mamba2-130m train", lambda: lm_family_train(torch, dev, smi))]
    for name, part in parts:
        t0 = time.perf_counter()
        try:
            record[name] = part()
        except Exception as e:  # noqa: BLE001 -- reported below, the phase fails
            failures.append(f"{name}: {type(e).__name__}: {e}")
            print(f"  FAILED {failures[-1]}")
        torch.cuda.empty_cache()
        print(f"  {name}: {time.perf_counter() - t0:.1f} s", flush=True)
    require(not failures, "phase 4h: " + "; ".join(failures))
    return record


def main() -> int:
    t_start = time.perf_counter()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available; nothing was run", file=sys.stderr)
        return 2

    # the port's tuning DB for this run, inside the checkout and made afresh
    # (sessions default to autotune="cached" and would read the user's)
    tuning_db = os.path.join(ROOT, "build", "chip_smoke_tuning.json")
    os.makedirs(os.path.dirname(tuning_db), exist_ok=True)
    if os.path.exists(tuning_db):
        os.remove(tuning_db)
    os.environ["REPRO_SR_TORCH_TUNING_DB"] = tuning_db

    from repro_torch import engine
    from repro_torch.core.fusion import ConvLayer, conv_stack_reference, exact_fp32, halo_slabs
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import conv3x3 as k2
    from repro_torch.kernels import tilted_fusion as ttf
    from repro_torch.models.abpn import init_abpn

    dev = torch.device("cuda")
    kcall = ttf.tilted_fusion_call
    k2call = k2.conv3x3_call

    # ------------------------------------------------------------------
    phase("1. environment")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    card = torch.cuda.get_device_name(0)
    peak_key, peaks = peaks_for(card)
    peak_flops, peak_bw = peaks["fp32"], peaks["bytes"]
    print(f"nvidia-smi: {smi}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, device {card!r}, "
          f"count {torch.cuda.device_count()}, python {sys.version.split()[0]}")
    print(f"peaks used for bounds ({peak_key}): fp32 {peak_flops / 1e12:.0f}, TF32 "
          f"{peaks['tf32'] / 1e12:.0f}, bf16 {peaks['bf16'] / 1e12:.0f} TFLOP/s, "
          f"memory {peak_bw / 1e12:.2f} TB/s")
    require(not torch.backends.cuda.matmul.allow_tf32, "fp32 matmuls must not use TF32")

    # ------------------------------------------------------------------
    phase("2. build")
    t0 = time.perf_counter()
    built = _build.build_all()
    print(f"nvcc {_build.nvcc_path()} built {sorted(built)} in "
          f"{time.perf_counter() - t0:.1f} s ({' '.join(_build.NVCC_FLAGS)})")
    # registers, spills (LOCAL) and static shared memory of each instance
    cuobjdump = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    for name in sorted(built):
        usage = subprocess.run([cuobjdump, "--dump-resource-usage",
                                str(_build.library_path(name))],
                               capture_output=True, text=True, timeout=120)
        label, shown = None, 0
        for line in usage.stdout.splitlines():
            # K1 instances are <dtype, Chp> (..._kernelIfLi32EE...), K2's
            # <dtype, taps folded into K> (..._kernelIfLb1EE...)
            m = re.search(r"_kernelI(f|13__nv_bfloat16)(?:Li(\d+)E)?(?:Lb([01])E)?E", line)
            if m:
                label = "<" + ("fp32" if m.group(1) == "f" else "bf16") + (
                    f", chp {m.group(2)}" if m.group(2) else "") + (
                    {"1": ", folded", "0": ", per tap"}[m.group(3)] if m.group(3) else "") + ">"
            res = re.search(r"REG:\d+ STACK:\d+ SHARED:\d+ LOCAL:\d+", line)
            if res and label:
                print(f"  {name} {label}: {res.group(0)}")
                label, shown = None, shown + 1
        if not shown:
            print(f"  cuobjdump (exit {usage.returncode}) reported no resource usage: "
                  f"{(usage.stdout + usage.stderr).strip()[:300]!r}")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    k1_blocks = {}
    for prec, dt in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        for chp_ in ttf.SUPPORTED_CHP:
            k1_blocks[f"{prec}/chp{chp_}"] = ttf.blocks_per_sm(dev, dt, chp_)
    print(f"  tilted_fusion resident CTAs per SM ({ttf.THREADS} threads, {sms} SMs): "
          + ", ".join(f"<{k}> {v}" for k, v in k1_blocks.items()))
    k2_occ = {}
    for prec, dt in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        for kind, ci_ in (("folded", 3), ("per tap", 28)):
            k2_occ[f"{prec}/{kind}"] = dict(blocks_per_sm=k2.blocks_per_sm(dev, dt, ci_),
                                            smem_bytes=k2.smem_bytes(dt, ci_))
    print(f"  conv3x3 persistent CTAs ({k2.TILE_ROWS}x{k2.TILE_COLS} output tiles; taps folded "
          f"into K at Ci <= 3): " + ", ".join(
              f"<{k}> {v['smem_bytes']} B shared memory, {v['blocks_per_sm']} CTAs per SM"
              for k, v in k2_occ.items()))

    # ------------------------------------------------------------------
    phase("3. K1 vs its plain version on the card (design point)")
    gen = torch.Generator().manual_seed(1)
    # init_abpn's biases are zero; seeded non-zero ones check the bias path
    layers = [ConvLayer(l.w, (0.1 * torch.randn(l.b.shape, generator=gen)).to(dev), l.relu)
              for l in init_abpn(torch.Generator().manual_seed(0), device=dev)]
    require(all(bool((l.b != 0).all()) for l in layers), "every bias must be non-zero")
    relu = [l.relu for l in layers]
    frame = torch.rand((1, H, W, 3), generator=gen).to(dev)
    L, C = len(layers), 8

    # TF32 off under exact_fp32: the fp32 reference must match fp64
    band = frame[:, :60, :128]
    ref32 = conv_stack_reference(band, layers)
    ref64 = conv_stack_reference(band.double(), [l.to(dtype=torch.float64) for l in layers])
    tf32_err = (ref32.double() - ref64).abs().max().item()
    print(f"conv_stack_reference fp32 vs fp64: max_abs_err={tf32_err:.3e}")
    require(tf32_err < 1e-4, "the fp32 reference must run without TF32")

    bands = frame.reshape(H // 60, 60, W, 3)
    slabs, bounds = halo_slabs(frame, 60, L)
    prime = torch.rand((1, 61, W, 3), generator=gen).to(dev)  # one-band fallback
    cases = [
        ("zero", bands, dict(row_policy="zero")),
        ("replicate", bands, dict(row_policy="replicate")),
        ("halo (74-row slabs, bounds)", slabs, dict(row_policy="zero", row_bounds=bounds)),
        ("zero + anchor", bands, dict(row_policy="zero", add_anchor=True)),
        ("61-row frame as one band", prime, dict(row_policy="replicate")),
    ]
    worst = {}
    for prec, dt in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        packed = ops.pack_stack([l.to(dtype=dt) for l in layers], dtype=dt)
        for name, xb, extra in cases:
            xs, first = ops.band_streams(xb.to(dt), C, L)
            kw = dict(width=W, tile_cols=C, relu_flags=relu, in_channels=3,
                      anchor_repeats=SCALE * SCALE, add_anchor=False)
            kw.update(extra)
            got = kcall(xs, first, packed.w, packed.b, **kw)
            torch.cuda.synchronize()
            want = ttf.tilted_fusion_plain(xs, first, packed.w, packed.b, **kw)
            require(got.shape == want.shape and got.dtype == want.dtype, f"{name} shape/dtype")
            require(bool(torch.isfinite(got.float()).all()), f"{name} {prec}: non-finite output")
            err = (got.float() - want.float()).abs().max().item()
            worst[prec] = max(worst.get(prec, 0.0), err)
            print(f"K1 vs plain [{prec}, {name}, B={xs.shape[0]} R={xs.shape[1]}]: "
                  f"max_abs_err={err:.3e} (tol {TOL[prec]:g})")
            require(err <= TOL[prec], f"K1 vs plain {prec} {name}")
            # column segments must not change a bit
            K = xs.shape[2] // C
            one = kcall(xs, first, packed.w, packed.b, segments=1, **kw)
            auto = ttf.launch_plan(xs, packed.w, tile_cols=C).segments
            for segs in (2, 3, None, K):
                require(torch.equal(kcall(xs, first, packed.w, packed.b, segments=segs, **kw),
                                    one), f"K1 {prec} {name}: segments={segs} changed the output")
            require(torch.equal(got, one), f"K1 {prec} {name}: auto plan vs one segment")
            print(f"  segments 1, 2, 3, {auto} (auto), {K}: bit-identical")

    # ------------------------------------------------------------------
    phase("3b. K2 vs its plain version on the card (ABPN x3 layer shapes, 360x640)")

    def k2_check(label, prec, x, w_, b_, relu_, tile_cols=8):
        got = k2call(x, w_, b_, tile_cols=tile_cols, relu=relu_)
        torch.cuda.synchronize()
        want = k2.conv3x3_plain(x, w_, b_, tile_cols=tile_cols, relu=relu_)
        require(got.shape == want.shape and got.dtype == want.dtype, f"K2 {label} shape/dtype")
        require(bool(torch.isfinite(got.float()).all()), f"K2 {label} {prec}: non-finite output")
        diff = (got.float() - want.float()).abs()
        atol, rtol = (2e-5, 1e-5) if prec == "fp32" else (2e-2, 2e-2)
        err = diff.max().item()
        k2_worst[prec] = max(k2_worst.get(prec, 0.0), err)
        print(f"K2 vs plain [{prec}, {label}, {tuple(x.shape)} -> {w_.shape[3]}, tile "
              f"{tile_cols}]: max_abs_err={err:.3e} (tol {atol:g} + {rtol:g}|want|)")
        require(bool((diff <= atol + rtol * want.float().abs()).all()), f"K2 vs plain {prec} {label}")
        return want

    k2_worst = {}
    k2_inputs = []  # fp32 input of every layer, for the phase-5 timings
    for prec, dt in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        f = frame[0].to(dt)
        for i, l in enumerate(layers):
            if dt == torch.float32:
                k2_inputs.append(f)
            f = k2_check(f"layer {i}", prec, f, l.w.to(dt), l.b.to(dt), l.relu)
        # a width that is not a multiple of the tile: the last CTA reads zeros
        l = layers[2]
        k2_check("width 637", prec, k2_inputs[2][:, :637].to(dt), l.w.to(dt), l.b.to(dt), l.relu)

    # ------------------------------------------------------------------
    phase("4. main path: SRServer.open('abpn_x3', backend='kernel') serving")
    rng = np.random.default_rng(2)
    req4 = rng.uniform(size=(4, H, W, 3)).astype(np.float32)
    pair = [rng.uniform(size=(2, H, W, 3)).astype(np.float32) for _ in range(2)]
    small = rng.uniform(size=(H // 2, W // 2, 3)).astype(np.float32)
    kcall.launches = 0  # count the main path's launches only
    per_config = {}
    for prec, policy in (("fp32", "zero"), ("bf16", "zero"), ("int8", "zero"), ("fp32", "halo"),
                         ("fp32", "replicate"), ("bf16", "halo"), ("int8", "halo")):
        before = kcall.launches
        server = engine.SRServer.open("abpn_x3", backend="kernel", precision=prec,
                                      vertical_policy=policy, layers=layers)
        hr4 = server.submit(req4).result()
        s0 = server.scheduler_stats()
        futs = [server.submit(p) for p in pair]  # submitted together
        hr_pair = [f.result() for f in futs]
        s1 = server.scheduler_stats()
        require(s1["dispatches"] - s0["dispatches"] == 1
                and s1["coalesced_dispatches"] - s0["coalesced_dispatches"] == 1,
                f"{prec}/{policy}: the two 2-frame requests must share one dispatch")
        hr_small = server.submit(small).result()
        alone = server.submit(req4[0]).result()
        require(torch.equal(alone, hr4[0]),
                f"{prec}/{policy}: a frame served alone must equal it served in a batch")
        dispatches = server.scheduler_stats()["dispatches"]
        server.close()
        launched = kcall.launches - before
        require(launched > 0, f"{prec}/{policy}: K1 was never launched")

        errs = []
        for lr, hr in ((req4, hr4), (np.concatenate(pair), torch.cat(hr_pair)),
                       (small[None], hr_small[None])):
            plan = engine.make_plan(layers, lr.shape[1:], backend="tilted", precision=prec,
                                    vertical_policy=policy, band_rows=engine.derive_band_rows(
                                        lr.shape[1]), scale=SCALE)
            want = engine.run(plan, layers, lr, device=dev)
            require(tuple(hr.shape) == (lr.shape[0], lr.shape[1] * SCALE, lr.shape[2] * SCALE, 3),
                    f"{prec}/{policy}: HR shape {tuple(hr.shape)}")
            require(bool(torch.isfinite(hr).all()), f"{prec}/{policy}: non-finite HR output")
            errs.append((hr.float() - want.float()).abs().max().item())
        err = max(errs)
        per_config[f"{prec}/{policy}"] = {"launches": launched, "max_abs_err": err}
        print(f"server [{prec}, {policy}]: K1 launches {launched}, dispatches "
              f"{dispatches}, HR vs tilted backend max_abs_err={err:.3e} "
              f"(tol {TOL[prec]:g}); batch-independent bit-exact: yes")
        require(err <= TOL[prec], f"{prec}/{policy}: server output vs tilted backend")
    main_launches = kcall.launches
    print(f"main path K1 launches: {main_launches}")
    require(main_launches > 0, "the main path never launched K1")

    # ------------------------------------------------------------------
    phase("4b. layer-by-layer path: ABPN x3 as 7 ops.conv3x3 launches per frame")
    lw_frames = torch.from_numpy(
        np.random.default_rng(3).uniform(size=(2, H, W, 3)).astype(np.float32)).to(dev)
    k2call.launches = 0  # count the layer-by-layer path's launches only
    per_layerwise = {}
    for prec in ("fp32", "bf16"):
        before = k2call.launches
        plan = engine.make_plan(layers, (H, W, 3), backend="reference", precision=prec,
                                scale=SCALE)
        prepared = engine.prepare_layers(layers, prec)
        x = lw_frames.to(engine.compute_dtype_for(prec))
        feats = []
        for n in range(x.shape[0]):
            f = x[n]
            for l in prepared:
                f = ops.conv3x3(f, l.w, l.b, relu=l.relu)
            feats.append(f)
        hr = engine.sr_epilogue(plan, x, torch.stack(feats), lw_frames.dtype)
        launched = k2call.launches - before
        want = engine.run(plan, layers, lw_frames, device=dev)
        require(tuple(hr.shape) == (2, H * SCALE, W * SCALE, 3), f"layerwise {prec}: HR shape")
        require(bool(torch.isfinite(hr).all()), f"layerwise {prec}: non-finite HR output")
        err = (hr.float() - want.float()).abs().max().item()
        per_layerwise[prec] = {"launches": launched, "max_abs_err": err}
        print(f"layer by layer [{prec}]: K2 launches {launched} (7 per frame), HR vs reference "
              f"backend max_abs_err={err:.3e} (tol {TOL[prec]:g})")
        require(launched == 7 * x.shape[0], f"layerwise {prec}: K2 launches {launched}")
        require(err <= TOL[prec], f"layerwise {prec}: HR output vs reference backend")
    layerwise_launches = k2call.launches
    print(f"layer-by-layer path K2 launches: {layerwise_launches}")
    require(layerwise_launches > 0, "the layer-by-layer path never launched K2")

    # ------------------------------------------------------------------
    phase("4c. temporal delta path: server.stream(clip, delta=True), partial-band K1 dispatches")
    import asyncio

    from repro_torch.engine.temporal import band_bounds, band_slabs
    from repro_torch.runtime.resilience import FailureInjector, InjectedFailure

    R = 60
    drng = np.random.default_rng(5)

    def patch(rows, cols):
        return drng.uniform(size=(rows, cols, 3)).astype(np.float32)

    f0 = drng.uniform(size=(H, W, 3)).astype(np.float32)
    f2 = f0.copy()
    f2[2 * R + 10:2 * R + 20, W // 6:W // 3] = patch(10, W // 3 - W // 6)  # inside band 2
    f3 = f2.copy()
    # bands 0 and 5, at the frame's top and bottom edges
    f3[5:15, W // 2:2 * W // 3] = patch(10, 2 * W // 3 - W // 2)
    f3[5 * R + 40:5 * R + 50, 3 * W // 4:7 * W // 8] = patch(10, 7 * W // 8 - 3 * W // 4)
    f4 = drng.uniform(size=(H, W, 3)).astype(np.float32)
    clip = [f0, f0.copy(), f2, f3, f4, f4.copy()]
    # bands skipped per frame; halo's reach is ceil(7 / 60) = 1 band a side
    want_skipped = {"zero": [0, 6, 5, 4, 0, 6], "replicate": [0, 6, 5, 4, 0, 6],
                    "halo": [0, 6, 3, 2, 0, 6]}

    # K1 at the delta path's shapes against its plain version, and each real
    # band bit-identical to the same band of the 6-band full-frame launch
    # (their segment plans differ); not counted as launches of the path
    packed32 = ops.pack_stack(layers, dtype=torch.float32)
    kw1 = dict(width=W, tile_cols=C, relu_flags=relu, in_channels=3, add_anchor=False)
    full_f2 = torch.from_numpy(f2).to(dev)
    delta_k1 = {}
    for name, bands_, policy in (("1 band (zero)", [2], "zero"),
                                 ("3 bands + 1 padded slot (halo)", [1, 2, 3], "halo")):
        slabs_ = torch.from_numpy(band_slabs(f2, R, L, bands_, policy)).to(dev)
        if policy == "halo":
            full_x, full_b = halo_slabs(full_f2[None], R, L)
            bnds = torch.from_numpy(band_bounds(H, R, L, bands_, slots=4)).to(dev)
            slabs_ = torch.cat([slabs_, torch.zeros_like(slabs_[:1])])
            extra = dict(row_policy="zero", row_bounds=bnds)
            full_extra = dict(row_policy="zero", row_bounds=full_b)
        else:
            full_x = full_f2.reshape(H // R, R, W, 3)
            extra = full_extra = dict(row_policy="zero")
        xs, first = ops.band_streams(slabs_, C, L)
        got = kcall(xs, first, packed32.w, packed32.b, **kw1, **extra)
        want = ttf.tilted_fusion_plain(xs, first, packed32.w, packed32.b, **kw1, **extra)
        fxs, ffirst = ops.band_streams(full_x, C, L)
        full_out = kcall(fxs, ffirst, packed32.w, packed32.b, **kw1, **full_extra)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        segs = ttf.launch_plan(xs, packed32.w, tile_cols=C).segments
        full_segs = ttf.launch_plan(fxs, packed32.w, tile_cols=C).segments
        require(err <= TOL["fp32"], f"K1 vs plain at the delta shape {name}")
        for i, b_ in enumerate(bands_):
            require(torch.equal(got[i], full_out[b_]),
                    f"K1 {name}: band {b_} differs from the full-frame launch's")
        if policy == "halo":
            require(not bool(got[3].any()), "K1: a padded slot with bounds (0, 0) must be zero")
        delta_k1[name] = {"max_abs_err": err, "segments": segs, "full_frame_segments": full_segs}
        print(f"K1 vs plain [fp32, {name}, B={xs.shape[0]} R={xs.shape[1]}]: max_abs_err="
              f"{err:.3e} (tol {TOL['fp32']:g}); segments S={segs} (the full frame's "
              f"S={full_segs}); every real band bit-identical to the full-frame launch")

    kcall.launches = 0  # count the delta path's launches only
    delta_configs = {}
    hardening = {}
    for prec, policy in (("fp32", "zero"), ("fp32", "replicate"), ("fp32", "halo"),
                         ("bf16", "zero")):
        tag = f"{prec}/{policy}"
        before = kcall.launches
        server = engine.SRServer.open("abpn_x3", backend="kernel", precision=prec,
                                      vertical_policy=policy, layers=layers)
        session = server.session()

        async def serve_clip():
            outs, cumulative = [], []
            async for hr in server.stream(clip, delta=True):
                outs.append(hr)
                cumulative.append(session.temporal_stats()["bands_skipped"])
            return outs, cumulative

        async def abandon():
            gen = server.stream(clip, delta=True)
            seen = 0
            async for _ in gen:
                seen += 1
                if seen == 2:
                    break
            await gen.aclose()
            return seen

        outs, cumulative = asyncio.run(serve_clip())
        stats = session.temporal_stats()
        recent = [d for d in server.scheduler_stats()["recent_dispatches"] if d["bands"]]
        pinned_after_clip = session.output_cache().pinned
        require(asyncio.run(abandon()) == 2, f"delta {tag}: the abandoned stream's frames")
        launched = kcall.launches - before
        sched = server.scheduler_stats()
        require(session.output_cache().pinned == 0 and pinned_after_clip == 0,
                f"delta {tag}: cache pins left after a closed or abandoned stream")
        require(sched["pending_frames"] == 0 and sched["inflight_dispatches"] == 0
                and sched["carry_buckets"] == 0, f"delta {tag}: work left queued")
        skipped = [b_ - a_ for a_, b_ in zip([0] + cumulative[:-1], cumulative)]
        fulls = [server.submit(f).result() for f in clip]
        for i, (got, want) in enumerate(zip(outs, fulls)):
            require(got.device.type == "cuda" and got.dtype == want.dtype
                    and got.shape == want.shape, f"delta {tag}: frame {i} shape/dtype/device")
            require(bool(torch.isfinite(got.float()).all()), f"delta {tag}: non-finite frame {i}")
            require(torch.equal(got, want),
                    f"delta {tag}: frame {i} differs from a full re-upscale")
        require(skipped == want_skipped[policy],
                f"delta {tag}: bands skipped per frame {skipped} != {want_skipped[policy]}")
        require(stats["cover_violations"] == 0, f"delta {tag}: splice rule violated")
        require(stats["band_dispatches"] == 4, f"delta {tag}: {stats['band_dispatches']} "
                "partial-band dispatches, not 4")
        require(launched > 0, f"delta {tag}: K1 was never launched")
        delta_configs[tag] = {
            "launches": launched, "skipped_per_frame": skipped,
            "reuse_ratio": stats["reuse_ratio"], "band_dispatches": stats["band_dispatches"],
            "dispatches": [(d["bands"], d["bucket"]) for d in recent],
            "effective_hbm_bytes_per_frame": stats["effective_hbm_bytes_per_frame"],
            "full_hbm_bytes_per_frame": stats["full_hbm_bytes_per_frame"],
        }
        print(f"delta [{prec}, {policy}]: K1 launches {launched}; bands skipped per frame "
              f"{skipped}; reuse {stats['reuse_ratio']:.3f}; partial dispatches (bands -> "
              f"bucket) {[(d['bands'], d['bucket']) for d in recent]}; every frame bit-identical "
              f"to a full re-upscale; no pins or queued work after an abandoned stream")
        if (prec, policy) == ("fp32", "zero"):
            # a request past its deadline, with a neighbour it would have
            # coalesced with
            s0 = server.scheduler_stats()
            keeper = server.submit(clip[0])
            doomed = server.submit(clip[2], timeout=0.05)
            time.sleep(0.2)
            kept = keeper.result()
            s1 = server.scheduler_stats()
            require(isinstance(doomed.exception(), engine.DeadlineExceededError),
                    "a request past its deadline must fail with DeadlineExceededError")
            require(s1["expired"] - s0["expired"] == 1 and s1["dispatches"] - s0["dispatches"] == 1
                    and s1["recent_dispatches"][-1]["frames"] == 1,
                    "the expired request must leave the queue before its neighbour dispatches")
            require(torch.equal(kept, fulls[0]), "the deadline's neighbour must serve exactly")
            server.close()
            # an injected failure of the second dispatch fails only its request
            injector = FailureInjector(fail_dispatches={1})
            srv = engine.SRServer(session, injector=injector)
            ok_a = srv.submit(clip[0]).result()
            failed = srv.submit(clip[2])
            require(isinstance(failed.exception(), InjectedFailure),
                    "the injected dispatch failure must fail its request")
            ok_c = srv.submit(clip[4]).result()
            require(torch.equal(ok_a, fulls[0]) and torch.equal(ok_c, fulls[4]),
                    "requests around an injected failure must serve exactly")
            require(injector.stats()["injected_failures"] == 1, "one injected failure")
            srv.close()
            # degrade level 1: fp32 requests dispatch in bf16; delta streams
            # keep their dtype and stay exact
            policy_ = engine.DegradePolicy(1e9)
            policy_.level = 1
            srv = engine.SRServer(session, degrade=policy_)
            pair_ = np.stack([clip[0], clip[4]])
            hr16 = srv.submit(pair_).result()
            require(hr16.dtype == torch.bfloat16 and srv.scheduler_stats()[
                "recent_dispatches"][-1]["dtype"] == "bfloat16",
                "degrade level 1 must dispatch fp32 requests in bf16")
            tplan = engine.make_plan(layers, (H, W, 3), backend="tilted", scale=SCALE)
            deg_err = (hr16.float() - engine.run(tplan, layers, pair_, device=dev)).abs().max().item()
            require(deg_err <= TOL["bf16"], f"degrade level 1 HR vs tilted {deg_err:.3e}")

            async def one_delta():
                return [hr async for hr in srv.stream(clip[:1], delta=True)]

            (d0,) = asyncio.run(one_delta())
            require(d0.dtype == torch.float32 and torch.equal(d0, fulls[0]),
                    "a delta stream under degrade must stay fp32 and exact")
            srv.close()
            hardening = {"deadline": "DeadlineExceededError, neighbour exact",
                         "injector": "InjectedFailure on dispatch 1 only",
                         "degrade_bf16_max_abs_err": deg_err}
            print(f"hardening [fp32, zero]: past deadline -> DeadlineExceededError, neighbour "
                  f"served alone and exact; injected failure of dispatch 1 failed only its "
                  f"request; degrade level 1 served fp32 requests in bf16, HR vs tilted "
                  f"max_abs_err={deg_err:.3e} (tol {TOL['bf16']:g}), a delta stream stayed fp32 "
                  f"and exact")
        else:
            server.close()
    delta_launches = sum(v["launches"] for v in delta_configs.values())
    print(f"delta path K1 launches: {delta_launches}")
    require(delta_launches > 0, "the delta path never launched K1")

    # ------------------------------------------------------------------
    phase("4d. autotune and static analysis (engine.autotune, repro_torch.analysis)")
    from repro_torch.analysis import program_audit
    from repro_torch.analysis import sweep as analysis_sweep
    from repro_torch.engine import autotune

    kcall.launches = 0  # count this path's launches only
    k2call.launches = 0
    t0 = time.perf_counter()
    detected = autotune.RooflinePeaks.detect(dev)
    calib_s = time.perf_counter() - t0
    print(f"RooflinePeaks.detect on {smi}: fp32 {detected.flops_per_s / 1e12:.2f} TFLOP/s "
          f"(SM count x 128 lanes x 2 x the SM clock timed over a spin), memory "
          f"{detected.hbm_bytes_per_s / 1e12:.3f} TB/s (a timed 256 MiB device-to-device "
          f"copy), cache {detected.cache_bytes / 2**20:.0f} MiB (L2) in {calib_s:.2f} s; "
          f"data sheet (PEAKS, for bounds): fp32 {peak_flops / 1e12:.0f} TFLOP/s, memory "
          f"{peak_bw / 1e12:.2f} TB/s")
    require(0.3 * peak_flops < detected.flops_per_s < 1.5 * peak_flops
            and 0.3 * peak_bw < detected.hbm_bytes_per_s < 1.5 * peak_bw,
            "the calibrated peaks must be within reach of the data sheet's")
    tune_plan = engine.SRPlan.from_request((H, W, 3), num_layers=L, vertical_policy="halo",
                                           backend="kernel", precision="fp32", scale=SCALE)
    db = autotune.TuningDB(tuning_db)
    t0 = time.perf_counter()
    tuned = autotune.tune(layers, tune_plan, 8, db=db, peaks=detected)
    tune_s = time.perf_counter() - t0
    cands = tuned.candidates
    for c in cands:
        print(f"  candidate band_rows={c.band_rows} bucket={c.bucket} depth={c.pipeline_depth}"
              f"{' (default)' if c.is_default else ''}: predicted {c.predicted_ms:.4f} ms/frame, "
              + ("pruned" if c.pruned else f"measured {c.measured_ms:.4f} ms/frame"))
    print(f"tune [fp32, halo, batch 8, {H}x{W}, kernel]: winner band_rows={tuned.band_rows} "
          f"depth={tuned.pipeline_depth} bucket={tuned.bucket} ({tuned.bucket_policy}): "
          f"{tuned.measured_ms:.4f} ms/frame against the default's {tuned.default_ms:.4f} "
          f"(x{tuned.speedup:.4f}); {sum(not c.pruned for c in cands)} of {len(cands)} "
          f"candidates measured; sweep {tune_s:.2f} s")
    require(tuned.measured_ms <= tuned.default_ms, "the tuned schedule must not be slower")
    require(db.get(autotune.TuningKey.from_plan(tune_plan, 8), device=dev) is not None,
            "the winner must be in the DB, stamped for this card")

    # every candidate band_rows is bit-identical to the default's under halo
    trng = np.random.default_rng(6)
    halo_frames = trng.uniform(size=(2, H, W, 3)).astype(np.float32)
    band_choices = sorted({c.band_rows for c in cands})
    halo_equal = {}
    for prec in ("fp32", "bf16"):
        outs = {}
        for band in band_choices:
            p = dataclasses.replace(tune_plan, band_rows=band, precision=prec)
            outs[band] = engine.SRSession.from_plan(p, layers, autotune="off").upscale(
                halo_frames)
        base = outs[engine.derive_band_rows(H)]
        for band, out in outs.items():
            require(bool(torch.isfinite(out.float()).all()), f"halo {prec} R={band}: non-finite")
            require(torch.equal(out, base), f"halo {prec}: band_rows={band} differs from the "
                    f"default's output")
        halo_equal[prec] = band_choices
        print(f"halo [{prec}]: band_rows {band_choices} bit-identical to the default "
              f"({engine.derive_band_rows(H)}) on 2 frames of {H}x{W}")

    # autotune="full" on a DB of its own (the sweep above would answer its
    # lookup as the nearest tuned batch): the first request runs a sweep,
    # then serves exactly
    req = trng.uniform(size=(4, H, W, 3)).astype(np.float32)
    full_db = os.path.join(ROOT, "build", "chip_smoke_tuning_full.json")
    if os.path.exists(full_db):
        os.remove(full_db)
    full = engine.SRServer.open("abpn_x3", backend="kernel", vertical_policy="halo",
                                layers=layers, autotune="full", tuning_db=full_db)
    t0 = time.perf_counter()
    hr_full = full.submit(req).result()
    torch.cuda.synchronize()
    first_request_s = time.perf_counter() - t0
    full_stats = full.session().tuning_stats()
    full_plan = full.session().plan_for((H, W, 3))
    off = engine.SRServer.open("abpn_x3", backend="kernel", vertical_policy="halo",
                               layers=layers, autotune="off")
    hr_off = off.submit(req).result()
    require(full_stats["tuned_now"] == 1 and full_stats["misses"] == 1,
            f"autotune='full' must tune on its first miss: {full_stats}")
    require(torch.equal(hr_full, hr_off), "the autotune='full' server must serve exactly what "
            "the autotune='off' server serves")
    audit_tuned = program_audit.audit_session(full.session())
    full.close()
    off.close()
    print(f"server autotune='full' [fp32, halo, 4 frames]: first request {first_request_s:.2f} s "
          f"with the sweep (band_rows={full_plan.band_rows}, depth "
          f"{full_stats['pipeline_depth']}, exact buckets {full_stats['exact_buckets']}); output "
          f"bit-identical to autotune='off'; its program audit: "
          f"{[f.format() for f in audit_tuned] or 'clean'}")
    require(not [f for f in audit_tuned if f.severity == "error"], "tuned session audit")

    t0 = time.perf_counter()
    report = analysis_sweep.analysis_report(device=dev)
    report_s = time.perf_counter() - t0
    print(f"analysis_report(device=cuda) in {report_s:.1f} s (program sweep: "
          f"{list(analysis_sweep.PROGRAM_SWEEP_CONFIGS + analysis_sweep.CARD_SWEEP_CONFIGS)}"
          f"): {json.dumps(report)}")
    require(report["clean"], "analysis_report must hold no error finding")
    autotune_launches = kcall.launches
    print(f"autotune/analysis path K1 launches: {autotune_launches}, K2 launches: "
          f"{k2call.launches}")
    require(autotune_launches > 0, "the autotune path never launched K1")
    autotune_path = {
        "launches": autotune_launches,
        "peaks": dataclasses.asdict(detected), "calibration_s": calib_s,
        "tune": {"winner": {"band_rows": tuned.band_rows, "depth": tuned.pipeline_depth,
                            "bucket": tuned.bucket},
                 "default_ms_per_frame": tuned.default_ms,
                 "tuned_ms_per_frame": tuned.measured_ms, "speedup": tuned.speedup,
                 "sweep_s": tune_s,
                 "candidates": [dataclasses.asdict(c) for c in cands]},
        "halo_bit_identical_band_rows": halo_equal,
        "full_first_request_s": first_request_s,
        "analysis_report": report,
    }

    # ------------------------------------------------------------------
    phase("4e. sharded serving: band shards and replicas on one card's streams")
    from repro_torch.engine.sharding import (MeshSpec, ShardedPlan, build_sharded_executor,
                                             halo_exchange_bytes_per_frame)
    from repro_torch.launch.mesh import band_submesh, make_sr_mesh

    # every mesh position is this card; each has its own stream (made once
    # with the mesh), so these are streams of one GPU, not GPUs
    bands_of = {S: band_submesh(make_sr_mesh(1, S, devices=[dev] * S), 0) for S in (1, 2, 4)}
    mesh22 = make_sr_mesh(2, 2, devices=[dev] * 4)
    srng = np.random.default_rng(8)
    frames8 = torch.from_numpy(srng.uniform(size=(8, H, W, 3)).astype(np.float32)).to(dev)

    def shard_plan(S, policy, prec="fp32"):
        # 360 rows re-band to 60 for S = 2 (6 bands) and 45 for S = 4 (8)
        rows = engine.shardable_band_rows(H, S) if S > 1 else engine.derive_band_rows(H)
        return engine.SRPlan(height=H, width=W, num_layers=L, band_rows=rows,
                             vertical_policy=policy, backend="kernel", precision=prec,
                             scale=SCALE)

    def sharded_fn(plan_s, S, stack_s):
        return build_sharded_executor(ShardedPlan(plan=plan_s, spec=MeshSpec(1, S)), stack_s,
                                      bands_of[S])

    # 1. the executor, bit for bit against the single-device executor at
    # the same band_rows; K1 launches once per shard
    shard_exact = {}
    for prec in ("fp32", "bf16", "int8"):
        stack_p = engine.prepare_stack(shard_plan(2, "zero", prec), layers)
        for policy in ("zero", "halo", "replicate"):
            for S in (2, 4):
                plan_s = shard_plan(S, policy, prec)
                want = engine.build_stack_executor(plan_s, stack_p)(frames8)
                fn = sharded_fn(plan_s, S, stack_p)
                before = kcall.launches
                got = fn(frames8)
                launched = kcall.launches - before
                torch.cuda.synchronize()
                tag = f"sharded executor {prec}/{policy} S={S} (R={plan_s.band_rows})"
                require(launched == S, f"{tag}: {launched} K1 launches, not one per shard")
                require(got.shape == want.shape and got.dtype == want.dtype, f"{tag}: shape/dtype")
                require(bool(torch.isfinite(got.float()).all()), f"{tag}: non-finite output")
                require(torch.equal(got, want), f"{tag}: differs from the single-device executor")
                shard_exact[f"{prec}/{policy}/S={S}"] = plan_s.band_rows
    print(f"sharded executor, 8 frames of {H}x{W}, kernel, on [cuda:0] * S (one stream per "
          f"shard): fp32/bf16/int8 x zero/halo/replicate x S = 2 (R = 60) and S = 4 (R = 45) "
          f"torch.equal to the single-device executor at the same R; K1 launched once per "
          f"shard in each call")
    shard_segments = {}
    for S in (1, 2, 4):
        for policy in ("zero", "halo"):
            plan_s = shard_plan(S, policy)
            per_shard = 8 * plan_s.num_bands // S
            rows = plan_s.band_rows + (2 * L if policy == "halo" else 0)
            xs, _ = ops.band_streams(torch.zeros((per_shard, rows, W, 3), device=dev), C, L)
            sp = ttf.launch_plan(xs, packed32.w, tile_cols=C)
            xs1, _ = ops.band_streams(torch.zeros((8 * plan_s.num_bands, rows, W, 3),
                                                  device=dev), C, L)
            sp1 = ttf.launch_plan(xs1, packed32.w, tile_cols=C)
            # tiles a band executes: its K tiles plus every segment's warm-up
            tiles = lambda p: sum(k1 - kw for kw, _, k1 in p.ranges())  # noqa: E731
            shard_segments[f"{policy}/S={S}"] = dict(
                bands=per_shard, segments=sp.segments, ctas=sp.ctas, warmup=sp.warmup,
                tiles_per_band=tiles(sp), single_device_segments=sp1.segments,
                single_device_tiles_per_band=tiles(sp1))
            print(f"  K1 per shard [{policy}, S={S}, R={plan_s.band_rows}, 8 frames]: "
                  f"{per_shard} bands, segments S={sp.segments}, {sp.ctas} CTAs, "
                  f"{tiles(sp)} tiles a band with warm-up; {S} launches a call; one "
                  f"launch of all {8 * plan_s.num_bands} bands: S={sp1.segments}, "
                  f"{tiles(sp1)} tiles a band")

    # 2. a (2, 2) mesh session behind SRServer, against an unsharded one;
    # 3. delta serving on it; 4. the program audit of its launch
    from repro_torch.analysis import program_audit

    reqs = [srng.uniform(size=(2, H, W, 3)).astype(np.float32) for _ in range(8)]
    mesh_path = {}
    sharded_launches = 0
    for policy in ("halo", "zero"):
        flat = engine.SRServer.open("abpn_x3", backend="kernel", vertical_policy=policy,
                                    layers=layers, autotune="off")
        wants = [flat.submit(r).result() for r in reqs]
        flat_clip = [flat.submit(f).result() for f in clip]
        flat.close()
        msrv = engine.SRServer.open("abpn_x3", backend="kernel", vertical_policy=policy,
                                    layers=layers, autotune="off", mesh=mesh22)
        msession = msrv.session()
        kcall.launches = 0  # count this path's launches only
        gots = [msrv.submit(r).result() for r in reqs]  # closed loop: one dispatch each

        async def serve_mesh_clip():
            outs, cumulative = [], []
            async for hr in msrv.stream(clip, delta=True):
                outs.append(hr)
                cumulative.append(msession.temporal_stats()["bands_skipped"])
            return outs, cumulative

        outs, cumulative = asyncio.run(serve_mesh_clip())
        launched = kcall.launches
        sharded_launches += launched
        tag = f"(2, 2) mesh server [fp32, {policy}]"
        for i, (g, w) in enumerate(zip(gots, wants)):
            require(g.shape == w.shape and bool(torch.isfinite(g).all()), f"{tag}: request {i}")
            require(torch.equal(g, w), f"{tag}: request {i} differs from the unsharded server")
        stats = msession.sharding_stats()
        per_replica = [r["dispatches"] for r in stats["replicas"]]
        require(stats["mesh"] == "2x2" and all(n >= 1 for n in per_replica),
                f"{tag}: both replicas must serve: {per_replica}")
        skipped = [b_ - a_ for a_, b_ in zip([0] + cumulative[:-1], cumulative)]
        fulls = [msrv.submit(f).result() for f in clip]
        for i, (got, want) in enumerate(zip(outs, fulls)):
            require(torch.equal(got, want), f"{tag}: delta frame {i} differs from "
                    "server.submit(frame).result()")
            require(torch.equal(want, flat_clip[i]), f"{tag}: clip frame {i} differs from the "
                    "unsharded server")
        require(skipped == want_skipped[policy] and sum(skipped) > 0,
                f"{tag}: delta bands skipped per frame {skipped} != {want_skipped[policy]}")
        require(launched > 0, f"{tag}: K1 was never launched")
        audit = program_audit.audit_server(msrv, lambda: msrv.submit(clip[0]))
        require(audit == [], f"{tag}: program audit {[f.format() for f in audit]}")
        stats = msession.sharding_stats()
        mesh_path[policy] = {
            "launches": launched, "requests_bit_exact": len(reqs),
            "replica_fill": stats["replica_fill"],
            "replica_dispatches": [r["dispatches"] for r in stats["replicas"]],
            "halo_bytes_per_frame": stats["halo_bytes_per_frame"],
            "delta_skipped_per_frame": skipped, "audit": "clean",
        }
        print(f"{tag}: {len(reqs)} 2-frame requests torch.equal to an unsharded server; "
              f"sharding_stats: mesh {stats['mesh']}, policy {stats['policy']}, replica_fill "
              f"{stats['replica_fill']:.3f}, dispatches per replica "
              f"{mesh_path[policy]['replica_dispatches']}, halo bytes per frame "
              f"{stats['halo_bytes_per_frame']}; stream(clip, delta=True) every frame "
              f"torch.equal to submit(frame).result(), bands skipped {skipped}; audit_server "
              f"clean; K1 launches {launched}")
        msrv.close()
    print(f"sharded path K1 launches: {sharded_launches}")
    require(sharded_launches > 0, "the sharded path never launched K1")

    # 5. times: queued device time per 8-frame call (calls queued behind a
    # device sleep, CUDA events on the caller's stream, which every shard
    # stream joins), beside the single-device executor at the same R
    shard_ms = {}
    stack32 = engine.prepare_stack(shard_plan(1, "zero"), layers)
    for policy in ("zero", "halo"):
        for S in (1, 2, 4):
            plan_s = shard_plan(S, policy)
            fn = sharded_fn(plan_s, S, stack32)
            flat_fn = engine.build_stack_executor(plan_s, stack32)
            ms = device_ms(torch, lambda: fn(frames8), calls=5, rounds=3)
            flat_ms = device_ms(torch, lambda: flat_fn(frames8), calls=5, rounds=3)
            shard_ms[f"{policy}/S={S}"] = dict(band_rows=plan_s.band_rows, ms=ms,
                                               single_device_ms=flat_ms)
            print(f"sharded executor [fp32, {policy}, S={S} streams of one card, R="
                  f"{plan_s.band_rows}, 8 frames]: {ms:.4f} ms queued; single-device "
                  f"executor at the same R {flat_ms:.4f} ms ({smi})")
    mesh_fps = {}
    for label, kw in (("(2, 2) mesh", dict(mesh=mesh22)), ("unsharded", {})):
        srv = engine.SRServer.open("abpn_x3", backend="kernel", layers=layers, autotune="off",
                                   **kw)
        batch8h = frames8.cpu().numpy()
        srv.submit(batch8h).result()
        srv.submit(batch8h).result()  # warm every replica's bucket-8 executor
        t0 = time.perf_counter()
        for _ in range(20):
            srv.submit(batch8h).result()
        mesh_fps[label] = 20 * 8 / (time.perf_counter() - t0)
        srv.close()
    print(f"server fp32 zero, 20 closed-loop 8-frame requests of {H}x{W} host frames: (2, 2) "
          f"mesh on one card's streams {mesh_fps['(2, 2) mesh']:.2f} frames/s, unsharded "
          f"{mesh_fps['unsharded']:.2f} frames/s ({smi})")
    sharded_path = {"launches": sharded_launches, "executor_bit_exact_band_rows": shard_exact,
                    "k1_per_shard": shard_segments, "served": mesh_path,
                    "executor_ms": shard_ms, "server_fps": mesh_fps,
                    "halo_bytes_per_frame": {
                        f"S={S}": halo_exchange_bytes_per_frame(shard_plan(S, "halo"), S)
                        for S in (2, 4)},
                    "note": "mesh positions are streams of one card, not GPUs"}

    # ------------------------------------------------------------------
    phase("4f. LM serving: qwen2-0.5b at full width (prefill + KV-cache decode)")
    from repro_torch.configs import get_config as lm_config

    lm_cfg = lm_config(LM_ARCH)  # not reduced
    dims = (lm_cfg.num_layers, lm_cfg.d_model, lm_cfg.num_heads, lm_cfg.num_kv_heads,
            lm_cfg.head_dim, lm_cfg.d_ff, lm_cfg.vocab_size, lm_cfg.tie_embeddings,
            lm_cfg.qkv_bias, lm_cfg.param_dtype, lm_cfg.dtype)
    require(dims == (24, 896, 14, 2, 64, 4864, 151936, True, True, "float32", "bfloat16"),
            f"{LM_ARCH} is not at its published width: {dims}")
    t0 = time.perf_counter()
    lm_path = lm_serving(torch, dev, smi, detected.hbm_bytes_per_s, peaks, lm_cfg)
    print(f"lm_serving: {json.dumps(lm_path)}")
    print(f"phase 4f took {time.perf_counter() - t0:.1f} s")

    # ------------------------------------------------------------------
    phase("4g. training: qwen2-0.5b at full width, and ABPN")
    t0 = time.perf_counter()
    lm_train = lm_training(torch, dev, smi, detected.hbm_bytes_per_s, peaks, lm_cfg)
    print(f"lm_training: {json.dumps(lm_train)}")
    print(f"phase 4g took {time.perf_counter() - t0:.1f} s")

    # ------------------------------------------------------------------
    phase("4h. LM families at full width: deepseek-v2 (3 layers), arctic (1 layer), "
          "mamba2-130m, zamba2-2.7b")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    lm_fam = lm_families(torch, dev, smi, detected.hbm_bytes_per_s)
    print(f"lm_families: {json.dumps(lm_fam)}")
    print(f"phase 4h took {time.perf_counter() - t0:.1f} s")

    # ------------------------------------------------------------------
    phase("5. times (CUDA events, median of repeats after warm-up)")
    packed = ops.pack_stack(layers, dtype=torch.float32)
    packed16 = ops.pack_stack([l.to(dtype=torch.bfloat16) for l in layers], dtype=torch.bfloat16)
    chp, c0p = packed.chp, 8
    # K1's workspace per CTA in fp32 bytes
    kb_per_cta = 4 * ttf.kernel_buffers(channels=[3] + [l.co for l in layers], band_rows=60,
                                        tile_cols=C)["workspace_elements"]
    timings = {}
    for n in (1, 8):
        frames = torch.rand((n, H, W, 3), generator=gen).to(dev)
        xb = frames.reshape(n * H // 60, 60, W, 3)
        xs, first = ops.band_streams(xb, C, L)
        kw = dict(width=W, tile_cols=C, relu_flags=relu, in_channels=3, add_anchor=False)
        B, R, KC, _ = xs.shape
        plan = ttf.launch_plan(xs, packed.w, tile_cols=C)
        plan16 = ttf.launch_plan(xs.to(torch.bfloat16), packed16.w, tile_cols=C)
        executed_tiles = sum(k1 - kw_ for kw_, _, k1 in plan.ranges())  # per band
        xs16, first16 = xs.to(torch.bfloat16), first.to(torch.bfloat16)

        def k1_fp32():
            return kcall(xs, first, packed.w, packed.b, **kw)

        def k1_bf16():
            return kcall(xs16, first16, packed16.w, packed16.b, **kw)

        # K1 four ways: one launch between two events (host time of the
        # wrapper included; the kernels line's ms), launches queued behind a
        # device sleep (device time only), the wrapper's host time per call,
        # and the kernel's own duration in torch.profiler.
        k1 = dict(ms=time_ms(torch, k1_fp32, reps=10), device_ms=device_ms(torch, k1_fp32, calls=5),
                  host_ms=host_ms(torch, k1_fp32),
                  profiler_ms=profiler_kernel_ms(torch, k1_fp32, "tilted_fusion_kernel"),
                  bf16_ms=time_ms(torch, k1_bf16, reps=10),
                  bf16_device_ms=device_ms(torch, k1_bf16, calls=5),
                  bf16_host_ms=host_ms(torch, k1_bf16))
        # forced segment counts (device time): where the automatic plan
        # sits, how far time follows the plan's cost model, and whether the
        # workspace outgrowing L2 bends the curve
        sweep = {}
        for segs in sorted({1, 2, 4, 5, 8, 16, 21, 22, 41, 44, 81, plan.segments}):
            sp = ttf.launch_plan(xs, packed.w, tile_cols=C, segments=segs)
            sweep[segs] = dict(ms=device_ms(torch, lambda: kcall(
                xs, first, packed.w, packed.b, segments=segs, **kw), calls=5),
                ctas=sp.ctas, cost=sp.cost, workspace_mb=sp.ctas * kb_per_cta / 1e6)
        best = min(sweep, key=lambda k: sweep[k]["ms"])
        # the search over S = 1..K through segment_plan, uncached: what the
        # wrapper ran on the host at every launch before it cached the plan
        t0 = time.perf_counter()
        for _ in range(10):
            min(range(1, plan.tiles + 1), key=lambda s_: (ttf.segment_plan(
                B, plan.tiles, C, L, sms, k1_blocks["fp32/chp32"], segments=s_).cost, s_))
        k1["search_ms"] = (time.perf_counter() - t0) * 1e2
        print(f"batch {n}: K1 automatic plan S={plan.segments} (at most "
              f"{-(-plan.tiles // plan.segments)} own tiles per segment), {plan.ctas} CTAs on "
              f"{sms} SMs x {k1_blocks['fp32/chp32']}, w={plan.warmup} warm-up tiles, model "
              f"cost {plan.cost:g} lone-CTA tiles; warm-up "
              f"{100 * (1 - plan.tiles / executed_tiles):.1f}% of the {executed_tiles * B} "
              f"executed tiles; workspace {plan.ctas * kb_per_cta / 1e6:.1f} MB; bf16 plan "
              f"S={plan16.segments}")
        print(f"batch {n}: K1 forced S sweep (fp32, device time): " + "; ".join(
            f"S={k} {v['ctas']} CTAs cost {v['cost']:g} ws {v['workspace_mb']:.1f} MB -> "
            f"{v['ms']:.3f} ms ({v['ms'] / v['cost']:.3f} ms per cost tile)"
            for k, v in sweep.items()))
        print(f"batch {n}: sweep best S={best} {sweep[best]['ms']:.3f} ms; automatic S="
              f"{plan.segments} {sweep[plan.segments]['ms']:.3f} ms "
              f"({100 * (sweep[plan.segments]['ms'] / sweep[best]['ms'] - 1):.1f}% above the best)")
        plain_ms = time_ms(torch, lambda: ttf.tilted_fusion_plain(
            xs, first, packed.w, packed.b, **kw), reps=3)
        nchw = xb.permute(0, 3, 1, 2).contiguous()
        oihw = [(l.w.permute(3, 2, 0, 1).contiguous(), l.b) for l in layers]

        def cudnn_stack():
            f = nchw
            with exact_fp32():
                for (w_, b_), r in zip(oihw, relu):
                    f = torch.nn.functional.conv2d(f, w_, b_, padding=1)
                    f = torch.relu(f) if r else f
            return f

        # the yardstick timed both ways, as K1
        lib_ms = time_ms(torch, cudnn_stack, reps=10)
        lib_device_ms = device_ms(torch, cudnn_stack, calls=5)
        # The bound counts the function's own work: the unpadded stack over
        # the n*H*W pixels (2 FLOP per MAC), the frames read and the last
        # layer's features written once, and the weights read once.
        flops = 2 * n * H * W * sum(9 * l.ci * l.co for l in layers)
        nbytes = 4 * (n * H * W * (layers[0].ci + layers[-1].co)
                      + sum(l.w.numel() + l.b.numel() for l in layers))
        # What K1 executes: every tile column of every band, layer 0 over
        # c0p input channels and the rest over chp (padding included), and
        # layers 0..L-2 again on each warm-up tile
        tile_flops = 2 * R * C * 9 * (c0p * chp + (L - 1) * chp * chp)
        warm_flops = 2 * R * C * 9 * (c0p * chp + (L - 2) * chp * chp)
        executed = B * (plan.tiles * tile_flops + (executed_tiles - plan.tiles) * warm_flops)
        bound_ms, bound_by = bound(flops, nbytes, peak_flops, peak_bw)
        # the same work on the tensor cores, fp32 as 3xTF32 (three TF32
        # products per fp32 product): what a tensor-core K1 would be held to
        bound_tc_ms, _ = bound(3 * flops, nbytes, peaks["tf32"], peak_bw)
        timings[n] = dict(k1=k1, plain_ms=plain_ms, lib_ms=lib_ms, lib_device_ms=lib_device_ms,
                          bound_ms=bound_ms, bound_by=bound_by, bound_tc_ms=bound_tc_ms,
                          flops=flops, bytes=nbytes,
                          bands=B, segments=plan.segments, ctas=plan.ctas,
                          sweep_ms={k: v["ms"] for k, v in sweep.items()})
        prof = "not recorded" if k1["profiler_ms"] is None else f"{k1['profiler_ms']:.3f} ms"
        print(f"batch {n} ({B} bands of {R}x{W}, fp32, zero): K1 {k1['ms']:.3f} ms for one "
              f"launch between two events; {k1['device_ms']:.3f} ms device time queued "
              f"behind a sleep; wrapper host time {k1['host_ms']:.3f} ms per call; kernel in "
              f"torch.profiler {prof}; the plan search uncached {k1['search_ms']:.3f} ms on "
              f"the host (cached per shape). bf16 plan: {k1['bf16_ms']:.3f} ms one launch, "
              f"{k1['bf16_device_ms']:.3f} ms queued, host {k1['bf16_host_ms']:.3f} ms. "
              f"plain {plain_ms:.3f} ms, cuDNN conv stack (library_ms) {lib_ms:.3f} ms one "
              f"call, {lib_device_ms:.3f} ms queued; bound {bound_ms:.3f} ms ({bound_by}: "
              f"{flops / 1e9:.2f} GFLOP of ABPN, {nbytes / 1e6:.1f} MB moved; "
              f"{peak_flops / 1e12:.0f} TFLOP/s, {peak_bw / 1e12:.2f} TB/s) -> "
              f"{100 * bound_ms / k1['ms']:.1f}% of bound one launch, "
              f"{100 * bound_ms / k1['device_ms']:.1f}% queued; tensor-core bound (3xTF32) "
              f"{bound_tc_ms:.3f} ms; "
              f"K1 executes {executed / 1e9:.2f} GFLOP with padding and warm-up")

    # K2, the layer-by-layer baseline, on one 360x640 frame: per layer shape
    # and as the whole 7-launch stack.  Inputs are the real feature maps of
    # phase 3b.  A layer's bound is its own work (conv_cost), on the route
    # K2 takes: fp32 as 3xTF32 on the tensor cores (three TF32 products per
    # product, 4-byte maps), bf16 on the tensor cores (2-byte maps); beside
    # it the fp32 CUDA-core bound the CUDA-core K2 was held to.  The stack's
    # bound is the sum of its layers', since each layer is a function of
    # its own.
    def layer_bounds(ci, co):
        f32 = conv_cost(ci, co, H * W, 4)
        f16 = conv_cost(ci, co, H * W, 2)
        return dict(tc=bound(3 * f32[0], f32[1], peaks["tf32"], peak_bw),
                    bf16=bound(f16[0], f16[1], peaks["bf16"], peak_bw),
                    cuda_core=bound(f32[0], f32[1], peak_flops, peak_bw),
                    flops=f32[0], bytes=f32[1], bytes_bf16=f16[1])

    def cudnn_layer(x_nchw, w_oihw, b_, relu_):
        with exact_fp32():
            y = torch.nn.functional.conv2d(x_nchw, w_oihw, b_, padding=1)
        return torch.relu(y) if relu_ else y

    k2_shapes = {}
    for i, tag in ((0, "3->28"), (1, "28->28"), (6, "28->27")):
        l, x32 = layers[i], k2_inputs[i]
        x16, w16, b16 = x32.to(torch.bfloat16), l.w.to(torch.bfloat16), l.b.to(torch.bfloat16)
        nchw1 = x32.permute(2, 0, 1)[None].contiguous()
        oihw1 = l.w.permute(3, 2, 0, 1).contiguous()
        tiles, ctas = k2.launch_grid(x32)
        _, ctas16 = k2.launch_grid(x16)
        lb = layer_bounds(l.ci, l.co)
        row = dict(
            ms=device_ms(torch, lambda: k2call(x32, l.w, l.b, relu=l.relu)),
            bf16_ms=device_ms(torch, lambda: k2call(x16, w16, b16, relu=l.relu)),
            library_ms=device_ms(torch, lambda: cudnn_layer(nchw1, oihw1, l.b, l.relu)),
            library_bf16_ms=device_ms(torch, lambda: cudnn_layer(
                nchw1.to(torch.bfloat16), oihw1.to(torch.bfloat16), b16, l.relu)),
            plain_ms=time_ms(torch, lambda: k2.conv3x3_plain(x32, l.w, l.b, relu=l.relu), reps=3),
            bound_ms=lb["tc"][0], bound_by=lb["tc"][1],
            bf16_bound_ms=lb["bf16"][0], bf16_bound_by=lb["bf16"][1],
            bound_cuda_core_ms=lb["cuda_core"][0], bound_cuda_core_by=lb["cuda_core"][1],
            tiles=tiles, ctas=ctas, bf16_ctas=ctas16,
        )
        k2_shapes[tag] = row
        print(f"K2 {tag} (layer {i}, {H}x{W}): fp32 {row['ms']:.4f} ms/launch, bound "
              f"{row['bound_ms']:.4f} ms (3xTF32, {row['bound_by']}) -> "
              f"{100 * row['bound_ms'] / row['ms']:.1f}% of bound; bf16 {row['bf16_ms']:.4f} ms, "
              f"bound {row['bf16_bound_ms']:.4f} ms ({row['bf16_bound_by']}) -> "
              f"{100 * row['bf16_bound_ms'] / row['bf16_ms']:.1f}%; CUDA-core fp32 bound "
              f"{row['bound_cuda_core_ms']:.4f} ms ({row['bound_cuda_core_by']}; "
              f"{lb['flops'] / 1e9:.3f} GFLOP, {lb['bytes'] / 1e6:.2f} MB fp32, "
              f"{lb['bytes_bf16'] / 1e6:.2f} MB bf16); cuDNN conv2d"
              f"{' + ReLU' if l.relu else ''} (library_ms, TF32 off) {row['library_ms']:.4f} ms, "
              f"bf16 {row['library_bf16_ms']:.4f} ms; plain {row['plain_ms']:.3f} ms; "
              f"{tiles} tiles over {ctas} CTAs fp32 ({tiles / ctas:.2f} a CTA), {ctas16} bf16 "
              f"({tiles / ctas16:.2f})")

    frame32 = k2_inputs[0]
    frame16 = frame32.to(torch.bfloat16)
    layers16 = [l.to(dtype=torch.bfloat16) for l in layers]
    nchw_frame = frame32.permute(2, 0, 1)[None].contiguous()
    oihw = [(l.w.permute(3, 2, 0, 1).contiguous(), l.b, l.relu) for l in layers]
    oihw16 = [(w_.to(torch.bfloat16), b_.to(torch.bfloat16), r) for w_, b_, r in oihw]

    def k2_stack(f, stack):
        for l in stack:
            f = k2call(f, l.w, l.b, relu=l.relu)
        return f

    def k2_plain_stack():
        f = frame32
        for l in layers:
            f = k2.conv3x3_plain(f, l.w, l.b, relu=l.relu)
        return f

    def cudnn_frame(f, stack):
        for w_, b_, r in stack:
            f = cudnn_layer(f, w_, b_, r)
        return f

    bounds = [layer_bounds(l.ci, l.co) for l in layers]

    def summed(key):
        # the stack's bound, and the kind that accounts for most of it
        total = sum(b[key][0] for b in bounds)
        by = max(("operations", "bytes"),
                 key=lambda k: sum(b[key][0] for b in bounds if b[key][1] == k))
        return total, by

    stack = dict(
        ms=device_ms(torch, lambda: k2_stack(frame32, layers), calls=10),
        one_call_ms=time_ms(torch, lambda: k2_stack(frame32, layers), reps=10),
        bf16_ms=device_ms(torch, lambda: k2_stack(frame16, layers16), calls=10),
        bf16_one_call_ms=time_ms(torch, lambda: k2_stack(frame16, layers16), reps=10),
        library_ms=device_ms(torch, lambda: cudnn_frame(nchw_frame, oihw), calls=10),
        library_bf16_ms=device_ms(torch, lambda: cudnn_frame(
            nchw_frame.to(torch.bfloat16), oihw16), calls=10),
        plain_ms=time_ms(torch, k2_plain_stack, reps=3),
        bytes=sum(b["bytes"] for b in bounds),
    )
    (stack["bound_ms"], stack["bound_by"]) = summed("tc")
    (stack["bf16_bound_ms"], stack["bf16_bound_by"]) = summed("bf16")
    (stack["bound_cuda_core_ms"], stack["bound_cuda_core_by"]) = summed("cuda_core")
    # The same stack under torch.profiler: K2's own device time per launch,
    # to check that the CUDA-event times above hold no host time, and the
    # share of the stack's device span that a kernel was running.  One
    # frame more than the 5 measured warms the profiler, and only the last
    # 35 kernels are cut per layer; layer 0 is the only launch of the
    # instance with the taps folded into K, so the cut is checked by name.
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(6):
            k2_stack(frame32, layers)
        torch.cuda.synchronize()
    recorded = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                      if "conv3x3_kernel" in e.name)
    print(f"torch.profiler recorded {len(recorded)} K2 kernels over 6 frames (42 launched)")
    if len(recorded) >= 35:
        spans = recorded[-35:]
        require(len(spans) % 7 == 0, "the profiled K2 kernels must be whole frames")
        require(all((", true>" in n or "Lb1E" in n) == (i % 7 == 0)
                    for i, (_, _, n) in enumerate(spans)),
                "every 7th profiled K2 kernel, and only it, must be layer 0 (taps folded)")
        per_layer = [statistics.median(b - a for a, b, _ in spans[i::7]) / 1e3 for i in range(7)]
        stack["profiler_ms"] = sum(per_layer)
        stack["busy_share"] = sum(b - a for a, b, _ in spans) / (spans[-1][1] - spans[0][0])
        print(f"torch.profiler, the last 35 K2 kernels (5 frames): "
              f"{', '.join(f'{t:.4f}' for t in per_layer)} ms per layer, "
              f"{stack['profiler_ms']:.4f} ms per frame; the card ran a K2 kernel "
              f"{100 * stack['busy_share']:.1f}% of the span")
    else:
        print("torch.profiler recorded fewer than 35 K2 kernels; no per-layer split")
    k1_bytes = timings[1]["bytes"]
    print(f"K2 layer-by-layer stack, one {H}x{W} frame (7 launches): fp32 {stack['ms']:.4f} ms "
          f"queued, {stack['one_call_ms']:.4f} ms between two events; bf16 "
          f"{stack['bf16_ms']:.4f} / {stack['bf16_one_call_ms']:.4f} ms; bound fp32 "
          f"{stack['bound_ms']:.4f} ms (3xTF32, sum of the layers' bounds, mostly "
          f"{stack['bound_by']}) -> {100 * stack['bound_ms'] / stack['ms']:.1f}% of bound, bf16 "
          f"{stack['bf16_bound_ms']:.4f} ms (mostly {stack['bf16_bound_by']}) -> "
          f"{100 * stack['bf16_bound_ms'] / stack['bf16_ms']:.1f}%; CUDA-core fp32 bound "
          f"{stack['bound_cuda_core_ms']:.4f} ms; cuDNN stack (library_ms, TF32 off) "
          f"{stack['library_ms']:.4f} ms, bf16 {stack['library_bf16_ms']:.4f} ms; plain "
          f"{stack['plain_ms']:.3f} ms")
    print(f"bytes per {H}x{W} frame: layer by layer {stack['bytes'] / 1e6:.1f} MB, fused K1 "
          f"{k1_bytes / 1e6:.1f} MB ({100 * (1 - k1_bytes / stack['bytes']):.1f}% less); "
          f"device time per frame: layer by layer {stack['ms']:.4f} ms, K1 at 1 frame "
          f"{timings[1]['k1']['device_ms']:.3f} ms, K1 at 8 frames "
          f"{timings[8]['k1']['device_ms'] / 8:.3f} ms/frame")

    server = engine.SRServer.open("abpn_x3", backend="kernel", precision="fp32",
                                  layers=layers)
    batch8 = rng.uniform(size=(8, H, W, 3)).astype(np.float32)
    server.submit(batch8).result()  # warm the bucket-8 executor
    session = server.session()
    session.reset_stats()
    requests = 20
    t0 = time.perf_counter()
    for _ in range(requests):  # closed loop: one client, one request at a time
        server.submit(batch8).result()
    wall_s = time.perf_counter() - t0
    st = session.stats()
    worst_ms = max(session._complete_ms)
    server.close()
    server_fps = requests * batch8.shape[0] / wall_s
    print(f"server fp32 zero, {requests} closed-loop 8-frame requests of {H}x{W}: "
          f"{server_fps:.2f} frames/s over {wall_s:.3f} s of wall clock (upload, host "
          f"work and K1 included); launch-to-completion latency p50 {st['p50_ms']:.2f} ms, "
          f"max {worst_ms:.2f} ms (host numpy in, HR tensor on the card out)")

    # The temporal delta path, fp32 zero: a full re-upscale of one frame,
    # and delta frames with 0, 1 and 6 dirty bands, each split into its
    # phases (DeltaSession.last_ms: digest and dispatch on the host clock;
    # splice = the frame's wall clock to a device sync, less the two)
    from repro_torch.engine.temporal import DeltaSession

    server = engine.SRServer.open("abpn_x3", backend="kernel", precision="fp32", layers=layers)
    session = server.session()
    server.submit(f0).result()  # warm the bucket-1 executor

    def wall_ms(fn, reps=10):
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    full_frame_ms = wall_ms(lambda: server.submit(f0).result())
    delta_times = {}
    with DeltaSession(session, server=server) as ds:
        for label, pair_ in (("0 dirty bands", (f0, f0)), ("1 dirty band", (f0, f2)),
                             ("6 dirty bands", (f0, f4))):
            for frame in (*pair_, *pair_):  # warm: every bucket built, both frames cached
                ds.serve(frame)
            rows = []
            for i in range(12):
                frame = pair_[i % 2]
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                ds.serve(frame)
                torch.cuda.synchronize()
                total = (time.perf_counter() - t0) * 1e3
                rows.append((total, ds.last_ms["digest"], ds.last_ms["dispatch"]))
            med = {k: statistics.median(r[j] for r in rows)
                   for j, k in enumerate(("total_ms", "digest_ms", "dispatch_ms"))}
            med["splice_ms"] = statistics.median(r[0] - r[1] - r[2] for r in rows)
            delta_times[label] = med
            print(f"delta frame, {label} ({H}x{W}, fp32, zero): {med['total_ms']:.3f} ms to a "
                  f"device sync = digest {med['digest_ms']:.3f} + dispatch "
                  f"{med['dispatch_ms']:.3f} + splice {med['splice_ms']:.3f} ms; a full "
                  f"re-upscale of one frame {full_frame_ms:.3f} ms (submit to result)")
    server.close()

    # K1 over the band counts the delta path dispatches, queued device time,
    # beside its bound for the real bands' work (a padded slot is not work
    # the data needs)
    k1_bands = {}
    for label, real, slots in (("1 band", 1, 1), ("3 bands", 3, 3),
                               ("3 bands + 1 padded slot", 3, 4)):
        xb = torch.zeros((slots, 60, W, 3), device=dev)
        xb[:real] = torch.from_numpy(f0[:real * 60]).to(dev).reshape(real, 60, W, 3)
        xs, first = ops.band_streams(xb, C, L)
        kw = dict(width=W, tile_cols=C, relu_flags=relu, in_channels=3, add_anchor=False)
        plan_b = ttf.launch_plan(xs, packed.w, tile_cols=C)
        ms = device_ms(torch, lambda: kcall(xs, first, packed.w, packed.b, **kw), calls=10)
        flops = 2 * real * 60 * W * sum(9 * l.ci * l.co for l in layers)
        nbytes = 4 * (real * 60 * W * (layers[0].ci + layers[-1].co)
                      + sum(l.w.numel() + l.b.numel() for l in layers))
        bms, bby = bound(flops, nbytes, peak_flops, peak_bw)
        k1_bands[label] = dict(device_ms=ms, bound_ms=bms, bound_by=bby,
                               segments=plan_b.segments, ctas=plan_b.ctas)
        print(f"K1, {label} (B={slots}, fp32, zero): {ms:.4f} ms queued, S={plan_b.segments}, "
              f"{plan_b.ctas} CTAs; bound {bms:.4f} ms ({bby}) -> {100 * bms / ms:.1f}% of bound")

    # ------------------------------------------------------------------
    phase("6. kernels")
    t8 = timings[8]
    kernels = [{
        "name": "tilted_fusion",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/tilted_fusion.cu",
        "replaces": "src/repro/kernels/tilted_fusion.py:208",
        "launches": main_launches + delta_launches + autotune_launches + sharded_launches,
        "max_abs_err": worst["fp32"],
        "max_abs_err_bf16": worst["bf16"],
        "ms": t8["k1"]["ms"],
        "plain_ms": t8["plain_ms"],
        "bound_ms": t8["bound_ms"],
        "bound_by": t8["bound_by"],
        "bound_tensor_core_ms": t8["bound_tc_ms"],
        "library_ms": t8["lib_ms"],
        "shape": f"8 frames {H}x{W}: {t8['bands']} bands, fp32, zero",
        "timing": "ms, bf16_ms, library_ms: one call between two CUDA events, host time "
                  "included; *device_ms: calls queued behind a device sleep",
        "device_ms": t8["k1"]["device_ms"],
        "host_ms": t8["k1"]["host_ms"],
        "search_ms": t8["k1"]["search_ms"],
        "profiler_ms": t8["k1"]["profiler_ms"],
        "library_device_ms": t8["lib_device_ms"],
        "bf16_ms": t8["k1"]["bf16_ms"],
        "bf16_device_ms": t8["k1"]["bf16_device_ms"],
        "segments": t8["segments"],
        "ctas": t8["ctas"],
        "blocks_per_sm": k1_blocks["fp32/chp32"],
        "batch1": {"segments": timings[1]["segments"], "ctas": timings[1]["ctas"],
                   **timings[1]["k1"], "library_ms": timings[1]["lib_ms"],
                   "library_device_ms": timings[1]["lib_device_ms"],
                   "bound_ms": timings[1]["bound_ms"],
                   "bound_tensor_core_ms": timings[1]["bound_tc_ms"]},
        "segment_sweep_device_ms": {n: timings[n]["sweep_ms"] for n in (1, 8)},
        "bytes_per_frame": timings[1]["bytes"],
        "server_fps": server_fps,
        "main_path": per_config,
        "autotune_path": autotune_path,
        "delta_path": {"launches": delta_launches, "configs": delta_configs,
                       "k1_vs_plain": delta_k1, "hardening": hardening,
                       "full_frame_ms": full_frame_ms, "frame_ms": delta_times,
                       "k1_bands": k1_bands},
        "sharded_path": sharded_path,
    }, {
        "name": "conv3x3",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/conv3x3.cu",
        "replaces": "src/repro/kernels/conv3x3.py:28",
        "launches": layerwise_launches,
        "max_abs_err": k2_worst["fp32"],
        "max_abs_err_bf16": k2_worst["bf16"],
        "ms": stack["ms"],
        "plain_ms": stack["plain_ms"],
        "bound_ms": stack["bound_ms"],
        "bound_by": stack["bound_by"],
        "library_ms": stack["library_ms"],
        "shape": f"the 7-layer ABPN x3 stack over one {H}x{W} frame, 7 launches, fp32",
        "timing": "ms, bf16_ms, library*_ms: calls queued behind a device sleep; "
                  "*one_call_ms: one frame between two CUDA events, host time included",
        "bound_note": "bound_ms: fp32 as 3xTF32 on the tensor cores; bound_cuda_core_ms: "
                      "fp32 FMAs on the CUDA cores",
        "bound_cuda_core_ms": stack["bound_cuda_core_ms"],
        "one_call_ms": stack["one_call_ms"],
        "bf16_ms": stack["bf16_ms"],
        "bf16_one_call_ms": stack["bf16_one_call_ms"],
        "bf16_bound_ms": stack["bf16_bound_ms"],
        "library_bf16_ms": stack["library_bf16_ms"],
        "profiler_ms": stack.get("profiler_ms"),
        "occupancy": k2_occ,
        "bytes_per_frame": stack["bytes"],
        "per_layer_shape": k2_shapes,
        "main_path": per_layerwise,
    }]
    print("kernels: " + json.dumps({k["name"]: {"launches": k["launches"], "replaces": k["replaces"]}
                                    for k in kernels}))
    print(json.dumps({"kernels": kernels}))
    print(smi)  # the card, as nvidia-smi names it, and its power limit
    print(f"elapsed {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": card,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
