#!/usr/bin/env python3
"""Whether ``wgmma`` gives ``mma.sync``'s bits on K1's operands, on one CUDA
card: the question that decides whether K1's narrow instance may move to
``wgmma`` while its card tests hold it bit for bit to the wide instances,
which stay on ``mma.sync``.

Run from the root of a checkout, on a machine with an NVIDIA card and nvcc:

    python3 tools/k1_wgmma_probe.py [--trials 8]

``tools/k1_wgmma_probe.cu`` (built with the package's nvcc flags into
``build/k1_wgmma_probe/``) computes a 64 x 32 fp32 result twice from the
same A (64 x k) and B (k x 32), as a chain of S k-steps from zero: with
``mma.sync`` m16n8k8 TF32 / m16n8k16 bf16, as K1 runs them, and with
``wgmma`` m64n32k8 TF32 / m64n32k16 bf16 (A from registers, B from shared
memory).  fp32 is 3xTF32 on both sides (A and B split into TF32 hi and lo,
each k-step summed lo*hi + hi*lo + hi*hi), so every element sums the same
products in the same order.  For S = 1, 2, 4 (one tap at Chp 32: 4 fp32 or
2 bf16 k-steps) and 36 (a layer's 9 taps at fp32 Chp 32), over ``--trials``
seeded draws of unit normal operands and of operands spread over six
decades, it prints how many of the 2,048 elements differ in their bits and
the largest difference, with each side's largest error against the fp64
sum of the same (split) products.

Prints the card's name and power limit and one JSON line; exits 2 without a
CUDA device, 1 if the probe fails to build or launch.
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys

from _ablation import ROOT, nvidia_smi

SRC = os.path.join(ROOT, "tools", "k1_wgmma_probe.cu")
OUT = os.path.join(ROOT, "build", "k1_wgmma_probe")


def build():
    import repro_torch.kernels._build as b

    os.makedirs(OUT, exist_ok=True)
    lib = os.path.join(OUT, "libk1_wgmma_probe.so")
    proc = subprocess.run([b.nvcc_path(), *b.NVCC_FLAGS, "-o", lib, SRC], capture_output=True,
                          text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed:\n{proc.stdout[-3000:]}{proc.stderr[-3000:]}")
    so = ctypes.CDLL(lib)
    so.k1_wgmma_probe.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2
    so.k1_wgmma_probe.restype = ctypes.c_int
    return so


def tf32(np, a):
    """cvt.rna.tf32.f32 of float32 ``a`` (ties away from zero)."""
    bits = a.astype(np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def exact(np, a, b, bf16):
    """The fp64 sum of the products each side sums: bf16 as they are,
    fp32 as lo*hi + hi*lo + hi*hi of the TF32 splits."""
    if bf16:
        return a.astype(np.float64) @ b.astype(np.float64)
    ah, bh = tf32(np, a), tf32(np, b)
    al, bl = tf32(np, a - ah), tf32(np, b - bh)
    d = lambda x: x.astype(np.float64)
    return d(al) @ d(bh) + d(ah) @ d(bl) + d(ah) @ d(bh)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trials", type=int, default=8)
    args = ap.parse_args(argv)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("k1_wgmma_probe: no CUDA device is available; nothing was run", file=sys.stderr)
        return 2
    smi = nvidia_smi()
    print(f"nvidia-smi: {smi}")
    try:
        so = build()
    except RuntimeError as exc:
        print(exc, file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    result = {"card": smi}
    for tag, bf16 in (("fp32", 0), ("bf16", 1)):
        kk = 16 if bf16 else 8
        for S in (1, 2, 4, 36):
            for spread in ("unit", "wide"):
                diff = worst = 0
                err_m = err_w = 0.0
                for trial in range(args.trials):
                    rng = np.random.default_rng(1000 * S + 10 * trial + bf16)
                    a = rng.normal(size=(64, S * kk)).astype(np.float32)
                    b = (rng.normal(size=(S * kk, 32)) * 0.2).astype(np.float32)
                    if spread == "wide":
                        a *= (10.0 ** rng.uniform(-3, 3, size=a.shape)).astype(np.float32)
                        b *= (10.0 ** rng.uniform(-3, 3, size=b.shape)).astype(np.float32)
                    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
                    if bf16:  # words of bf16 pairs along k
                        ta, tb = ta.bfloat16(), tb.bfloat16()
                        a, b = ta.float().numpy(), tb.float().numpy()
                        wa = ta.contiguous().view(torch.int32)
                        wb = tb.t().contiguous().view(torch.int32).t().contiguous()
                    else:
                        wa, wb = ta.view(torch.int32), tb.view(torch.int32)
                    wa, wb = wa.to(dev), wb.to(dev)
                    dw = torch.empty((64, 32), device=dev)
                    dm = torch.empty((64, 32), device=dev)
                    code = so.k1_wgmma_probe(wa.data_ptr(), wb.data_ptr(), dw.data_ptr(),
                                             dm.data_ptr(), S, bf16)
                    if code:
                        print(f"k1_wgmma_probe: launch failed, CUDA error {code}",
                              file=sys.stderr)
                        return 1
                    w, m = dw.cpu().numpy(), dm.cpu().numpy()
                    diff += int((w.view(np.uint32) != m.view(np.uint32)).sum())
                    worst = max(worst, float(np.abs(w.astype(np.float64) - m).max()))
                    ref = exact(np, a, b, bf16)
                    scale = np.abs(ref).max()
                    err_m = max(err_m, float(np.abs(m - ref).max() / scale))
                    err_w = max(err_w, float(np.abs(w - ref).max() / scale))
                n = 2048 * args.trials
                result[f"{tag}/S{S}/{spread}"] = dict(differ=diff, of=n, max_abs_diff=worst,
                                                      mma_sync_rel_err=err_m,
                                                      wgmma_rel_err=err_w)
                print(f"{tag} S={S} {spread}: {diff} of {n} elements differ in their bits "
                      f"(largest difference {worst:.3g}); largest error / largest |sum|: "
                      f"mma.sync {err_m:.3g}, wgmma {err_w:.3g}", flush=True)
    same = all(v["differ"] == 0 for k, v in result.items() if k != "card")
    print(f"wgmma gives mma.sync's bits on every element: {same}")
    result["same_bits"] = same
    print(json.dumps(result))
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
