#!/usr/bin/env python3
"""K1's bf16 results on one CUDA card held against the exact value, for K1
as it is built (``shipped``: each tap's k-steps summed by the MMAs from
zero, the tap's partial added to the accumulator in fp32 registers) and for
``chained`` (one accumulator carried through all 9 x ks MMAs of a layer).

Run from the root of a checkout, on a machine with an NVIDIA card and nvcc:

    python3 tools/k1_bf16_rounding.py

The exact value of an output is the fp64 sum of its (exact) bf16 products
plus the bias, rounded once to bf16, to nearest even
(``tilted_fusion_plain`` with its per-tile conv done that way).

1. One layer, 28 -> 28 channels (c0p = Chp = 32, no ReLU), over 6 bands of
   60 x 640 whose pixels are |N(0, 1)| in bf16, weights N(0, 0.2^2): both
   sides read the same inputs, so each output is judged alone.  Printed:
   how many outputs each of ``shipped``, ``chained`` and the plain version
   (fp32 sums on the CPU) rounds away from the exact value, and the largest
   distance from it in bf16 ulps.
2. The stack of ``tests/test_torch_cuda.py::test_kernel_matches_plain``
   (3 -> 28 -> 28 -> 27, 61 rows, ``zero`` and ``replicate``, without the
   anchor, whose sum is rounded after the conv's on both sides).  For each
   output where a build and the plain version differ by more than the
   test's 5e-2: both values, the fp64 value of the last layer from the plain
   version's own inputs and its exact rounding, and the value of the exact
   chain (every layer rounded exactly).

Then the bf16 time of each build on ABPN x3 over 1 and 8 frames of 360x640
(``zero``, automatic segments), queued behind a device sleep.

Exits 2 without a CUDA device.
"""

import contextlib
import sys

import numpy as np

from _ablation import K1_ENTRY, K1_SRC, ROOT, build, device_ms, edits, k1_label, nvidia_smi, \
    use_k1_library

OUT = f"{ROOT}/build/k1_bf16_rounding"
VARIANTS = {
    "shipped": edits(),
    "chained": edits(("kstep(dy, dx, s, part);", "kstep(dy, dx, s, acc);"),
                     ("acc[f][jb][c] += part[f][jb][c];", "(void)part[f][jb][c];")),
}


def round_bf16(x):
    """fp64 ``x`` rounded once to the nearest bf16 (ties to even), as fp64."""
    import torch

    y = x.to(torch.float32).to(torch.bfloat16)  # at most one bf16 ulp off
    bits = y.view(torch.int16).to(torch.int32)
    cand_bits = torch.stack([bits, bits - 1, bits + 1])
    cand = cand_bits.clamp(-32768, 32767).to(torch.int16).view(torch.bfloat16).double()
    dist = (cand - x).abs()
    dist = torch.where(torch.isnan(dist), torch.full_like(dist, float("inf")), dist)
    best = dist == dist.min(0, keepdim=True).values
    pick = (2 * best.int() + (best & (cand_bits % 2 == 0)).int()).argmax(0, keepdim=True)
    return cand.gather(0, pick)[0]


@contextlib.contextmanager
def exact_conv(layers, raw=None):
    """``tilted_fusion_plain`` with the conv of the layers in ``layers``
    summed in fp64 and rounded once to bf16; ``raw`` collects the last
    such layer's unrounded values, tile by tile."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import tilted_fusion as ttf

    fp32_conv = ttf._conv_tile_plain

    def conv(f, w_l, b_l, row_policy):
        layer = w_l.storage_offset() // w_l.numel()
        if layer not in layers:
            return fp32_conv(f, w_l, b_l, row_policy)
        R, C = f.shape[1], f.shape[2] - 2
        frow = (torch.cat([f[:, :1], f, f[:, -1:]], dim=1) if row_policy == "replicate"
                else F.pad(f, (0, 0, 0, 0, 1, 1))).double()
        acc = sum(torch.matmul(frow[:, dy:dy + R, dx:dx + C], w_l[dy, dx].double())
                  for dy in range(3) for dx in range(3)) + b_l.double()
        if raw is not None and layer == max(layers):
            raw.append(acc)
        return round_bf16(acc)

    ttf._conv_tile_plain = conv
    try:
        yield
    finally:
        ttf._conv_tile_plain = fp32_conv


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("k1_bf16_rounding: no CUDA device is available; nothing was run", file=sys.stderr)
        return 2
    from repro_torch.kernels import ops
    from repro_torch.kernels import tilted_fusion as ttf
    from repro_torch.models.abpn import init_abpn, layers_from_numpy

    smi = nvidia_smi()
    print(f"nvidia-smi: {smi}")
    libs = build(K1_SRC, OUT, VARIANTS, K1_ENTRY, k1_label)
    dev = torch.device("cuda")
    bf = torch.bfloat16

    def stack(rng, channels):
        return layers_from_numpy([
            ((rng.normal(size=(3, 3, channels[i], channels[i + 1])) * 0.2).astype(np.float32),
             (rng.normal(size=(channels[i + 1],)) * 0.1).astype(np.float32),
             i < len(channels) - 2)
            for i in range(len(channels) - 1)])

    def run(lib, args, kw):
        use_k1_library(lib)
        got = ttf.tilted_fusion_call(*(a.to(dev) for a in args), **kw)
        return got.cpu().double()

    def ulps(a, b):  # distance in bf16 ulps of b (b a bf16 value)
        e = torch.frexp(b.abs().clamp_min(2.0 ** -126))[1].double()
        return ((a - b).abs() / torch.exp2(e - 8)).max().item()

    # 1. one layer, the same inputs on every side
    rng = np.random.default_rng(0)
    packed = ops.pack_stack([l.to(dtype=bf) for l in stack(rng, [28, 28])], dtype=bf)
    xb = torch.from_numpy(np.abs(rng.normal(size=(6, 60, 640, 28))).astype(np.float32)).to(bf)
    xs, first = ops.band_streams(xb, 8, 1)
    kw = dict(width=640, tile_cols=8, relu_flags=[False], add_anchor=False, in_channels=28)
    args = (xs, first, packed.w, packed.b)
    with exact_conv({0}):
        exact = ttf.tilted_fusion_plain(*args, **kw).double()
    sides = {"plain": ttf.tilted_fusion_plain(*args, **kw).double()}
    sides.update({name: run(lib, args, kw) for name, lib in libs.items()})
    print(f"one layer 28->28, {exact.numel()} outputs: rounded away from the exact value")
    for name, got in sides.items():
        print(f"  {name}: {int((got != exact).sum())} outputs, at most "
              f"{ulps(got, exact):.0f} bf16 ulp", flush=True)

    # 2. the card test's stack
    packed = ops.pack_stack([l.to(dtype=bf) for l in stack(np.random.default_rng(1),
                                                              [3, 28, 28, 27])], dtype=bf)
    gen = torch.Generator().manual_seed(2)
    xb = torch.rand((3, 61, 37, 3), generator=gen).to(bf)
    xs, first = ops.band_streams(xb, 4, 3)
    args = (xs, first, packed.w, packed.b)
    for policy in ("zero", "replicate"):
        kw = dict(width=37, tile_cols=4, relu_flags=list(packed.relu), add_anchor=False,
                  in_channels=3, row_policy=policy)
        want = ttf.tilted_fusion_plain(*args, **kw).double()
        raw = []
        with exact_conv({2}, raw):
            last_exact = ttf.tilted_fusion_plain(*args, **kw).double()
        raw = torch.stack(raw, dim=2)  # (B, R, K, C, Chp): tile k's C columns
        raw = raw.reshape(raw.shape[0], raw.shape[1], -1, raw.shape[-1])
        with exact_conv({0, 1, 2}):
            chain = ttf.tilted_fusion_plain(*args, **kw).double()
        print(f"test stack, 61 rows, {policy}: plain rounded away from the exact last layer "
              f"at {int((want != last_exact).sum())} of {want.numel()} outputs; away from the "
              f"exact chain at {int((want != chain).sum())}")
        for name, lib in libs.items():
            got = run(lib, args, kw)
            far = ((got - want).abs() > 5e-2).nonzero().tolist()
            print(f"  {name}: {int((got != chain).sum())} away from the exact chain, "
                  f"{len(far)} beyond 5e-2 of plain", flush=True)
            for i in far:
                i = tuple(i)
                print(f"    {list(i)}: {name} {got[i].item()}, plain {want[i].item()}, "
                      f"plain's inputs in fp64 {raw[i].item()!r} -> {last_exact[i].item()}, "
                      f"exact chain {chain[i].item()}")

    # 3. time, ABPN x3 bf16
    layers = init_abpn(torch.Generator().manual_seed(0), device=dev)
    packed = ops.pack_stack([l.to(dtype=bf) for l in layers], dtype=bf)
    gen = torch.Generator().manual_seed(1)
    for n in (1, 8):
        xb = torch.rand((6 * n, 60, 640, 3), generator=gen).to(dev, bf)
        xs, first = ops.band_streams(xb, 8, 7)
        kw = dict(width=640, tile_cols=8, relu_flags=list(packed.relu), add_anchor=False,
                  in_channels=3)
        cells = []
        for name, lib in libs.items():
            use_k1_library(lib)
            ms = device_ms(lambda: ttf.tilted_fusion_call(xs, first, packed.w, packed.b, **kw))
            cells.append(f"{name} {ms:.3f} ms")
        print(f"bf16 {n} frame{'s' if n > 1 else ''}: " + "; ".join(cells), flush=True)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
