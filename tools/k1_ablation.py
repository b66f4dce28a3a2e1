#!/usr/bin/env python3
"""Time K1 (``src/repro_torch/kernels/csrc/tilted_fusion.cu``) with parts of
it switched off, or with another schedule, on one CUDA card.

Run from the root of a checkout, on a machine with an NVIDIA card and nvcc:

    python3 tools/k1_ablation.py [variant ...]
    python3 tools/k1_ablation.py --wide [variant ...]

Each variant is the kernel's source with one edit.  A part is switched off
by making it run only under a condition that never holds at run time
(``repeats == 77``; the launches here take 9), so the compiler keeps
everything else.  All variants compile at once with nvcc into
``build/k1_ablation/`` and are launched through the package's own wrapper
(``tilted_fusion_call``, its library swapped for the variant's) with the
automatic segment plan, timed as the device time of launches queued behind
a device sleep, fp32 and bf16, under ``zero``.

Without ``--wide``: the narrow Chp 32 instance on ABPN x3 at full width
over 1 and 8 frames of 360x640.  With ``--wide``: the wide instances on
ABPN x3 at 64 and 128 feature channels (``ABPNConfig(feature_channels=F)``,
seeded He weights) over 1 and 8 frames, and at 48 and 96 over one frame.
Wide variants switch a part off, change the instances' schedule
(``wide_sched``: n-group, taps or half a tap a slice, CTAs an SM), or add
one (``two_windows``: row block b + 1's window copied while block b
computes); a variant that only reorders the work must give ``full``'s bits
(``torch.equal``), since none of them changes the order of any element's
sum.

``full`` is held against ``tilted_fusion_plain`` (5e-4 fp32, 5e-2 bf16) at
one frame.  The gap between ``full`` and a switched-off variant is what that
part costs when nothing else changes; parts overlap, so the gaps need not
add up.

Exits 2 without a CUDA device.
"""

import re
import sys

from _ablation import K1_ENTRY, K1_SRC, ROOT, build, device_ms, edits, k1_label, nvidia_smi, \
    use_k1_library
from _stacks import he_arrays

OUT = f"{ROOT}/build/k1_ablation"
NEVER = "p.repeats == 77"  # a condition no launch here meets


WIDE_MARK = "// The wide instances (Chp > 32)"


def narrow_only(transform):
    """``transform`` applied to the source above the wide instances, whose
    code repeats some of the narrow kernel's lines."""
    def apply(src):
        i = src.index(WIDE_MARK)
        return transform(src[:i]) + src[i:]
    return apply


MMA_TF32 = "          mma_tf32(d[f][jb], "
VARIANTS = {
    "full": edits(),
    "empty": edits(("  extern __shared__ uint4 smem[];\n  char* stages",
                    f"  extern __shared__ uint4 smem[];\n  if (!({NEVER})) return;\n"
                    f"  char* stages")),
    # only hi*hi of 3xTF32 (bf16: unchanged)
    "one_term": edits((MMA_TF32 + "al[f]", f"          if ({NEVER}) mma_tf32(d[f][jb], al[f]"),
                      (MMA_TF32 + "ah[f], bw[LO",
                       f"          if ({NEVER}) mma_tf32(d[f][jb], ah[f], bw[LO")),
    "no_mma": edits((MMA_TF32, f"          if ({NEVER}) mma_tf32(d[f][jb], "),
                    ("          mma_bf16(d[f][jb], ",
                     f"          if ({NEVER}) mma_bf16(d[f][jb], ")),
    "no_split": edits(("tf32_split(a[f][c], ah[f][c], al[f][c]);",
                       f"if ({NEVER}) tf32_split(a[f][c], ah[f][c], al[f][c]); "
                       f"else ah[f][c] = al[f][c] = a[f][c];")),
    "no_window": edits(("  // layer 0 copies the chunks of its padded k",
                        f"  if (!({NEVER})) return;\n  // layer 0 copies the chunks of its padded k")),
    # A fragments not loaded (the MMAs run on whatever the registers hold)
    "no_ldmatrix": edits(("    uint32_t a[NF][4];\n", "    uint32_t a[NF][4] = {};\n"),
                         ("      ldmatrix_x4(a[f], win_addr",
                          f"      if ({NEVER}) ldmatrix_x4(a[f], win_addr")),
    # the row loop's two barriers a block gone (the result is not checked)
    "no_barrier": edits(("        __syncthreads();\n", f"        if ({NEVER}) __syncthreads();\n")),
    "no_stage": edits(("          if (has_next)  // the next step's weights",
                       f"          if (has_next && {NEVER})  // the next step's weights")),
    "no_store": edits(("      if (px >= st.npix) continue;",
                       f"      if (px >= st.npix || !({NEVER})) continue;")),
}
VARIANTS = {name: narrow_only(t) for name, t in VARIANTS.items()}


def schedule(**entries):
    """A wide schedule variant: ``f32_64=(ng, taps, halves, ctas)`` (or
    ``bf16_64=...``) replaces that instance's line of ``wide_sched``."""
    pairs = []
    for key, fields in entries.items():
        f32 = key.startswith("f32")
        chp = int(key.split("_")[1])
        head = f"  if ({'' if f32 else '!'}f32 && chp == {chp}) return "
        line = re.compile(re.escape(head) + r"\{\d+, \d+, \d+, \d+\};")
        text = head + "{" + ", ".join(str(v) for v in fields) + "};"
        pairs.append((lambda src, _new, line=line, text=text: line.subn(text, src), None))
    return edits(*pairs)


# Two windows a wide CTA, where two fit beside its slices (kTwoWins): block
# b computes from window b & 1 while block b + 1's is copied; a step's
# block 0 reads what the step before it wrote, so it waits for its own.
# The block's barrier frees the window block b + 1 goes to (block b - 1's).
TWO_WINDOWS = edits(
    ("  static constexpr int kWinBytes = kWinPix * kPixBytes;\n",
     "  static constexpr int kWinBytes = kWinPix * kPixBytes;\n"
     "  static constexpr bool kTwoWins =\n"
     "      kWide && kSched.ctas * (2 * kSliceBytes + 2 * kWinBytes + 1024) <= 233472;\n"),
    ("      kWide ? 2 * kSliceBytes + kWinBytes : 2 * kStageBytes + 2 * kWinBytes;",
     "      kWide ? 2 * kSliceBytes + (kTwoWins ? 2 : 1) * kWinBytes\n"
     "            : 2 * kStageBytes + 2 * kWinBytes;"),
    ("  char* win = slices + 2 * G::kSliceBytes;       // kWinBytes\n"
     "  const uint32_t win_addr = smem_addr(win);\n",
     "  char* wins = slices + 2 * G::kSliceBytes;      // 1 or 2 x kWinBytes\n"),
    ("        // the window is free and the last epilogue's stores are visible\n"
     "        __syncthreads();\n"
     "        load_window_wide<T, CHP>(p, src, l == 0, k, st.r0, rows, sc, win);\n"
     "        cp_async_commit();\n",
     "        char* win = wins + (G::kTwoWins ? (b & 1) * G::kWinBytes : 0);\n"
     "        __syncthreads();\n"
     "        if (!G::kTwoWins || b == 0) {\n"
     "          load_window_wide<T, CHP>(p, src, l == 0, k, st.r0, rows, sc, win);\n"
     "          cp_async_commit();\n"
     "        }\n"
     "        const bool ahead = G::kTwoWins && b + 1 < nblk;\n"
     "        if (ahead) {\n"
     "          const int r1 = st.r0 + p.rows_blk;\n"
     "          load_window_wide<T, CHP>(p, src, l == 0, k, r1, min(p.rows_blk, R - r1), sc,\n"
     "                                   wins + ((b + 1) & 1) * G::kWinBytes);\n"
     "          cp_async_commit();\n"
     "        }\n"
     "        const uint32_t win_addr = smem_addr(win);\n"),
    # at a block's first slice, block b + 1's window, committed after
    # slice n, may still be in flight
    ("            cp_async_wait<1>();  // slice n (and the block's window) landed\n",
     "            if (ahead && grp == 0 && j == 0) cp_async_wait<2>(); else cp_async_wait<1>();\n"))


# the wide kernel's parts (wide_tap has no launch argument to test, so its
# never-condition is on the window's shared-memory address, which no
# compiler can know)
WIDE_MMA = "          mma_tf32(part[f][jb], "
SLICE_N16 = "  const int n16 = (G::kHalves == 1 ? G::kTaps * ks : n) * G::kQuads * 32;\n"
WIDE_VARIANTS = {
    "full": edits(),
    "empty": edits(("  char* win = slices + 2 * G::kSliceBytes;       // kWinBytes\n",
                    "  char* win = slices + 2 * G::kSliceBytes;       // kWinBytes\n"
                    f"  if (!({NEVER})) return;\n")),
    "no_mma": edits((WIDE_MMA, "          if (win_addr == 77u) mma_tf32(part[f][jb], "),
                    ("          mma_bf16(part[f][jb], ",
                     "          if (win_addr == 77u) mma_bf16(part[f][jb], ")),
    # point 5: the weight slices' copies (every slice computes from
    # whatever its stage holds)
    "no_slices": edits((SLICE_N16, SLICE_N16 + f"  if (!({NEVER})) return;\n")),
    "no_window": edits(("  const int chunks = layer0 ? 2 * p.ks0 : G::kChunks;\n",
                        "  const int chunks = layer0 ? 2 * p.ks0 : G::kChunks;\n"
                        f"  if (!({NEVER})) return;\n")),
    # point 2: two windows (TWO_WINDOWS) where they fit: fp32 Chp 48 (with
    # one-tap slices, which leave room for them) and 64, bf16 at every
    # width (Chp 128 with one-tap slices); fp32 Chp 96 and 128 unchanged
    "two_windows": lambda src: TWO_WINDOWS(
        schedule(f32_48=(48, 1, 1, 1), bf16_128=(64, 1, 1, 1))(src)),
    # point 3: one tap a slice, two barriers a tap
    "one_tap": schedule(f32_48=(48, 1, 1, 1), bf16_48=(48, 1, 1, 2),
                        bf16_64=(32, 1, 1, 2), bf16_96=(48, 1, 1, 1),
                        bf16_128=(64, 1, 1, 1)),
    # point 4: n-groups of 24 / 32 / 16 as before (A loaded and split once a
    # group); fp32 Chp 128 with whole-tap slices
    "small_groups": schedule(f32_48=(24, 3, 1, 1), f32_64=(32, 1, 1, 1),
                             f32_96=(32, 1, 1, 1), f32_128=(32, 1, 1, 1),
                             bf16_48=(16, 3, 1, 2), bf16_96=(32, 3, 1, 1),
                             bf16_128=(32, 3, 1, 1)),
    # point 1: two fp32 CTAs an SM at Chp 48 and 64 (one-tap slices and
    # n-groups of 24 / 32 fit half the SM; 128 registers)
    "fp32_two_ctas": schedule(f32_48=(24, 1, 1, 2), f32_64=(32, 1, 1, 2)),
    # bf16 at 2 CTAs an SM on every width (Chp 128: one-tap slices)
    "bf16_two_ctas": schedule(bf16_96=(32, 3, 1, 2), bf16_128=(32, 1, 1, 2)),
    # bf16 with 64 outputs a warp at Chp 64 (one CTA an SM); fewer at 96, 128
    "bf16_groups": schedule(bf16_64=(64, 3, 1, 1), bf16_96=(32, 3, 1, 1),
                            bf16_128=(32, 3, 1, 1)),
    # fp32 Chp 96 in two n-groups of 48, one-tap slices
    "fp32_96_ng48": schedule(f32_96=(48, 1, 1, 1)),
    # the previous design's schedule: n-groups of <= 32, one-tap slices,
    # one window; bf16 at 2 CTAs an SM
    "old_schedule": schedule(f32_48=(24, 1, 1, 1), f32_64=(32, 1, 1, 1),
                             f32_96=(32, 1, 1, 1), f32_128=(32, 1, 1, 1),
                             bf16_48=(16, 1, 1, 2), bf16_64=(32, 1, 1, 2),
                             bf16_96=(32, 1, 1, 2), bf16_128=(32, 1, 1, 2)),
}
SCHEDULES = {"two_windows", "one_tap", "small_groups", "fp32_two_ctas", "bf16_two_ctas",
             "bf16_groups", "fp32_96_ng48", "old_schedule"}
WIDE_ENTRY = r"tilted_fusion_wide_kernelI(f|13__nv_bfloat16)Li(\d+)E"
WIDE_F = {48: (1,), 64: (1, 8), 96: (1,), 128: (1, 8)}  # feature widths -> frame counts


def narrow(torch, ops, ttf, libs, dev):
    from repro_torch.models.abpn import init_abpn

    layers = init_abpn(torch.Generator().manual_seed(0), device=dev)
    gen = torch.Generator().manual_seed(1)
    for n in (1, 8):
        frames = torch.rand((n, 360, 640, 3), generator=gen).to(dev)
        for dt, tag, tol in ((torch.float32, "fp32", 5e-4), (torch.bfloat16, "bf16", 5e-2)):
            packed = ops.pack_stack([l.to(dtype=dt) for l in layers], dtype=dt)
            xs, first = ops.band_streams(frames.reshape(6 * n, 60, 640, 3).to(dt), 8, 7)
            kw = dict(width=640, tile_cols=8, relu_flags=list(packed.relu), add_anchor=False,
                      in_channels=3, anchor_repeats=9)
            want = ttf.tilted_fusion_plain(xs, first, packed.w, packed.b, **kw).float()
            cells = []
            for name, path in libs.items():
                use_k1_library(path)
                call = lambda: ttf.tilted_fusion_call(xs, first, packed.w, packed.b, **kw)
                got = call()
                torch.cuda.synchronize()
                if name == "full":
                    err = (got.float() - want).abs().max().item()
                    if not err <= tol:
                        raise RuntimeError(f"full {tag} at {n}: max abs err {err:.3e} > {tol}")
                plan = ttf.launch_plan(xs, packed.w, tile_cols=8)
                cells.append(f"{name} {device_ms(call):.3f} ms (S={plan.segments})")
            print(f"{tag} {n} frame{'s' if n > 1 else ''}: " + "; ".join(cells), flush=True)


def wide(torch, np, ops, ttf, libs, dev):
    from repro_torch.models.abpn import ABPNConfig, layers_from_numpy

    gen = torch.Generator().manual_seed(1)
    for f, counts in WIDE_F.items():
        ch = ABPNConfig(feature_channels=f).channels
        layers = layers_from_numpy(he_arrays(np, ch, 60 + f), device=dev)
        for n in counts:
            frames = torch.rand((n, 360, 640, 3), generator=gen).to(dev)
            for dt, tag, tol in ((torch.float32, "fp32", 5e-4), (torch.bfloat16, "bf16", 5e-2)):
                packed = ops.pack_stack([l.to(dtype=dt) for l in layers], dtype=dt)
                xs, first = ops.band_streams(frames.reshape(6 * n, 60, 640, 3).to(dt), 8, 7)
                kw = dict(width=640, tile_cols=8, relu_flags=list(packed.relu), add_anchor=False,
                          in_channels=3)
                cells, ref = [], None
                for name, path in libs.items():
                    use_k1_library(path)
                    call = lambda: ttf.tilted_fusion_call(xs, first, packed.w, packed.b, **kw)
                    got = call()
                    torch.cuda.synchronize()
                    if name == "full":
                        ref = got
                        if n == 1:
                            want = ttf.tilted_fusion_plain(xs, first, packed.w, packed.b, **kw)
                            err = (got.float() - want.float()).abs().max().item()
                            if not err <= tol:
                                raise RuntimeError(f"full {tag} F={f} at {n}: max abs err "
                                                   f"{err:.3e} > {tol}")
                    elif name in SCHEDULES and ref is not None and not torch.equal(got, ref):
                        raise RuntimeError(f"schedule {name} changed the bits ({tag} F={f})")
                    plan = ttf.launch_plan(xs, packed.w, tile_cols=8)
                    cells.append(f"{name} {device_ms(call):.3f} ms (S={plan.segments})")
                print(f"F={f} {tag} {n} frame{'s' if n > 1 else ''}: " + "; ".join(cells),
                      flush=True)


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("k1_ablation: no CUDA device is available; nothing was run", file=sys.stderr)
        return 2
    from repro_torch.kernels import ops
    from repro_torch.kernels import tilted_fusion as ttf

    smi = nvidia_smi()
    print(f"nvidia-smi: {smi}")
    args = sys.argv[1:]
    is_wide = "--wide" in args
    args = [a for a in args if a != "--wide"]
    table = WIDE_VARIANTS if is_wide else VARIANTS
    names = args or list(table)
    if "full" not in names:
        names = ["full"] + names
    libs = build(K1_SRC, OUT + ("_wide" if is_wide else ""), {n: table[n] for n in names},
                 WIDE_ENTRY if is_wide else K1_ENTRY, k1_label)
    dev = torch.device("cuda")
    if is_wide:
        wide(torch, np, ops, ttf, libs, dev)
    else:
        narrow(torch, ops, ttf, libs, dev)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
