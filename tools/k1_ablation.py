#!/usr/bin/env python3
"""Time K1 (``src/repro_torch/kernels/csrc/tilted_fusion.cu``) with parts of
it switched off, on one CUDA card.

Run from the root of a checkout, on a machine with an NVIDIA card and nvcc:

    python3 tools/k1_ablation.py [variant ...]

Each variant is the kernel's source with one edit.  A part is switched off
by making it run only under a condition that never holds at run time
(``repeats == 77``; the launches here take 9), so the compiler keeps
everything else.  All variants compile at once with nvcc into
``build/k1_ablation/`` and are launched through the package's own wrapper
(``tilted_fusion_call``, its library swapped for the variant's) on ABPN x3
at full width over 1 and 8 frames of 360x640 under ``zero``, fp32 and
bf16, with the automatic segment plan, timed as the device time of
launches queued behind a device sleep.  ``full`` is held against
``tilted_fusion_plain`` (5e-4 fp32, 5e-2 bf16).  The gap between ``full``
and a switched-off variant is what that part costs when nothing else
changes; parts overlap, so the gaps need not add up.

Exits 2 without a CUDA device.
"""

import sys

from _ablation import K1_ENTRY, K1_SRC, ROOT, build, device_ms, edits, k1_label, nvidia_smi, \
    use_k1_library

OUT = f"{ROOT}/build/k1_ablation"
NEVER = "p.repeats == 77"  # a condition no launch here meets


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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("k1_ablation: no CUDA device is available; nothing was run", file=sys.stderr)
        return 2
    from repro_torch.kernels import ops
    from repro_torch.kernels import tilted_fusion as ttf
    from repro_torch.models.abpn import init_abpn

    smi = nvidia_smi()
    print(f"nvidia-smi: {smi}")
    names = sys.argv[1:] or list(VARIANTS)
    libs = build(K1_SRC, OUT, {n: VARIANTS[n] for n in names}, K1_ENTRY, k1_label)
    dev = torch.device("cuda")

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
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
