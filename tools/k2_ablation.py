#!/usr/bin/env python3
"""Time K2 (``src/repro_torch/kernels/csrc/conv3x3.cu``) with parts of it
switched off, and with other build choices, on one CUDA card.

Run from the root of a checkout, on a machine with an NVIDIA card and nvcc:

    python3 tools/k2_ablation.py

Each variant is the kernel's source with one edit.  A part is switched off
by making it run only under a condition that never holds at run time
(``relu == 77``), so the compiler keeps everything else.  All variants
compile at once with nvcc into ``build/k2_ablation/`` and are timed at the
ABPN x3 layer shapes over one 360x640 map (3->28, 28->28, 28->27), fp32 and
bf16, as the device time of launches queued behind a device sleep, each on
as many persistent CTAs as its own occupancy query allows.  Variants that
compute the whole function are held against ``conv3x3_plain`` at K2's
tolerances.  The gap between ``full`` and a switched-off variant is what
that part costs when nothing else changes; parts overlap, so the gaps need
not add up.

Exits 2 without a CUDA device.
"""

import ctypes
import re
import sys

from _ablation import ROOT, build, device_ms, edits, nvidia_smi

SRC = f"{ROOT}/src/repro_torch/kernels/csrc/conv3x3.cu"
OUT = f"{ROOT}/build/k2_ablation"
NEVER = "p.relu == 77"  # a condition no launch meets

PLAN = re.compile(r"template <typename T, bool kFold> struct Plan \{.*?\n\};", re.S)


def plan(frags, blocks):
    """The Plan struct with kFrags and kMinBlocks as C++ expressions."""
    return ("template <typename T, bool kFold> struct Plan {\n"
            f"  static constexpr int kFrags = {frags};\n"
            f"  static constexpr int kMinBlocks = {blocks};\n}};")


def sub_plan(src, new):
    return PLAN.subn(new, src, count=1)


LOOP = "  for (int it = 0; tile < p.tiles; ++it, tile += gridDim.x) {"
MMAS = [
    ("mma_tf32(acc[f][j], al, ", f"if ({NEVER}) mma_tf32(acc[f][j], al, "),
    ("mma_tf32(acc[f][j], ah, ", f"if ({NEVER}) mma_tf32(acc[f][j], ah, "),
    ("++j) mma_bf16(", f"++j) if ({NEVER}) mma_bf16("),
]
# name -> (edit, computes the whole function)
VARIANTS = {
    "full": (edits(), True),
    "empty": (edits(("  extern __shared__ uint4 smem[];",
                     f"  extern __shared__ uint4 smem[];\n  if (!({NEVER})) return;")), False),
    "prologue": (edits((LOOP, f"  if (!({NEVER})) return;\n{LOOP}")), False),
    "prologue_no_weights": (edits(
        (LOOP, f"  if (!({NEVER})) return;\n{LOOP}"),
        ("  rw.store(p, raw);", f"  if ({NEVER}) rw.store(p, raw);"),
        ("  build_weights<T, kFold>(p, raw,", f"  if ({NEVER}) build_weights<T, kFold>(p, raw,")),
        False),
    "no_mma": (edits(*MMAS), False),
    "no_load": (edits(("    if (tile + (int)gridDim.x < p.tiles)\n      load_window",
                       f"    if ({NEVER} && tile + (int)gridDim.x < p.tiles)\n      load_window")),
                False),
    "no_store": (edits(("    const int nbytes = ncols * p.co * (int)sizeof(T);",
                        f"    const int nbytes = {NEVER} ? ncols * p.co * (int)sizeof(T) : 0;")),
                 False),
    # build choices the kernel's Plan did not take
    "one_frag_per_warp": (edits((sub_plan, plan(
        "1", "sizeof(T) == 4 ? (kFold ? 2 : 1) : (kFold ? 3 : 2)"))), True),
    "one_more_cta": (edits((sub_plan, plan(
        "2", "sizeof(T) == 4 ? (kFold ? 3 : 1) : (kFold ? 4 : 3)"))), True),
}


def k2_label(m):
    return (f"<{'fp32' if m.group(1) == 'f' else 'bf16'}, "
            f"{'folded' if m.group(2) == '1' else 'per tap'}>")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("k2_ablation: no CUDA device is available; nothing was run", file=sys.stderr)
        return 2
    from repro_torch.kernels import conv3x3 as k2

    smi = nvidia_smi()
    print(f"nvidia-smi: {smi}")
    names = sys.argv[1:] or list(VARIANTS)
    libs = {}
    for name, path in build(SRC, OUT, {n: VARIANTS[n][0] for n in names},
                            r"conv3x3_kernelI(f|13__nv_bfloat16)Lb([01])E", k2_label).items():
        lib = ctypes.CDLL(path)
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.conv3x3_launch.argtypes = [ci] + [vp] * 4 + [ci] * 6 + [vp]
        lib.conv3x3_blocks_per_sm.argtypes = [ci, ci, ctypes.POINTER(ci)]
        libs[name] = lib
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    stream = torch.cuda.current_stream().cuda_stream

    def launch(lib, x, w, b, relu):
        code = 0 if x.dtype == torch.float32 else 1
        R, W, ci = x.shape
        co = w.shape[3]
        blocks = ctypes.c_int(0)
        if lib.conv3x3_blocks_per_sm(code, ci, ctypes.byref(blocks)) != 0:
            raise RuntimeError("occupancy query failed")
        out = torch.empty((R, W, co), dtype=x.dtype, device=dev)
        err = lib.conv3x3_launch(code, x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(),
                                 R, W, ci, co, int(relu), sms * blocks.value, stream)
        if err:
            raise RuntimeError(f"launch failed: CUDA error {err}")
        return out, blocks.value

    gen = torch.Generator().manual_seed(0)
    for dt, tag in ((torch.float32, "fp32"), (torch.bfloat16, "bf16")):
        for ci, co, relu in ((3, 28, True), (28, 28, True), (28, 27, False)):
            x = torch.rand((360, 640, ci), generator=gen).to(dev, dt)
            w = (0.2 * torch.randn((3, 3, ci, co), generator=gen)).to(dev, dt)
            b = (0.1 * torch.randn((co,), generator=gen)).to(dev, dt)
            want = k2.conv3x3_plain(x, w, b, relu=relu).float()
            atol, rtol = (2e-5, 1e-5) if dt == torch.float32 else (2e-2, 2e-2)
            cells = []
            for name, lib in libs.items():
                got, blocks = launch(lib, x, w, b, relu)
                torch.cuda.synchronize()
                if VARIANTS[name][1]:
                    diff = (got.float() - want).abs()
                    if not bool((diff <= atol + rtol * want.abs()).all()):
                        raise RuntimeError(f"{name} {tag} {ci}->{co}: max abs err "
                                           f"{diff.max().item():.3e} outside the tolerance")
                us = 1e3 * device_ms(lambda: launch(lib, x, w, b, relu), calls=20, rounds=5)
                cells.append(f"{name} {us:.1f} us ({blocks} CTAs/SM)")
            print(f"{tag} {ci}->{co}: " + "; ".join(cells), flush=True)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
