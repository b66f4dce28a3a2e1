#!/usr/bin/env python3
"""Time K2 (``src/repro_torch/kernels/csrc/conv3x3.cu``) with parts of it
switched off, and with other build choices, on one CUDA card.

Run from the root of a checkout, on a machine with an NVIDIA card and nvcc:

    python3 tools/k2_ablation.py [variant ...]
    python3 tools/k2_ablation.py --wide [variant ...]

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

With ``--wide``: the wide instance (Ci or Co past 32) at the wide layer
shapes of ABPN x3 with 64 and 128 feature channels (3->F, F->F, F->27),
ABPN x4's 28->48 and 48->48, 96->96 over one 360x640 map, each variant on
as many persistent CTAs as its occupancy query allows.  Its variants switch
off a point of the design or take another plan, each against ``full``:
``mma_sync`` (the MMAs on ``mma.sync`` m16n8k8 / m16n8k16 with B fragments
by ``ldmatrix`` from the same slices, not ``wgmma``); ``no_overlap``
(every step waits for the copies it has just started); ``step_barrier`` (a
CTA barrier every step, the warpgroups in lockstep); ``with_fence`` (the
proxy fence a ``cp.async``-filled ring would need); ``single_taps`` and
``row_steps`` (one tap, or a row of three, a step); ``one_partial``,
``whole_blocks``, ``more_pieces`` (other pieces and pieces in flight);
``split_outputs`` (the warpgroups split the outputs, so both load and
split A); ``tile16`` (16-row tiles at bf16 N <= 64); ``two_ctas`` (two
CTAs an SM at bf16 N <= 64); ``no_fold`` (the taps of a Ci <= 3 layer each
a step of a 32-channel chunk); ``direct_store`` (the epilogue stores each
output from the fragments); and ``no_store``, ``no_mma``, ``skeleton_*``
(the MMAs off with one more part off), ``empty``.  A variant whose
instance does not fit an SM is reported, not timed.

Exits 2 without a CUDA device.
"""

import ctypes
import re
import sys

import numpy as np

from _ablation import ROOT, build, device_ms, edits, nvidia_smi
from _stacks import he_arrays

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


# ----------------------------------------------------------------------
# The wide instance
# ----------------------------------------------------------------------
WIDE_START = "// One step's product for one m64 block of a warpgroup"
WIDE_KERNEL = "template <typename T, int N, bool kFold>\n__global__ void __launch_bounds__(kWideThreads"
MMA_SYNC = """// One step's product for one m64 block of a warpgroup on mma.sync: part =
// A B from zero, each warp its 16 rows, B fragments by ldmatrix from the
// same slice; nothing is left in flight.
template <typename T, int N, int kNP>
__device__ __forceinline__ void wide_start(float (&part)[kNP / 2],
                                           const uint32_t (&a)[Mma<T>::kSteps][4], uint32_t b) {
  constexpr int kKS = Mma<T>::kSteps, kPart = N * 32;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < kNP / 2; ++i) part[i] = 0.f;
#pragma unroll
  for (int s = 0; s < kKS; ++s) {
    if constexpr (sizeof(T) == 4) {
      uint32_t ah[4], al[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) tf32_split(a[s][e], ah[e], al[e]);
#pragma unroll
      for (int jj = 0; jj < kNP / 16; ++jj) {
        uint32_t bh[4], bl[4];
        ldmatrix_x4(bh, b + 2 * s * kPart + 512 * jj + 16 * lane);
        ldmatrix_x4(bl, b + (2 * s + 1) * kPart + 512 * jj + 16 * lane);
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          float(&d)[4] = *reinterpret_cast<float(*)[4]>(&part[8 * jj + 4 * u]);
          mma_tf32(d, al, bh[2 * u], bh[2 * u + 1]);
          mma_tf32(d, ah, bl[2 * u], bl[2 * u + 1]);
          mma_tf32(d, ah, bh[2 * u], bh[2 * u + 1]);
        }
      }
    } else {
#pragma unroll
      for (int jj = 0; jj < kNP / 16; ++jj) {
        uint32_t bb[4];
        ldmatrix_x4(bb, b + s * kPart + 512 * jj + 16 * lane);
        mma_bf16(*reinterpret_cast<float(*)[4]>(&part[8 * jj]), a[s], bb[0], bb[1]);
        mma_bf16(*reinterpret_cast<float(*)[4]>(&part[8 * jj + 4]), a[s], bb[2], bb[3]);
      }
    }
  }
}

template <int K>
__device__ __forceinline__ void wide_wait(int, float (&)[K]) {}

"""


def sub_wide_start(src, new):
    """``wide_start`` and ``wide_wait`` (from their comment to the kernel
    after them) replaced."""
    i, j = src.find(WIDE_START), src.find(WIDE_KERNEL)
    if i < 0 or j < i:
        return src, 0
    return src[:i] + new + src[j:], 1


PLAN_ROWS = re.compile(r"constexpr WidePlanRow kWidePlan\[\] = \{.*?\n\};", re.S)


def wide_plan(rows=None, **every):
    """A transform of the kWidePlan table: {(element bytes, N): (og, mb, nh,
    pp, tp)} for the rows given (the last columns may be left out: the
    table's stay), and ``every`` column named there set in every row."""
    names = ("og", "mb", "nh", "pp", "tp")

    def sub(src, _):
        m = PLAN_ROWS.search(src)
        if not m:
            return src, 0
        table = {(int(r[0]), int(r[1])): tuple(map(int, r[2:])) for r in
                 re.findall(r"\{(\d+), +(\d+), " + ", +".join([r"(\d+)"] * len(names)) + r"\}",
                            m.group(0))}
        for key, row in (rows or {}).items():
            table[key] = tuple(row) + table[key][len(row):]
        for name, value in every.items():
            i = names.index(name)
            table = {k: r[:i] + (value,) + r[i + 1:] for k, r in table.items()}
        body = ",\n    ".join("{" + ", ".join(map(str, (e, n) + row)) + "}"
                               for (e, n), row in sorted(table.items()))
        return src[:m.start()] + f"constexpr WidePlanRow kWidePlan[] = {{\n    {body},\n}};" \
            + src[m.end():], 1
    return sub


def wgmma_wrapper(dtype, n):
    """The source of ``Wgmma<dtype, n>``, as the kernel's own wrappers are
    written, for a piece width the built plan does not run."""
    nd, kind, k = n // 2, ("tf32" if dtype == "float" else "bf16"), (8 if dtype == "float" else 16)
    regs = ", ".join(f"%{i}" for i in range(nd))
    outs = ", ".join(f'"+f"(d[{i}])' for i in range(nd))
    tail = "p, 1, 1;" if kind == "tf32" else "p, 1, 1, 0;"
    return (f"template <> struct Wgmma<{dtype}, {n}> {{\n"
            f"  static __device__ __forceinline__ void mma(float (&d)[{nd}], const uint32_t (&a)[4],"
            f" uint64_t b, int accumulate) {{\n"
            f'    asm volatile("{{\\n.reg .pred p;\\nsetp.ne.b32 p, %{nd + 5}, 0;\\n"\n'
            f'        "wgmma.mma_async.sync.aligned.m64n{n}k{k}.f32.{kind}.{kind} '
            f'{{{regs}}}, {{%{nd}, %{nd + 1}, %{nd + 2}, %{nd + 3}}}, %{nd + 4}, {tail}\\n}}\\n"\n'
            f'        : {outs}\n'
            f'        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));\n'
            f"  }}\n}};\n")


# the wrappers of the piece widths only a variant's plan runs (16, 96, 128)
WIDER_WGMMA = tuple((f"template <> struct Wgmma<{t}, 32> {{",
                     "".join(wgmma_wrapper(t, n) for n in (16, 96, 128))
                     + f"template <> struct Wgmma<{t}, 32> {{")
                    for t in ("float", "__nv_bfloat16"))


NO_MMA = (("      Wgmma<float, kNP>::mma(part, ", "      if (b == 1u) Wgmma<float, kNP>::mma(part, "),
          ("    for (int s = 0; s < kKS; ++s) Wgmma<T, kNP>::mma(",
           "    for (int s = 0; s < kKS; ++s) if (b == 1u) Wgmma<T, kNP>::mma("))
# wgmma's fences, commits and waits off (threadIdx.x is below 1000)
NO_WGMMA_SYNC = tuple((f'asm volatile("wgmma.{w}', f'if (threadIdx.x == 1000u) asm volatile("wgmma.{w}')
                      for w in ("fence", "commit_group", "wait_group"))
WIDE_SLICE = "#pragma unroll 1\n        for (int tt = 0; tt < C::kTP; ++tt) {\n"  # a step's MMAs
# name -> (edit, computes the whole function)
WIDE_VARIANTS = {
    "full": (edits(), True),
    # the MMAs on mma.sync, B fragments by ldmatrix from the same slices
    "mma_sync": (edits((sub_wide_start, MMA_SYNC)), True),
    # every step waits for the copies it has just started
    "no_overlap": (edits((WIDE_SLICE,
                          "        cp_async_wait<0>();\n"
                          "        if (!resident && (int)blockIdx.x + (q + kS - 2) / steps"
                          " * (int)gridDim.x < p.tiles)\n"
                          "          mbar_wait(bars + 8 * ((q + kS - 2) % kS), ((q + kS - 2) / kS)"
                          " & 1);\n" + WIDE_SLICE)), True),
    # a CTA barrier every step, the warps in lockstep
    "step_barrier": (edits(("        if (j == 0) __syncthreads();\n",
                            "        __syncthreads();\n")), True),
    # the generic-to-async proxy fence a cp.async-filled ring would need
    "with_fence": (edits(("        if (j == 0) __syncthreads();\n",
                          "        asm volatile(\"fence.proxy.async.shared::cta;\\n\" ::: \"memory\");\n"
                          "        if (j == 0) __syncthreads();\n")), True),
    # one piece of a block's outputs in flight, the adds after its MMAs
    "one_partial": (edits(*WIDER_WGMMA, (wide_plan({
        (4, 32): (1, 2, 1, 1), (4, 48): (1, 2, 1, 1), (2, 32): (1, 2, 1, 1),
        (2, 48): (1, 2, 1, 1), (2, 64): (1, 2, 1, 1), (2, 96): (1, 2, 2, 1),
        (2, 128): (1, 2, 4, 1)}), None)), True),
    # a block's outputs in one piece (nh = 1) at bf16 N = 96, 128
    "whole_blocks": (edits(*WIDER_WGMMA, (wide_plan({(2, 96): (1, 2, 1, 1),
                                                     (2, 128): (1, 2, 1, 1)}), None)), True),
    # more pieces, more of them in flight: bf16 N <= 64, fp32 N = 32, 64
    "more_pieces": (edits(*WIDER_WGMMA, (wide_plan({
        (2, 32): (1, 2, 2, 4), (2, 48): (1, 2, 3, 3), (2, 64): (1, 2, 2, 4),
        (4, 32): (1, 2, 2, 2), (4, 64): (1, 2, 2, 2)}), None)), True),
    # the warpgroups split the outputs (og = 2), so both load A
    "split_outputs": (edits((wide_plan({(4, 64): (2, 4, 1, 1), (2, 64): (2, 4, 1, 2),
                                        (2, 96): (2, 4, 1, 2), (2, 128): (2, 4, 1, 2)}), None)),
                      True),
    # one tap a step: a slice copy, a wait and a producer turn for each
    "single_taps": (edits(("  static constexpr int kTP = kFold ? 1 : kRow.tp;",
                           "  static constexpr int kTP = 1;")), True),
    # a row of three taps a step where the plan takes a chunk's nine (bf16 N <= 64)
    "row_steps": (edits((wide_plan({(2, n): (1, 2, 1, 2, 3) for n in (32, 48, 64)}), None)),
                  True),
    # two CTAs an SM (registers bounded for them) at bf16 N <= 64, whose
    # shared memory fits two
    "two_ctas": (edits((wide_plan({(2, 32): (1, 2, 1, 2, 1), (2, 48): (1, 2, 1, 1, 1),
                                   (2, 64): (1, 2, 1, 1, 1)}), None),
                       ("__global__ void __launch_bounds__(kWideThreads, 1)",
                        "__global__ void __launch_bounds__(kWideThreads, "
                        "(sizeof(T) == 2 && N <= 64 ? 2 : 1))")), True),
    # 16-row tiles (four m64 blocks a warpgroup) at bf16 N <= 64
    "tile16": (edits((wide_plan({(2, 32): (1, 4, 1, 4), (2, 48): (1, 4, 1, 2),
                                 (2, 64): (1, 4, 1, 2)}), None)), True),
    "no_fold": (edits(("  const bool fold = ci <= kFoldMaxCi;\n  const int n = wide_n(co);",
                       "  const bool fold = false;\n  const int n = wide_n(co);"),
                      ("int wide_steps(int ci) { return ci <= kFoldMaxCi ? 1 :",
                       "int wide_steps(int ci) { return false ? 1 :"),
                      ("chunks = ci <= kFoldMaxCi ? 1 :", "chunks = false ? 1 :")), True),
    # each output stored from the fragments, nothing staged
    "direct_store": (edits(
        ("            T* at = srun + col * p.co + ch;",
         "            if (col >= ncols) continue;\n"
         "            T* at = reinterpret_cast<T*>(gdst) + col * p.co + og * kNW + ch;"),
        ("            srun[col * p.co + ch] = from_f<T>(y);",
         "            if (col < ncols)\n"
         "              reinterpret_cast<T*>(gdst)[col * p.co + og * kNW + ch] = from_f<T>(y);"),
        ("      const int nbytes = ncols * p.co * kE;", "      const int nbytes = 0;")), True),
    "no_store": (edits(("      const int nbytes = ncols * p.co * kE;",
                        f"      const int nbytes = {NEVER} ? ncols * p.co * kE : 0;")), False),
    "no_mma": (edits(*NO_MMA), False),
    # the MMAs off and one more part of the loop around them
    "skeleton_no_window": (edits(*NO_MMA, ("          if (nt < p.tiles) load_win(",
                                           f"          if ({NEVER} && nt < p.tiles) load_win(")),
                           False),
    "skeleton_no_slices": (edits(*NO_MMA, (
        "        mbar_wait(bars + 8 * st,", f"        if ({NEVER}) mbar_wait(bars + 8 * st,"), (
        "            load_slice(qa % steps, qa % kS);",
        f"            if ({NEVER}) load_slice(qa % steps, qa % kS);"), (
        "            if (q >= 2) mbar_wait(empties", f"            if ({NEVER}) mbar_wait(empties"), (
        "  if (tid == 0) {  // resident:", f"  if ({NEVER} && tid == 0) {{  // resident:")), False),
    "skeleton_no_adds": (edits(*NO_MMA, (
        "#pragma unroll\n            for (int i = 0; i < kNP / 2; ++i)\n              acc[",
        f"            if ({NEVER})\n#pragma unroll\n"
        "            for (int i = 0; i < kNP / 2; ++i)\n              acc[")), False),
    "skeleton_no_ldmatrix": (edits(*NO_MMA, (
        "              for (int s = 0; s < kKS; ++s) ldmatrix_x4(a[s], at + 32 * s);",
        f"              for (int s = 0; s < kKS; ++s) if ({NEVER}) ldmatrix_x4(a[s], at + 32 * s);")),
                             False),
    "skeleton_no_wgmma_sync": (edits(*NO_MMA, *NO_WGMMA_SYNC), False),
    "skeleton_no_store": (edits(*NO_MMA, ("      const int nbytes = ncols * p.co * kE;",
                                          f"      const int nbytes = {NEVER} ? ncols * p.co * kE : 0;")),
                          False),
    "empty": (edits(("  float* sbias = reinterpret_cast<float*>(stage + C::kRuns * C::kRunBytes);\n",
                     "  float* sbias = reinterpret_cast<float*>(stage + C::kRuns * C::kRunBytes);\n"
                     f"  if (!({NEVER})) return;\n")), False),
}
# layer shapes over one map: (ci, co, relu)
WIDE_SHAPES = ((3, 64, True), (64, 64, True), (64, 27, False), (3, 128, True),
               (128, 128, True), (128, 27, False), (28, 48, False), (48, 48, True),
               (96, 96, True))


def wide_label(m):
    return (f"<{'fp32' if m.group(1) == 'f' else 'bf16'}, N {m.group(2)}, "
            f"{'folded' if m.group(3) == '1' else 'per tap'}>")


def wide_lib(path):
    lib = ctypes.CDLL(path)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.conv3x3_wide_launch.argtypes = [ci] + [vp] * 5 + [ci] * 6 + [vp]
    lib.conv3x3_wide_workspace_bytes.argtypes = [ci, ci, ci]
    lib.conv3x3_wide_occupancy.argtypes = [ci, ci, ci, ctypes.POINTER(ci), ctypes.POINTER(ci)]
    return lib


def wide_main(torch, names):
    from repro_torch.kernels import conv3x3 as k2

    libs = {name: wide_lib(path) for name, path in build(
        SRC, OUT, {n: WIDE_VARIANTS[n][0] for n in names},
        r"conv3x3_wide_kernelI(f|13__nv_bfloat16)Li(\d+)ELb([01])E", wide_label).items()}
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    stream = torch.cuda.current_stream().cuda_stream

    def launch(lib, x, w, b, relu, ws):
        code = 0 if x.dtype == torch.float32 else 1
        R, W, ci = x.shape
        co = w.shape[3]
        blocks, nbytes = ctypes.c_int(0), ctypes.c_int(0)
        err = lib.conv3x3_wide_occupancy(code, ci, co, ctypes.byref(blocks), ctypes.byref(nbytes))
        if err or blocks.value < 1:
            raise RuntimeError(f"does not fit an SM ({nbytes.value} B shared memory, error {err})")
        out = torch.empty((R, W, co), dtype=x.dtype, device=dev)
        err = lib.conv3x3_wide_launch(code, x.data_ptr(), w.data_ptr(), b.data_ptr(),
                                      out.data_ptr(), ws.data_ptr(), R, W, ci, co, int(relu),
                                      sms * blocks.value, stream)
        if err:
            raise RuntimeError(f"launch failed: CUDA error {err}")
        return out

    gen = torch.Generator().manual_seed(0)
    for dt, tag in ((torch.float32, "fp32"), (torch.bfloat16, "bf16")):
        for ci, co, relu in WIDE_SHAPES:
            (wa, ba, _), = he_arrays(np, [ci, co], 1000 + ci + co)
            x = torch.rand((360, 640, ci), generator=gen).to(dev, dt)
            w, b = torch.from_numpy(wa).to(dev, dt), torch.from_numpy(ba).to(dev, dt)
            want = k2.conv3x3_plain(x, w, b, relu=relu).float()
            atol, rtol = (2e-5, 1e-5) if dt == torch.float32 else (2e-2, 2e-2)
            cells = []
            for name, lib in libs.items():
                ws = torch.empty((max(16, lib.conv3x3_wide_workspace_bytes(
                    0 if dt == torch.float32 else 1, ci, co)),), dtype=torch.uint8, device=dev)
                try:
                    got = launch(lib, x, w, b, relu, ws)
                    torch.cuda.synchronize()
                except RuntimeError as e:
                    cells.append(f"{name} {e}")
                    continue
                if WIDE_VARIANTS[name][1]:
                    diff = (got.float() - want).abs()
                    if not bool((diff <= atol + rtol * want.abs()).all()):
                        raise RuntimeError(f"{name} {tag} {ci}->{co}: max abs err "
                                           f"{diff.max().item():.3e} outside the tolerance")
                us = 1e3 * device_ms(lambda: launch(lib, x, w, b, relu, ws), calls=10, rounds=5)
                cells.append(f"{name} {us:.1f} us")
            print(f"wide {tag} {ci}->{co}: " + "; ".join(cells), flush=True)


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
    args = sys.argv[1:]
    if "--wide" in args:
        args = [a for a in args if a != "--wide"]
        wide_main(torch, args or list(WIDE_VARIANTS))
        print(smi)
        return 0
    names = args or list(VARIANTS)
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
