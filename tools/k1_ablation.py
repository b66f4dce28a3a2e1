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
over 1 and 8 frames of 360x640 (60-row bands), on its on-chip route: the
feature maps in shared memory, mma.sync, one weight stage a step by bulk
copy.  Parts are switched off one at a time (``empty``, ``one_term``,
``no_mma``, ``no_split``, ``no_ldmatrix``, ``no_store``, ``no_map_store``,
``no_queue_store``, ``no_out_store``, ``no_f0``, ``no_carried``,
``no_stage``), and these variants compute the same bits: two weight
stages, the next step's copied behind this step's MMAs (``two_stage``),
the stage by ``cp.async`` instead of a bulk copy (``cp_async_stage``), four
fragments a warp in fp32 (``frags4``), the loops rolled (``taps_rolled``,
``ks_rolled``, ``frags4_rolled``), a pixel's row by division (``div_c``),
the route on wgmma (``wgmma``, ``tools/k1_wgmma_route.cu`` inserted), and
the maps in device memory (``device_route``: the built kernel with the
wrapper told to take the route taller bands take).  With ``--wide``: the
wide instances on
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


# The narrow variants switch parts of the on-chip route off under a flag in
# constant memory that no launch sets, which the compiler cannot fold.
FLAG = "namespace {\n"
NEVER_FLAG = "k1_never == 77"
WITH_FLAG = (FLAG, FLAG + "__constant__ int k1_never;  // 0: the variants' parts stay on\n")
ONCHIP = "  char* sm = reinterpret_cast<char*>(smem);\n"
BULK = "        bulk_copy(smem_addr(stage), wsrc, bytes, bar);\n"
STAGE_ISSUE = ("      if (tid == 0) {  // this step's weights\n        int bytes;\n"
               "        const char* wsrc = stage_src<T, CHP, MIXED>(p, i, false, bytes);\n" + BULK +
               "      }\n")
# the wgmma route (tools/k1_wgmma_route.cu) inserted above the wide
# instances, launched where its ring fits, its weights packed in tap slices
WGMMA_ROUTE = open(f"{ROOT}/tools/k1_wgmma_route.cu").read().split("\n\n", 1)[1]
NARROW_INSTANCE = "  if (!onchip_fits<T, CHP>(R, C)) return {nullptr, 0};\n"
WGMMA_INSTANCE = (
    "  const int slots = wg_slots<T, CHP>(R, C);\n"
    "  if (slots) {\n"
    "    const int smem = wg_smem<T, CHP>(R, C, slots);\n"
    "    switch (wg_nb((R * C + 63) / 64)) {\n"
    "      case 2: return {tilted_fusion_wgmma_kernel<T, CHP, MIXED, 2>, smem};\n"
    "      case 4: return {tilted_fusion_wgmma_kernel<T, CHP, MIXED, 4>, smem};\n"
    "      default: return {tilted_fusion_wgmma_kernel<T, CHP, MIXED, 5>, smem};\n"
    "    }\n  }\n")
LAUNCH_PACK = "cudaError_t launch_pack(const Params& p, bool onchip, cudaStream_t stream) {\n"
CORE_PACK = (
    LAUNCH_PACK +
    "  if constexpr (!Cfg<T, CHP>::kWide) {\n"
    "    if (onchip && wg_slots<T, CHP>(p.R, p.C)) {\n"
    "      const size_t words = core_packed_bytes<T, CHP>(p.L, p.ks0, p.out_ch) / 4;\n"
    "      pack_core_kernel<T, CHP><<<(int)((words + kThreads - 1) / kThreads), kThreads, 0,\n"
    "                                 stream>>>(static_cast<const T*>(p.w),\n"
    "                                           static_cast<const T*>(p.bias),\n"
    "                                           static_cast<uint32_t*>(p.ws), p.L, p.ks0,\n"
    "                                           p.out_ch);\n"
    "      return cudaGetLastError();\n    }\n  }\n")
TAPS_UNROLLED = ("#pragma unroll 1\n  for (int dy = 0; dy < 3; ++dy) {\n#pragma unroll\n"
                 "    for (int dx = 0; dx < 3; ++dx) tap(dy, dx);\n  }\n")
TAPS_ROLLED = "#pragma unroll 1\n  for (int t = 0; t < 9; ++t) tap(t / 3, t % 3);\n"
KS_ROLLED = (("#pragma unroll\n        for (int s = 0; s < KS; ++s) kstep(dy, dx, s, acc);",
              "#pragma unroll 1\n        for (int s = 0; s < KS; ++s) kstep(dy, dx, s, acc);"),
             ("#pragma unroll\n        for (int s = 0; s < KS; ++s) kstep(dy, dx, s, part);",
              "#pragma unroll 1\n        for (int s = 0; s < KS; ++s) kstep(dy, dx, s, part);"))
# fp32 warps with four fragments a block of 512 pixels on the on-chip route
ARGS = "p, st, stage, src, zero, warp, nxt, qout, out, x, first"
RUN_BLOCK_2 = (
    "  constexpr int KS = Cfg<T, CHP>::kKS;\n"
    "  if (warp + kWarps < nf) {\n")
RUN_BLOCK_4 = (
    "  constexpr int KS = Cfg<T, CHP>::kKS;\n"
    "  constexpr int kMax = ONCHIP && sizeof(T) == 4 ? 4 : 2;\n"
    "  const int mine = warp < nf ? min((nf - 1 - warp) / kWarps + 1, kMax) : 0;\n"
    "  if constexpr (kMax == 4) {\n"
    "    if (mine == 4 || mine == 3) {\n"
    "      if (mine == 4) {\n"
    "        if (st.l > 0) block_mma<T, CHP, MIXED, ONCHIP, NG, 4, KS>(" + ARGS + ");\n"
    "        else block_mma<T, CHP, MIXED, ONCHIP, NG, 4, 0>(" + ARGS + ");\n"
    "      } else {\n"
    "        if (st.l > 0) block_mma<T, CHP, MIXED, ONCHIP, NG, 3, KS>(" + ARGS + ");\n"
    "        else block_mma<T, CHP, MIXED, ONCHIP, NG, 3, 0>(" + ARGS + ");\n"
    "      }\n"
    "      return;\n"
    "    }\n"
    "  }\n"
    "  if (warp + kWarps < nf) {\n")
BLOCK_512 = "(sizeof(T) == 4 ? 512 : kBlockPix)"
FRAGS = ((RUN_BLOCK_2, RUN_BLOCK_4),
         ("  const int npix = R * C, nblk = (npix + kBlockPix - 1) / kBlockPix;",
          f"  const int npix = R * C, nblk = (npix + {BLOCK_512} - 1) / {BLOCK_512};"),
         ("        st.p0 = b * kBlockPix;\n        st.npix = min(kBlockPix, npix - st.p0);",
          f"        st.p0 = b * {BLOCK_512};\n        st.npix = min({BLOCK_512}, npix - st.p0);"))
VARIANTS = {
    "full": edits(),
    "empty": edits(WITH_FLAG, (ONCHIP, ONCHIP + f"  if (!({NEVER_FLAG})) return;\n")),
    # only hi*hi of 3xTF32 (bf16: unchanged)
    "one_term": edits(WITH_FLAG,
                      ("mma_tf32(d[f][jb], al[f]", f"if ({NEVER_FLAG}) mma_tf32(d[f][jb], al[f]"),
                      ("mma_tf32(d[f][jb], ah[f], bl",
                       f"if ({NEVER_FLAG}) mma_tf32(d[f][jb], ah[f], bl")),
    "no_mma": edits(WITH_FLAG, ("mma_tf32(d[f][jb], ", f"if ({NEVER_FLAG}) mma_tf32(d[f][jb], "),
                    ("mma_bf16(d[f][jb], ", f"if ({NEVER_FLAG}) mma_bf16(d[f][jb], ")),
    # A and B used unsplit (fp32: the MMAs read raw fp32 bits as TF32)
    "no_split": edits(WITH_FLAG,
                      ("tf32_split(a[f][c], ah[f][c], al[f][c]);",
                       f"if ({NEVER_FLAG}) tf32_split(a[f][c], ah[f][c], al[f][c]); "
                       f"else ah[f][c] = al[f][c] = a[f][c];"),
                      ("tf32_split(bw[u], bh[u], bl[u]);",
                       f"if ({NEVER_FLAG}) tf32_split(bw[u], bh[u], bl[u]); "
                       f"else bh[u] = bl[u] = bw[u];")),
    # A fragments not loaded (the MMAs run on whatever the registers hold)
    "no_ldmatrix": edits(WITH_FLAG, ("    uint32_t a[NF][4];\n", "    uint32_t a[NF][4] = {};\n"),
                         ("      ldmatrix_x4(a[f], addr);",
                          f"      if ({NEVER_FLAG}) ldmatrix_x4(a[f], addr);")),
    "no_store": edits(WITH_FLAG, ("    if (px >= st.npix) continue;",
                                  f"    if (px >= st.npix || !({NEVER_FLAG})) continue;")),
    # a pixel's row by integer division by C in the epilogue and the A rows
    # instead of FastDiv's multiply-high (the same quotients)
    "div_c": edits(("cdiv.div(st.p0 + px)", "(st.p0 + px) / C"),
                   ("    const int r = cdiv.div(px), j = px - r * C;\n",
                    "    const int r = px / C, j = px - r * C;\n")),
    # one kind of store at a time: a hidden layer's to its map, its carried
    # columns' to the queue, the last layer's to `out`
    "no_map_store": edits(WITH_FLAG, ("        if (nxt) {\n          const int cb",
                                      f"        if (nxt && {NEVER_FLAG}) {{\n          const int cb")),
    "no_queue_store": edits(WITH_FLAG, (
        "      if (j >= C - 2)  // F_{l+1}'s last two columns: tile k+1's carried ones\n",
        f"      if (j >= C - 2 && {NEVER_FLAG})  // F_{{l+1}}'s last two columns\n")),
    "no_out_store": edits(WITH_FLAG, (
        "      store4(out + ((size_t)r * KC + st.k * C + j) * (MIXED ? p.out_ch : CHP) + co4, v);",
        f"      if ({NEVER_FLAG})\n        store4(out + ((size_t)r * KC + st.k * C + j) * "
        f"(MIXED ? p.out_ch : CHP) + co4, v);")),
    # F_0's copies from the stream, and the carried columns' from the queue
    "no_f0": edits(WITH_FLAG, ("  const int total = p.R * SC << shift;\n",
                               f"  const int total = {NEVER_FLAG} ? p.R * SC << shift : 0;\n")),
    "no_carried": edits(WITH_FLAG, (
        "  const int total = p.R * 2 * kChunks;\n",
        f"  const int total = {NEVER_FLAG} ? p.R * 2 * kChunks : 0;\n")),
    # the weight stages not copied (the step's mbarrier completes at once)
    "no_stage": edits(WITH_FLAG, (
        BULK, f"        if ({NEVER_FLAG})\n  " + BULK +
        "        else asm volatile(\"mbarrier.arrive.shared::cta.b64 _, [%0];\\n\"\n"
        "                          ::\"r\"(bar) : \"memory\");\n")),
    # the weight scheme: two stages (at 60-row bands, where they fit beside
    # the maps), step n's in slot n & 1, the next step's copied at a step's
    # start behind its MMAs into the slot the step before read
    "two_stage": edits(
        ("  return 2 * onchip_map_bytes<T, CHP>(R, C) + Cfg<T, CHP>::kStageBytes + 32;",
         "  return 2 * onchip_map_bytes<T, CHP>(R, C) + 2 * Cfg<T, CHP>::kStageBytes + 32;"),
        ("  char* tail = stage + G::kStageBytes;", "  char* tail = stage + 2 * G::kStageBytes;"),
        ("    mbar_init(bar, 1);\n", "    mbar_init(bar, 1);\n    mbar_init(bar + 8, 1);\n"),
        ("  int uses = 0;  // steps run: the mbarrier's phases\n",
         "  int uses = 0;  // steps run: step n's stage in slot n & 1\n"
         "  if (tid == 0) {  // the first step's weights\n    int bytes;\n"
         "    const char* wsrc = stage_src<T, CHP, MIXED>(p, 0, false, bytes);\n"
         "    bulk_copy(smem_addr(stage), wsrc, bytes, bar);\n  }\n"),
        (STAGE_ISSUE,
         "      if (tid == 0 && !(i == ns - 1 && k == k1 - 1)) {  // the next step's weights\n"
         "        const int nx = (uses + 1) & 1;\n        int bytes;\n"
         "        const char* wsrc = stage_src<T, CHP, MIXED>(p, i + 1 < ns ? i + 1 : 0, false,\n"
         "                                                    bytes);\n"
         "        bulk_copy(smem_addr(stage + nx * G::kStageBytes), wsrc, bytes, bar + 8 * nx);\n"
         "      }\n"),
        ("      mbar_wait(bar, uses++ & 1);\n",
         "      const char* wst = stage + (uses & 1) * G::kStageBytes;\n"
         "      mbar_wait(bar + 8 * (uses & 1), (uses >> 1) & 1);\n      ++uses;\n"),
        ("true>(p, st, i - l, stage, src,", "true>(p, st, i - l, wst, src,")),
    # the stage by cp.async, every thread's copies tracked by the stage's
    # mbarrier (256 arrivals a phase), instead of one bulk copy
    "cp_async_stage": edits(
        ("    mbar_init(bar, 1);\n", "    mbar_init(bar, kThreads);\n"),
        (STAGE_ISSUE,
         "      {  // this step's weights, every thread's copies\n"
         "        load_stage<T, CHP, MIXED>(p, i, stage);\n"
         "        asm volatile(\"cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\\n\"\n"
         "                     ::\"r\"(bar) : \"memory\");\n      }\n")),
    # fp32 warps with four fragments a block (a k-step's B words loaded and
    # split once for four), and the loop's code size: taps, then k-steps
    # not unrolled
    "frags4": edits(*FRAGS),
    "taps_rolled": edits((TAPS_UNROLLED, TAPS_ROLLED)),
    "ks_rolled": edits((TAPS_UNROLLED, TAPS_ROLLED), *KS_ROLLED),
    "frags4_rolled": edits((TAPS_UNROLLED, TAPS_ROLLED), *KS_ROLLED, *FRAGS),
    # wgmma on the on-chip route (tap slices through a ring, one CTA an
    # SM): the wrapper sized for it too (WGMMA)
    "wgmma": edits(("#include <stdint.h>\n", "#include <stdint.h>\n\n#include <type_traits>\n"),
                   (WIDE_MARK, WGMMA_ROUTE + WIDE_MARK),
                   (NARROW_INSTANCE, WGMMA_INSTANCE + NARROW_INSTANCE),
                   (LAUNCH_PACK, CORE_PACK)),
    "device_route": edits(),  # DEVICE_ROUTE: the wrapper's route, not the source, changes
}
# variants that compute the same bits as full, held to the plain version
SAME_BITS = {"two_stage", "cp_async_stage", "frags4", "taps_rolled", "ks_rolled",
             "frags4_rolled", "div_c", "wgmma", "device_route"}
WGMMA = {"wgmma"}


def wgmma_sizes(ttf, torch):
    """What the wrapper allocates and reports for a build with the wgmma
    route (its mirror of wg_slots, wg_smem and core_packed_bytes): a Route
    and the packed weights' bytes, for narrow launches."""
    route, packed = ttf.route, ttf.packed_weight_bytes

    def wg_route(R, C, chp, dtype=torch.float32, hidden=None):
        inst = hidden or ttf.launch_chp(chp, dtype)
        f32 = dtype != torch.bfloat16
        if inst > 32 or R is None or not 1 <= int(R) <= 1024:
            return route(R, C, chp, dtype, hidden)
        maps = -(-int(R) * (int(C) + 2) * ttf._pixel_bytes(inst, dtype) // 128) * 128
        slice_max = (inst // (8 if f32 else 16)) * (2 if f32 else 1) * inst * 32
        slots = min(9, (232_448 - 2 * maps - 16) // (slice_max + 16))
        if slots < 2:
            return route(R, C, chp, dtype, hidden)
        return ttf.Route(True, 2 * maps + slots * (slice_max + 16) + 16)

    def wg_packed(L, chp, c0p, dtype, hidden_chp=None, onchip=True):
        if ttf._wide(hidden_chp or chp) or not onchip:
            return packed(L, chp, c0p, dtype, hidden_chp, onchip=onchip)
        f32 = dtype != torch.bfloat16
        k = 8 if f32 else 16
        hid = hidden_chp or chp
        steps = [(l, hid) for l in range(L - 1)] + [
            (L - 1, n) for n in (ttf.output_groups(chp) if hidden_chp else [chp])]
        return sum(4 * n + 9 * (-(-c0p // k) if l == 0 else hid // k) * (2 if f32 else 1) * n * 32
                   for l, n in steps)

    return wg_route, wg_packed
# maps in device memory: the built kernel, the wrapper told to take the
# device-memory route at every height (no source edit)
DEVICE_ROUTE = {"device_route"}
# the host code (below the wide instances) is edited where it is
WHOLE_SOURCE = {"wgmma"}
VARIANTS = {name: t if name in WHOLE_SOURCE else narrow_only(t) for name, t in VARIANTS.items()}


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
    ("      kWide ? 2 * kSliceBytes + kWinBytes : 2 * kSplitStageBytes + 2 * kWinBytes;",
     "      kWide ? 2 * kSliceBytes + (kTwoWins ? 2 : 1) * kWinBytes\n"
     "            : 2 * kSplitStageBytes + 2 * kWinBytes;"),
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
                route, packed_bytes = ttf.route, ttf.packed_weight_bytes
                if name in DEVICE_ROUTE:  # the wrapper asks for the route and its slabs
                    ttf.route = lambda R, C, chp, dtype=None, hidden=None: ttf.Route(
                        False, ttf.shared_bytes(hidden or chp, dtype))
                if name in WGMMA:  # the wrapper sizes what this build reads
                    ttf.route, ttf.packed_weight_bytes = wgmma_sizes(ttf, torch)
                try:
                    call = lambda: ttf.tilted_fusion_call(xs, first, packed.w, packed.b, **kw)
                    got = call()
                    torch.cuda.synchronize()
                    if name == "full" or name in SAME_BITS:
                        err = (got.float() - want).abs().max().item()
                        if not err <= tol:
                            raise RuntimeError(f"{name} {tag} at {n}: max abs err {err:.3e} > "
                                               f"{tol}")
                    plan = ttf.launch_plan(xs, packed.w, tile_cols=8)
                    cells.append(f"{name} {device_ms(call):.3f} ms (S={plan.segments})")
                finally:
                    ttf.route, ttf.packed_weight_bytes = route, packed_bytes
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
    built = build(K1_SRC, OUT + ("_wide" if is_wide else ""),
                  {n: table[n] for n in names if is_wide or n not in DEVICE_ROUTE},
                  WIDE_ENTRY if is_wide else K1_ENTRY, k1_label)
    libs = {n: built.get(n, built["full"]) for n in names}  # device_route: full's library
    dev = torch.device("cuda")
    if is_wide:
        wide(torch, np, ops, ttf, libs, dev)
    else:
        narrow(torch, ops, ttf, libs, dev)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
