// Tilted layer fusion on Hopper (sm_90a): the fused L-layer 3x3 conv stack
// swept over a band by tilted column tiles, on the tensor cores.
//
// Replaces: src/repro/kernels/tilted_fusion.py::tilted_fusion_kernel, the
// Pallas TPU kernel launched by tilted_fusion_call over grid (band, tile k).
//
// What bounds it on this card.  ABPN x3 is 42,840 MAC per LR pixel; a
// 360x640 frame is 19.7 GFLOP (37.7 as executed: Chp = 32 padding and
// warm-up tiles) against ~30 MB of output.  On the tensor cores (495
// TFLOP/s TF32, 989 bf16; 3.35 TB/s) fp32 as 3xTF32 (three TF32 products
// per fp32 product) is bound by operations, 0.120 ms a frame for the
// unpadded work; bf16 is bound by its bytes.  The second limit is
// parallelism: the overlap queue carries state from tile k to tile k+1, so
// a band is one sequential sweep, and a 360-row frame has only 6 bands.
// The third is the loop around the MMAs: per (tile, layer) step a weight
// stage, a barrier, the A loads and splits and the epilogue, which stay
// the same whatever the MMAs cost.
//
// What this design does about it:
//   * column segments: each band's K tiles are cut into S contiguous
//     segments [k0, k1) of near-equal length (k0 = seg*K/S, rounded down),
//     and each (band, segment) pair is one CTA, so B*S CTAs fill the SMs.
//     A segment that starts at k0 >= w restarts the sweep at kw = k0 - w
//     with w = ceil((2L-1)/C) warm-up tiles: F_0 is read from the input
//     stream, the deeper layers' carried columns start at zero, and tiles
//     kw..k0-1 run layers 0..L-2 and store nothing.  A wrong carried column
//     of F_l reaches at most one more column per layer, so after w tiles
//     every column a layer carries into tile k0 is the full sweep's, bit
//     for bit; the output does not depend on S.  A segment with k0 < w
//     starts at tile 0 with the band-start state.
//   * every layer's nine shifted (pixels, Chp) @ (Chp, Chp) products run on
//     the tensor cores through mma.sync.  A step's output pixels, row-major,
//     are cut into m16 fragments of 16 consecutive pixels (two rows at C =
//     8), at most two a warp in a block of 256 pixels; N = Chp is Chp/8 n8
//     blocks.  bf16: m16n8k16 (bf16 products are exact in fp32), each tap's
//     k-steps summed by the MMAs from zero and the tap's partial added to the
//     accumulator in fp32, as the plain version adds its nine products.
//     fp32 (and int8, which computes in fp32): m16n8k8 TF32 three times
//     (3xTF32), each operand split into hi = tf32(a) and lo = tf32(a - hi),
//     rounded as cvt.rna.tf32.f32 rounds, summed lo*hi + hi*lo + hi*hi, small
//     terms first.  Layer 0 reads c0p channels, padded to the MMA's k (8 in
//     TF32, 16 in bf16, the pad zero-filled): one k-step a tap at c0p = 8.
//     Every output element is summed in one order (tap, k-step, term)
//     wherever its pixel falls in a fragment, block, tile, segment, band or
//     route.  wgmma gives mma.sync's bits on the same operands in the same
//     order (tools/k1_wgmma_probe.py), so the narrow instance could move to
//     it while the wide instances stay on mma.sync; an on-chip route on
//     wgmma (tools/k1_wgmma_route.cu: two warpgroups, A from registers, the
//     tap slices through a ring of bulk copies) ran 1.2x (fp32) to 1.9-2.5x
//     (bf16) slower than this one on an H100 and is not built
//     (tools/k1_ablation.py wgmma, PERF.md).
//   * weights packed once per launch.  A first small kernel writes every
//     step's B fragments, already in the mma register layout, with its bias
//     as fp32, into the head of the workspace: a stage a layer.  On the
//     on-chip route fp32 B is unsplit (Chp 32: 36,992 B; the MMAs split B at
//     use as they split A, so that a stage is half the size and fits beside
//     a 74-row band's two maps); on the device-memory route, where shared
//     memory does not hold the maps, pre-split into TF32 hi and lo (73,856
//     B), so that its MMAs split only A.
//   * the feature maps on chip (the on-chip route, tilted_fusion_kernel_
//     onchip), as the TPU kernel keeps them in VMEM: a tile's F_1..F_{L-1}
//     never go to device memory.  Two maps of R x (C + 2) pixels in shared
//     memory: the sweep's layer steps take turns, F_l of layer step g sits
//     in map g & 1 (columns 0 and 1 the two carried from tile k - 1, 2 ..
//     C + 1 the C fresh ones), and layer l reads its window there and writes
//     F_{l+1} into the other map; only the last layer stores, to `out`.  A
//     step's blocks (256 consecutive pixels of the tile, two m16 fragments
//     a warp) need no copy and no barrier between them: a step has one
//     barrier.  Rows outside the band are read as 16 zero bytes under
//     `zero` and clamped under `replicate`.  What still moves: F_0 (from the
//     stream, cp.async) into the map the tile's last layer does not read,
//     behind that layer's MMAs; F_{l+1}'s two carried columns from the
//     overlap queue (2, L-1, R, 2, Chp) in device memory (cp.async, zeros at
//     a sweep's start), at layer l's step, and layer l's last two output
//     columns back to it: the queue stays in device memory, as it does not
//     fit beside the maps in fp32 (92 KB at R = 60) and moves 2 of each
//     layer's C + 2 columns; the weights, the step's stage by one bulk copy
//     at the step's start, completed on its mbarrier while the step's other
//     copies are issued; the step barrier frees the stage for the next (a
//     second stage, the next step's copied behind this step's MMAs, was
//     level or slower: tools/k1_ablation.py two_stage).  Shared memory
//     (onchip_smem; tilted_fusion.py::route picks the route and the launch
//     checks that it fits, onchip_fits): 2 maps + a stage + 32 B, within one
//     CTA's 232,448 B in fp32 (one CTA an SM) and within half an SM less 1
//     KB in bf16 (two): fp32 Chp 32 at tile 8 190,624 B at R = 60, 226,464
//     at R = 74 (up to R = 76); bf16 95,392 at R = 60, 113,312 at R = 74
//     (up to 75).  A map pixel of 128 bytes is stored with its 16-byte
//     chunks swizzled (chunk ^ pixel % 8), one of 64 (bf16 Chp 32, fp32 Chp
//     16) chunk ^ (pixel / 2) % 4, others padded by 16 bytes, so that the 8
//     rows of each ldmatrix matrix fall on distinct banks; each fragment is
//     one ldmatrix.x4 per tap and k-step (an fp32 is two b16 halves, so the
//     same instruction gives the m16k8 TF32 fragment).
//   * the device-memory route (tilted_fusion_kernel), for bands too tall for
//     the maps (the planner's one-band fallback of any height): two
//     ping-pong slabs (R, C, Chp) per CTA in device memory beside the queue;
//     each step streams its windows of at most 320 pixels (30 rows at C = 8)
//     through shared memory with cp.async, double-buffered, and writes its
//     output to the other slab; its stages come by cp.async a step ahead.
//     Shared memory does not depend on R: fp32 Chp 32 two stages 2 x 73,856
//     B + two windows 2 x 40,960 B = 229,632 B; bf16 78,080 B (unsplit B,
//     split at every MMA, ran 7-12 % slower in fp32: tools/k1_times.py
//     --band-rows 86 360).  The wrapper chooses the route by shape
//     (tilted_fusion.py::route), never by a failure, and the same
//     arithmetic gives the same bits on both.
//   * epilogue from the accumulator fragments: bias, ReLU, the phantom-column
//     mask (acol = k*C - l + j outside [0, W)), the row bounds, one rounding
//     to the storage dtype; a layer's output goes to the next map or slab
//     (and its last two columns to the queue), the last layer's to `out`,
//     with the anchor read from the input stream (add_anchor).
//   * a residual block's epilogue (EPI, the Chp 64 wide instance only:
//     RLFN's 52-channel segments): an activated layer's leaky slope
//     (slope[l]; 0 is ReLU) in place of ReLU, and after the last layer's
//     activation, masks and rounding, a residual tensor res (B, res_rows, W,
//     res_ch) added to the output pixel at band row r and column acol where
//     res_off <= r < res_off + res_rows (under halo the band's own rows),
//     the sum rounded to the storage dtype again, as a PyTorch add of two
//     tensors of that dtype rounds it.  A template choice, its arguments in
//     a block of their own (Epi, a wide kernel's second), so that every
//     other instance compiles to the code it had.
//   * widths: instances for Chp 16, 32, 48, 64, 96 and 128 (K1_INSTANCES;
//     the wrapper pads a stack to the next, tilted_fusion.py::launch_chp).
//     The above is the "narrow" design of Chp 16 and 32.  A whole layer's
//     stage and all Chp accumulators of a warp do not fit wider (a fp32 Chp
//     128 stage is 295 KB; Chp fp32 accumulators a thread), so the "wide"
//     instances (tilted_fusion_wide_kernel) cut the outputs into n-groups
//     of kNG and stream a layer's B fragments through two slices of shared
//     memory, double-buffered by cp.async behind the MMAs and pre-split into
//     TF32 hi and lo once a launch by pack_slices_kernel.  Their feature maps
//     stay in device-memory slabs, streamed a row block's window at a time.
//     Per instance a schedule (wide_sched, chosen on the card by
//     tools/k1_ablation.py --wide) sets what bounds it there.  Its
//     tensor-core work is shared-memory fed: a warp's k-step loads its A
//     fragments (and splits them into TF32 hi and lo) and B's hi and lo
//     words for its kNG outputs, so a larger n-group cuts the loads and
//     splits an MMA: fp32 computes 48, 64 or 96 outputs a pass (Chp 64: A
//     loaded and split once a tap and k-step, not twice), and where a whole
//     tap's outputs would not fit beside the window (Chp 96, 128) a slice
//     holds half a tap's k-steps.  Slices of a tap row (3 taps) where they
//     fit cut the barrier pairs of an n-group from 9 to 3 (bf16, fp32 Chp
//     48).  bf16 up to Chp 64 fits 2 CTAs an SM at 128 registers; fp32 at
//     128 registers spills and runs slower than one CTA.  A row block's
//     window (320 pixels) is copied once, then every n-group runs its 9 taps
//     and stores its channels.  A second window, copied behind the MMAs
//     (tools/k1_ablation.py --wide two_windows: fp32 Chp 48 and 64, bf16 at
//     every width), was slower or level within about 2 % noise (a step's
//     first block reads the step before it, so only later blocks can be
//     overlapped).  The arithmetic is the narrow design's: every element
//     sums tap, k-step, term in the same order whatever the schedule, so
//     segments stay bit-identical and a stack padded with zero channels
//     gives the narrow instance's result bit for bit.  Shared memory: fp32
//     Chp 48 177,152 B, Chp 128 229,376 B; bf16 Chp 48 63,488 B.
//   * mixed widths: a stack whose feature maps F_0..F_{L-1} fit 32 channels
//     but whose last layer has more outputs (ABPN x4: 3 -> 28 x6 -> 48) runs
//     on the narrow Chp 32 instance, on either route, with the output width
//     out_ch (48, 64, 96 or 128) given at launch.  Its step pipeline is one
//     of (layer, output group) steps: layers 0..L-2 one step each at Chp 32,
//     exactly as a narrow launch; layer L-1 ceil(out_ch / 32) steps, output
//     group g (32 outputs, the last 16 where out_ch = 48) with a stage of
//     its own B fragments and bias, each reading the same map (on the
//     device-memory route copying its hidden-width windows again).  No stage
//     is larger than a Chp 32 layer's, so shared memory, occupancy and the
//     segment plan are the narrow instance's.  A group's epilogue stores its
//     channels at offset 32 g of `out` (pitch out_ch) and adds the anchor to
//     those of them it covers.  Each output element sums tap, k-step, term
//     as the Chp = out_ch wide instance does, which only adds exact zeros
//     past 32 channels: on the same packed stack the two give the same bits.
//     A narrow launch is the case out_ch = Chp, one group.
// What bounds it now (tools/k1_ablation.py, PERF.md): not the bytes.  The
// on-chip route moves 28-36 % of the workspace bytes the device-memory
// route moves, and is 9-11 % faster in fp32 and 1-4 % in bf16 than the
// same kernel with its maps in device memory (1.02-1.04x the parent's
// time); its MMAs cost about a third of the fp32 time, and the rest is the
// loop around them, in which no part switched off alone saves more than
// the stores' 7-8 % (bf16 15-17 %).  Four fragments a warp (B loaded and
// split once for four) ran 18 % slower, and no better with the loops
// rolled; one weight stage was level with two in fp32 and 4 % faster in
// bf16, so the route keeps one.
// Left for later work: layer 0's taps folded into K (its 8 input channels
// padded to a k-step of 8 in fp32 and 16 in bf16 a tap; ROADMAP P4); a
// segment plan without a second wave of fp32 CTAs at 8 frames (P2); a
// wgmma route whose loop around the MMAs is lighter than the one tried; the
// wide instances' feature maps on chip, which at Chp 64-128 do not fit a
// 60-row band's two maps (fp32 Chp 64: 307 KB) without a narrower map or a
// lag-of-two-rows update in place.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kFrags = 2;                         // m16 fragments a warp owns in a block
constexpr int kBlockPix = 16 * kFrags * kWarps;   // 256 output pixels a block
constexpr int kWinPix = 320;                      // window pixels: (30 + 2) x (8 + 2)
constexpr int kMaxLayers = 31;                    // layers a launch (the 31-bit ReLU mask)
constexpr int kEpiChp = 64;                       // the one width built with EPI

struct Params {
  const void* x;       // (B, R, K*C, c0p) fresh input stream, compute dtype
  const void* first;   // (B, R, 1, c0p) first input column of each band
  const void* w;       // (L, 3, 3, out_ch, out_ch) packed weights, compute dtype
  const void* bias;    // (L, out_ch), compute dtype
  const int* bounds;   // (B, 2) valid [lo, hi) rows, or null
  void* out;           // (B, R, K*C, out_ch), compute dtype
  void* ws;            // packed weight stages, then B*S per-CTA workspaces
  int out_ch;          // the last layer's outputs: Chp, or more on a mixed launch
  int R, K, C, c0p, L, W;
  int S, warm;         // segments per band, warm-up tiles of a restarted one
  int relu_mask, add_anchor, in_ch, repeats, replicate;
  int ks0;             // layer 0's k-steps a tap
  int shift0;          // log2 of layer 0's 16-byte copies a window pixel
  int rows_blk;        // output rows of a full row block (the device-memory route)
};

// A wide kernel's second argument, read by an EPI instance only (kept out of
// Params, so that every kernel that takes Params alone compiles as before).
struct Epi {
  const void* res;     // (B, res_rows, W, res_ch) residual, compute dtype, or null
  int res_rows, res_off, res_ch;
  float slope[kMaxLayers];  // an activated layer's leaky slope (0: ReLU)
};

// The schedule of a wide <dtype, Chp> instance (tilted_fusion.py::
// wide_schedule mirrors it, line for line): ng outputs a warp computes in
// one pass over a row block (an n-group; every output of a layer where ng
// = Chp), taps of one weight slice (1, 3 or 9 consecutive taps of one
// n-group), halves (2: a one-tap slice holds half the tap's k-steps, fp32
// only) and resident CTAs an SM it is compiled for (__launch_bounds__).
// Shared memory decides what fits: two slices and the window within
// 232,448 B, and with 2 CTAs an SM within half the SM's 233,472 B less 1
// KB a CTA; registers decide the CTAs.
struct WideSched {
  int ng, taps, halves, ctas;
};
__host__ __device__ constexpr WideSched wide_sched(bool f32, int chp) {
  if (f32 && chp == 48) return {48, 3, 1, 1};
  if (f32 && chp == 64) return {64, 1, 1, 1};
  if (f32 && chp == 96) return {96, 1, 2, 1};
  if (f32 && chp == 128) return {64, 1, 2, 1};
  if (!f32 && chp == 48) return {48, 3, 1, 2};
  if (!f32 && chp == 64) return {32, 3, 1, 2};
  if (!f32 && chp == 96) return {48, 3, 1, 1};
  if (!f32 && chp == 128) return {64, 3, 1, 1};
  return {chp, 9, 1, f32 ? 1 : 2};  // a narrow instance: not read
}

// What each <dtype, Chp> instance holds.  Chp <= 32 ("narrow"): a warp
// computes all Chp outputs, and a stage holds a whole layer.  Chp > 32
// ("wide"): the outputs are cut into n-groups of kNG (wide_sched), and a
// stage holds one slice, the B fragments of kTaps taps of one n-group of a
// layer.
template <typename T, int CHP> struct Cfg {
  static constexpr bool kF32 = sizeof(T) == 4;
  static constexpr bool kWide = CHP > 32;
  static constexpr WideSched kSched = wide_sched(kF32, CHP);
  static constexpr int kNG = !kWide ? CHP : kSched.ng;  // outputs of an n-group
  static constexpr int kGroups = CHP / kNG;
  static constexpr int kNB = kNG / 8;                  // n8 blocks of an n-group's outputs
  static constexpr int kK = kF32 ? 8 : 16;             // the MMA's k
  static constexpr int kKS = CHP / kK;                 // k-steps a tap, layers >= 1
  // B words a lane, (tap, k-step), of a wide slice: fp32 split into TF32 hi
  // and lo words once a launch
  static constexpr int kWords = kF32 ? 4 * kNB : 2 * kNB;
  static constexpr int kQuads = kWords / 4;
  static constexpr int kChunks = CHP * (int)sizeof(T) / 16;       // 16-byte copies a pixel
  // A window (or map) pixel: a whole number of 128 bytes of data (fp32 Chp
  // 32, 64, 96, 128; bf16 64, 128) is stored as it is, its 16-byte chunks
  // swizzled (chunk ^ pixel % 8); 64 bytes (fp32 Chp 16, bf16 Chp 32) too,
  // chunk ^ (pixel / 2) % 4; other pixels are padded by 16 bytes to an odd
  // number of chunks.  Either way the 8 rows of an ldmatrix matrix, 8
  // neighbouring pixels, fall on distinct banks.
  static constexpr int kSwizzle = kChunks % 8 == 0 ? 8 : kChunks == 4 ? 4 : 0;
  static constexpr int kPixBytes = kSwizzle ? 16 * kChunks : 16 * kChunks + 16;
  static constexpr int kWinPix = ::kWinPix;
  // A narrow stage: the bias as fp32, then 9 x kKS (tap, k-step) B blocks of
  // kNQuads uint4 a lane: on the on-chip route fp32 unsplit (split into TF32
  // hi and lo at use), on the device-memory route pre-split (twice the
  // words; bf16 the same on both)
  static constexpr int kNQuads = kNB / 2;
  static constexpr int kStageBytes = CHP * 4 + 9 * kKS * kNQuads * 32 * 16;
  static constexpr int kSplitStageBytes = CHP * 4 + 9 * kKS * (kF32 ? 2 : 1) * kNQuads * 32 * 16;
  static constexpr int kTaps = kWide ? kSched.taps : 9;      // taps of a slice (wide)
  static constexpr int kHalves = kWide ? kSched.halves : 1;  // slices a tap (wide)
  // kTaps x (tap, n-group), or half a tap's k-steps
  static constexpr int kSliceBytes = kTaps * (kKS / kHalves) * kQuads * 32 * 16;
  static constexpr int kWinBytes = kWinPix * kPixBytes;
  // narrow, the device-memory route: two pre-split stages and two windows
  // (the on-chip route's shared memory depends on R: onchip_smem); wide:
  // two slices and one window
  static constexpr int kSmemBytes =
      kWide ? 2 * kSliceBytes + kWinBytes : 2 * kSplitStageBytes + 2 * kWinBytes;
  // narrow fp32 (all registers) one CTA an SM, bf16 two
  static constexpr int kMinBlocks = kWide ? kSched.ctas : kF32 ? 1 : 2;
  static_assert(kWords % 4 == 0, "B words come in uint4");
  static_assert(CHP % kNG == 0 && kNG % 8 == 0 && CHP % kK == 0, "whole n-groups and k-steps");
  static_assert(9 % kTaps == 0, "whole slices");
  static_assert(kHalves == 1 || (kHalves == 2 && kTaps == 1 && kF32 && kKS % 2 == 0),
                "half-tap slices: fp32 (no per-tap bf16 partial across slices), even k-steps");
  static_assert(kSmemBytes <= 232448, "one CTA's shared memory");
  static_assert(kMinBlocks * (kSmemBytes + 1024) <= 233472, "the CTAs an SM it is built for");
};

// What a lane holds of the B fragments over NG outputs, for one (tap,
// k-step) of a narrow stage: a narrow instance's step computes NG = Chp
// outputs, or a last layer's output group of NG = 32 or 16.  Two words an
// n8 block (fp32 values split at use, or bf16 pairs), or with SPLIT (fp32
// on the device-memory route) four, its TF32 hi and lo words.
template <typename T, int NG, bool SPLIT> struct Grp {
  static constexpr int kNB = NG / 8;                              // n8 blocks
  static constexpr int kWords = (SPLIT ? 4 : 2) * kNB;
  static constexpr int kQuads = kWords / 4;
  static_assert(NG % 16 == 0, "B words come in uint4");
};

// The last layer's output groups on a narrow instance: kGroup outputs each,
// the last one the rest (16 where out_ch = 48).  A narrow launch of Chp
// outputs is one group of Chp.
constexpr int kGroup = 32;
__host__ __device__ inline int out_groups(int out_ch) { return (out_ch + kGroup - 1) / kGroup; }
__host__ __device__ inline int group_width(int out_ch, int grp) {
  return out_ch - kGroup * grp < kGroup ? out_ch - kGroup * grp : kGroup;
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes; src_bytes = 0 fills them with zeros
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Four 8x8 b16 matrices from shared memory: lanes 8i..8i+7 give the row
// addresses of matrix i, and matrix i lands in register i.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&a)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(addr));
}

// The TF32 value of fp32 bits, rounded as cvt.rna.tf32.f32 rounds (to
// nearest, ties away from zero; the 13 low mantissa bits cleared) for every
// finite input, in two integer operations.
__device__ __forceinline__ uint32_t tf32_rna(uint32_t bits) {
  return (bits + 0x1000u) & 0xffffe000u;
}

// A TF32 hi and lo of fp32 bits: hi = tf32(a), lo = tf32(a - hi).
__device__ __forceinline__ void tf32_split(uint32_t a, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(a);
  lo = tf32_rna(__float_as_uint(__uint_as_float(a) - __uint_as_float(hi)));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// n / d for the small d of a tile or window: one multiply by a reciprocal
// made once, exact while n d < 2^32 (n below 40 million at d <= 106).
struct FastDiv {
  uint32_t d, m;
  __device__ __forceinline__ explicit FastDiv(int d_) : d(d_), m(0xffffffffu / d_ + 1) {}
  __device__ __forceinline__ int div(int n) const { return (int)__umulhi((uint32_t)n, m); }
};

// Byte offset in a window of 16-byte chunk `chunk` of window pixel `pix`.
template <typename T, int CHP>
__device__ __forceinline__ uint32_t win_off(int pix, int chunk) {
  using G = Cfg<T, CHP>;
  const int c = G::kSwizzle == 8 ? chunk ^ (pix & 7)
                : G::kSwizzle == 4 ? chunk ^ ((pix >> 1) & 3) : chunk;
  return pix * G::kPixBytes + 16 * c;
}

// Four consecutive elements, 16-byte (fp32) or 8-byte (bf16) aligned, as one
// vector store.
__device__ __forceinline__ void store4(float* d, const float (&v)[4]) {
  *reinterpret_cast<float4*>(d) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* d, const __nv_bfloat16 (&v)[4]) {
  const uint16_t* u = reinterpret_cast<const uint16_t*>(v);
  *reinterpret_cast<uint2*>(d) = make_uint2((uint32_t)u[0] | ((uint32_t)u[1] << 16),
                                            (uint32_t)u[2] | ((uint32_t)u[3] << 16));
}

// ---------------------------------------------------------------------------
// Packed weights of a narrow instance: per step i of an own tile (layers
// 0..L-2, then the last layer's output groups), a stage of
// `step_stage_words(i)` 32-bit words, laid out as it sits in shared memory:
// the bias of the step's ng outputs as fp32 (ng words), then the B
// fragments.  uint4 number q of lane `lane` for tap t and k-step s sits at
// ((t * ks_l + s) * quads + q) * 32 + lane, so a warp's 128-bit loads are
// conflict-free.  A lane's words u = 4q + e (two an n8 block) hold, for g =
// lane / 4, tig = lane % 4, n block jb = u / 2, register r = u % 2 and the
// step's first output n0 (32 x its group):
// fp32 on the on-chip route: B[8s + tig + 4r][n0 + 8 jb + g], unsplit (a
//       stage is half the size of a pre-split one, so that it fits beside a
//       74-row band's two maps: the MMAs split B at use, as they split A);
// fp32 on the device-memory route (`split`): u < 2 nb the TF32 hi words,
//       then the lo words, each half as above with jb = (u mod 2 nb) / 2;
// bf16: B[k][n0 + 8 jb + g] (low half) and B[k + 1][n0 + 8 jb + g] with
//       k = 16s + 2 tig + 8r.
// ---------------------------------------------------------------------------
template <typename T>
__host__ __device__ inline int stage_words(int ng, int ks, bool split) {
  return ng + 9 * ks * ((sizeof(T) == 4 && split ? 4 : 2) * (ng / 8) / 4) * 32 * 4;
}

// Step i of an own tile runs layer min(i, L - 1); steps L - 1 on are the
// last layer's output groups.
template <typename T, int CHP>
__host__ __device__ inline int step_stage_words(int i, int L, int ks0, int out_ch, bool split) {
  const int l = i < L - 1 ? i : L - 1;
  return stage_words<T>(i < L - 1 ? CHP : group_width(out_ch, i - l),
                        l == 0 ? ks0 : Cfg<T, CHP>::kKS, split);
}

// Every stage but the last is Chp wide (a hidden layer, or an output group
// of kGroup = Chp on a mixed launch), with ks0 k-steps at layer 0.
template <typename T, int CHP>
__host__ __device__ inline size_t stage_offset(int i, int L, int ks0, bool split) {  // words
  const size_t w0 = stage_words<T>(CHP, ks0, split);
  const size_t w = stage_words<T>(CHP, Cfg<T, CHP>::kKS, split);
  return i == 0 ? 0 : L == 1 ? i * w0 : w0 + (i - 1) * w;
}

// Words of all the stages, the last one (a mixed launch's 16-output group)
// at its own width.
template <typename T, int CHP>
__host__ __device__ inline size_t packed_words(int L, int ks0, int out_ch, bool split) {
  const int last = L - 2 + out_groups(out_ch);
  return stage_offset<T, CHP>(last, L, ks0, split) +
         step_stage_words<T, CHP>(last, L, ks0, out_ch, split);
}

// Wide instances pack slices instead of stages: per layer l, kGroups x 9
// slices in (n-group, tap) order, each ks_l k-steps of kQuads uint4 a lane
// in the same layout as a stage's tap (with n = kNG * group + 8 jb + g), and
// no bias (the epilogue reads it from the launch's bias).
template <typename T, int CHP>
__host__ __device__ inline size_t slice_words(int ks) {
  return (size_t)ks * Cfg<T, CHP>::kQuads * 32 * 4;
}

template <typename T, int CHP>
__host__ __device__ inline size_t slice_offset(int l, int grp, int t, int ks0) {  // in words
  using G = Cfg<T, CHP>;
  const size_t layer0 = G::kGroups * 9 * slice_words<T, CHP>(ks0);
  const size_t head = l == 0 ? 0 : layer0 + (size_t)(l - 1) * G::kGroups * 9 *
                                                slice_words<T, CHP>(G::kKS);
  return head + (size_t)(grp * 9 + t) * slice_words<T, CHP>(l == 0 ? ks0 : G::kKS);
}

// The packed weights of a launch; a narrow instance's stages are split
// (fp32) on the device-memory route.
template <typename T, int CHP>
__host__ __device__ inline size_t packed_bytes(int L, int ks0, int out_ch, bool split) {
  if constexpr (Cfg<T, CHP>::kWide) return 4 * slice_offset<T, CHP>(L, 0, 0, ks0);
  else return 4 * packed_words<T, CHP>(L, ks0, out_ch, split);
}

// A narrow instance's stages (see stage_words) from w (L, 3, 3, out_ch,
// out_ch) and bias (L, out_ch): the hidden layers read their Chp x Chp
// blocks, the last layer its Chp x out_ch block, nothing else.
template <typename T, int CHP>
__global__ void pack_weights_kernel(const T* __restrict__ w, const T* __restrict__ bias,
                                    uint32_t* __restrict__ packed, int L, int ks0, int out_ch,
                                    bool split) {
  using G = Cfg<T, CHP>;
  const int steps = L - 1 + out_groups(out_ch);
  const size_t total = packed_words<T, CHP>(L, ks0, out_ch, split);
  split = split && G::kF32;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    int step = 0;
    while (step + 1 < steps && stage_offset<T, CHP>(step + 1, L, ks0, split) <= i) ++step;
    const size_t base = stage_offset<T, CHP>(step, L, ks0, split);  // the stage's first word
    const int l = step < L - 1 ? step : L - 1, grp = step - l;
    const int ng = step < L - 1 ? CHP : group_width(out_ch, grp), n0 = kGroup * grp;
    const int ks = l == 0 ? ks0 : G::kKS, nb = ng / 8;
    const int quads = (split ? 4 : 2) * nb / 4;
    const int o = (int)(i - base);
    uint32_t v;
    if (o < ng) {
      v = __float_as_uint(to_f(bias[l * out_ch + n0 + o]));
    } else {
      const int word = o - ng;
      const int e = word & 3, lane = (word >> 2) & 31, tsq = word >> 7;
      const int q = tsq % quads, ts = tsq / quads;
      const int t = ts / ks, s = ts % ks;
      const int g = lane >> 2, tig = lane & 3, u = 4 * q + e;
      const T* wt = w + ((size_t)l * 9 + t) * out_ch * out_ch;  // (out_ch, out_ch) of tap t
      if constexpr (G::kF32) {
        const int half = split ? u / (2 * nb) : 0, v2 = split ? u % (2 * nb) : u;
        const int n = n0 + 8 * (v2 >> 1) + g, k = 8 * s + tig + 4 * (v2 & 1);
        v = __float_as_uint(to_f(wt[k * out_ch + n]));
        if (split) {
          uint32_t hi, lo;
          tf32_split(v, hi, lo);
          v = half ? lo : hi;
        }
      } else {
        const int n = n0 + 8 * (u >> 1) + g, k = 16 * s + 2 * tig + 8 * (u & 1);
        const uint16_t* wb = reinterpret_cast<const uint16_t*>(wt);
        v = (uint32_t)wb[k * out_ch + n] | ((uint32_t)wb[(k + 1) * out_ch + n] << 16);
      }
    }
    packed[i] = v;
  }
}

// The wide instances' slices (see slice_offset); the words of a k-step are
// laid out as pack_weights_kernel lays out a stage's.
template <typename T, int CHP>
__global__ void pack_slices_kernel(const T* __restrict__ w, uint32_t* __restrict__ packed,
                                   int L, int ks0) {
  using G = Cfg<T, CHP>;
  const size_t layer0 = slice_offset<T, CHP>(1, 0, 0, ks0);
  const size_t layer = G::kGroups * 9 * slice_words<T, CHP>(G::kKS);
  const size_t total = slice_offset<T, CHP>(L, 0, 0, ks0);
  constexpr int kStepWords = G::kQuads * 32 * 4;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    const int l = i < layer0 ? 0 : 1 + (int)((i - layer0) / layer);
    const size_t o = i < layer0 ? i : (i - layer0) % layer;
    const int ks = l == 0 ? ks0 : G::kKS;
    const int word = (int)(o % kStepWords), gts = (int)(o / kStepWords);
    const int s = gts % ks, gt = gts / ks, t = gt % 9, grp = gt / 9;
    const int e = word & 3, lane = (word >> 2) & 31, q = word >> 7;
    const int g = lane >> 2, tig = lane & 3, u = 4 * q + e;
    const T* wt = w + ((size_t)l * 9 + t) * CHP * CHP;  // (Chp, Chp) of tap t
    uint32_t v;
    if constexpr (G::kF32) {
      const int half = u / (2 * G::kNB), v2 = u % (2 * G::kNB);
      const int n = G::kNG * grp + 8 * (v2 >> 1) + g, k = 8 * s + tig + 4 * (v2 & 1);
      uint32_t hi, lo;
      tf32_split(__float_as_uint(to_f(wt[k * CHP + n])), hi, lo);
      v = half ? lo : hi;
    } else {
      const int n = G::kNG * grp + 8 * (u >> 1) + g, k = 16 * s + 2 * tig + 8 * (u & 1);
      const uint16_t* wb = reinterpret_cast<const uint16_t*>(wt);
      v = (uint32_t)wb[k * CHP + n] | ((uint32_t)wb[(k + 1) * CHP + n] << 16);
    }
    packed[i] = v;
  }
}

// ---------------------------------------------------------------------------
// The fused kernel
// ---------------------------------------------------------------------------
// Elements of one CTA's workspace on the device-memory route (and on a wide
// instance): two slabs (R, C, Chp) and the overlap queue (2, L-1, R, 2, Chp)
// (tilted_fusion.py::workspace_shapes); on the on-chip route the queue alone.
__host__ __device__ inline size_t slab_elems(int chp, int R, int C) {
  return (size_t)R * C * chp;
}
__host__ __device__ inline size_t queue_slot_elems(int chp, int R, int L) {
  return (size_t)(L - 1) * R * 2 * chp;
}
__host__ __device__ inline size_t workspace_elems(int chp, int R, int C, int L) {
  return 2 * slab_elems(chp, R, C) + 2 * queue_slot_elems(chp, R, L);
}
__host__ __device__ inline size_t onchip_workspace_elems(int chp, int R, int L) {
  return 2 * queue_slot_elems(chp, R, L);
}

// The on-chip route's shared memory (tilted_fusion.py::onchip_shared_bytes):
// two maps of R x (C + 2) pixels, each rounded up to 128 bytes, then one
// weight stage, then 16 zero bytes and the stage's mbarrier (in 16).
template <typename T, int CHP>
__host__ __device__ inline int onchip_map_bytes(int R, int C) {
  return (R * (C + 2) * Cfg<T, CHP>::kPixBytes + 127) / 128 * 128;
}
template <typename T, int CHP>
__host__ __device__ inline int onchip_smem(int R, int C) {
  return 2 * onchip_map_bytes<T, CHP>(R, C) + Cfg<T, CHP>::kStageBytes + 32;
}

// Whether the on-chip route of the narrow <T, CHP> instance fits at band
// height R and tile C: within one CTA's 232,448 B for fp32 (one CTA an
// SM), and for bf16 within half the SM's 233,472 B less 1 KB a CTA, so
// that bf16 keeps two CTAs an SM.  The wrapper picks the route
// (tilted_fusion.py::route); a launch checks it here.
template <typename T, int CHP>
__host__ __device__ inline bool onchip_fits(int R, int C) {
  const int budget = Cfg<T, CHP>::kMinBlocks == 1 ? 232448 : 233472 / 2 - 1024;
  return R >= 1 && R <= 1024 && onchip_smem<T, CHP>(R, C) <= budget;
}

// mbarriers and bulk copies (the async proxy), for the on-chip route's
// weight stages.
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%3], %2;\n"
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}
// returns once the barrier's phase `parity` has completed; a wait that has
// not after 2^26 polls (seconds, where a step takes microseconds) traps, so
// that a broken pipeline fails its launch instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .u32 n;\nmov.u32 n, 0;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra DONE;\nadd.u32 n, n, 1;\nsetp.lt.u32 p, n, 67108864;\n@p bra WAIT;\n"
      "trap;\nDONE:\n}\n" ::"r"(bar), "r"(parity) : "memory");
}

// Where step i's packed stage starts (bytes into the workspace) and its
// bytes, split (fp32) or not.
template <typename T, int CHP, bool MIXED>
__device__ __forceinline__ const char* stage_src(const Params& p, int i, bool split, int& bytes) {
  // a narrow launch has one step a layer: stage_offset with L > i
  bytes = 4 * (MIXED ? step_stage_words<T, CHP>(i, p.L, p.ks0, p.out_ch, split)
                     : stage_words<T>(CHP, i == 0 ? p.ks0 : Cfg<T, CHP>::kKS, split));
  return static_cast<const char*>(p.ws) +
         4 * stage_offset<T, CHP>(i, MIXED ? p.L : i + 1, p.ks0, split);
}

// Copy the pre-split packed stage of step i into shared memory (cp.async,
// not committed): the device-memory route.
template <typename T, int CHP, bool MIXED>
__device__ __forceinline__ void load_stage(const Params& p, int i, char* stage) {
  int bytes;
  const char* src = stage_src<T, CHP, MIXED>(p, i, true, bytes);
  const uint32_t dst = smem_addr(stage);
  for (int j = threadIdx.x; j < bytes / 16; j += kThreads)
    cp_async16(dst + 16 * j, src + 16 * j, 16);
}

// What a row block's window copies read: layer 0 reads the input stream
// (column a = kC - 1 + window column; a = 0 is the first column, a < 0 zero),
// layer l >= 1 the carried columns of F_l (queue slot `qin`) and the slab.
struct WindowSrc {
  const char* x;      // layer 0: the band's stream
  const char* first;  // layer 0: the band's first column
  const char* qin;    // layer >= 1: F_l's carried columns (R, 2, Chp)
  const char* slab;   // layer >= 1: F_l's fresh columns (R, C, Chp)
};

template <typename T, int CHP>
__device__ void load_window(const Params& p, const WindowSrc& src, bool layer0, int k, int r0,
                            int rows, const FastDiv& sc, char* win) {
  using G = Cfg<T, CHP>;
  const int C = p.C, SC = C + 2, R = p.R;
  // layer 0 copies the chunks of its padded k (c0p channels, then zeros),
  // rounded up to a power of 2, and the others all of a pixel's
  const int shift = layer0 ? p.shift0 : 31 - __clz(G::kChunks);
  const int chunks = 1 << shift;
  const int data_bytes = layer0 ? p.c0p * (int)sizeof(T) : CHP * (int)sizeof(T);
  const int total = (rows + 2) * SC << shift;
  const uint32_t base = smem_addr(win);
  for (int i = threadIdx.x; i < total; i += kThreads) {
    const int pix = i >> shift, ch = i & (chunks - 1);
    const int wr = sc.div(pix), wc = pix - wr * SC;
    int rr = r0 - 1 + wr;
    bool ok = ch * 16 < data_bytes;
    if (rr < 0 || rr >= R) {
      if (p.replicate) rr = rr < 0 ? 0 : R - 1;
      else ok = false;
    }
    const char* s = src.x;
    if (layer0) {
      const int a = k * C - 1 + wc;
      if (a < 0) ok = false;
      else if (a == 0) s = src.first + (size_t)rr * data_bytes;
      else s = src.x + ((size_t)rr * p.K * C + a - 1) * data_bytes;
    } else {
      s = wc < 2 ? src.qin + ((size_t)rr * 2 + wc) * data_bytes
                 : src.slab + ((size_t)rr * C + wc - 2) * data_bytes;
    }
    cp_async16(base + win_off<T, CHP>(pix, ch), ok ? s + ch * 16 : src.x, ok ? 16 : 0);
  }
}

// The on-chip route's copies into a map (cp.async, not committed): F_0 of
// tile k, R rows of the C + 2 stream columns kC - 1 .. kC + C (as
// load_window's layer 0, without the rows outside the band, which the MMAs
// read as zero or clamp), and the carried columns 0 and 1 of a deeper F_l
// from its queue slot (R, 2, Chp), or zeros at the start of a sweep.
template <typename T, int CHP>
__device__ void load_f0(const Params& p, const char* x, const char* first, int k,
                        const FastDiv& sc, char* map) {
  const int C = p.C, SC = C + 2;
  const int shift = p.shift0, chunks = 1 << shift;
  const int data_bytes = p.c0p * (int)sizeof(T);
  const int total = p.R * SC << shift;
  const uint32_t base = smem_addr(map);
  for (int i = threadIdx.x; i < total; i += kThreads) {
    const int pix = i >> shift, ch = i & (chunks - 1);
    const int r = sc.div(pix), a = k * C - 1 + pix - r * SC;
    const bool ok = ch * 16 < data_bytes && a >= 0;
    const char* s = a == 0 ? first + (size_t)r * data_bytes
                           : x + ((size_t)r * p.K * C + a - 1) * data_bytes;
    cp_async16(base + win_off<T, CHP>(pix, ch), ok ? s + ch * 16 : x, ok ? 16 : 0);
  }
}

template <typename T, int CHP>
__device__ void load_carried(const Params& p, const char* q, bool zero, char* map) {
  constexpr int kChunks = Cfg<T, CHP>::kChunks;  // a power of 2
  const int SC = p.C + 2;
  const int total = p.R * 2 * kChunks;
  const uint32_t base = smem_addr(map);
  for (int i = threadIdx.x; i < total; i += kThreads) {
    const int pix2 = i / kChunks, ch = i % kChunks;  // (row, column) of the slot, chunk
    const int pix = (pix2 >> 1) * SC + (pix2 & 1);
    cp_async16(base + win_off<T, CHP>(pix, ch), zero ? q : q + 16 * i, zero ? 0 : 16);
  }
}

// One block of a step: this warp's NF fragments (block fragments f0,
// f0 + kWarps), the step's NG outputs (all Chp of a hidden layer, or one
// output group of the last layer), then the epilogue.  A block is
// consecutive pixels of the tile, row-major, from pixel st.p0: kBlockPix on
// the on-chip route, a row block's rows on the device-memory one.
// KS > 0: KS k-steps a tap, known when compiling (layers >= 1); 0: st.ks
// (layer 0).  MIXED: the last layer's `out` has out_ch channels, this
// group's from st.n0 on (else Chp, from 0).
//
// ONCHIP (the on-chip route): A from the map `src` at map pixel r (C + 2) +
// j + dx for tap (dy, dx) of output pixel (r, j), row r + dy - 1 clamped
// under `replicate`, or 16 zero bytes (`zero`) outside the band under
// `zero`; a hidden layer's output goes to the map `nxt` (where a next layer
// of the tile reads it, else nowhere) at column j + 2, and its last two
// columns to the queue.  Else (the device-memory route): A from the row
// block's window `src` (rows r0 - 1 .. r0 + rows), the output to the slab
// `nxt` (R, C, Chp) and the queue.
struct Step {
  int k, l, last, relu;  // tile, layer; last layer; ReLU on
  int n0;                // the step's first output channel (32 x its output group)
  int p0, npix;          // the block's first pixel of the tile and its pixels
  int r0;                // the block's first row (the device-memory route's window)
  int lo, hi, mask_rows;
  int ks;                // k-steps a tap
};

// One k-step's MMAs over NF fragments and NG outputs: B from the stage
// (ts = t * ks + s), A given.  fp32 as 3xTF32: A (and B unless SPLIT, a
// pre-split stage) split into TF32 hi and lo here, summed lo*hi + hi*lo +
// hi*hi, small terms first.
template <typename T, int NG, int NF, bool SPLIT>
__device__ __forceinline__ void kstep_mma(const uint4* bsm, int ts, const uint32_t (&a)[NF][4],
                                          float (&d)[NF][NG / 8][4]) {
  using N = Grp<T, NG, SPLIT>;
  constexpr int kB = 2 * N::kNB;  // B's hi (and lo) words
  const int lane = threadIdx.x & 31;
  uint32_t bw[N::kWords];
#pragma unroll
  for (int q = 0; q < N::kQuads; ++q) {
    const uint4 v = bsm[(ts * N::kQuads + q) * 32 + lane];
    bw[4 * q] = v.x; bw[4 * q + 1] = v.y; bw[4 * q + 2] = v.z; bw[4 * q + 3] = v.w;
  }
  if constexpr (sizeof(T) == 4) {
    uint32_t ah[NF][4], al[NF][4], bh[kB], bl[kB];
#pragma unroll
    for (int f = 0; f < NF; ++f)
#pragma unroll
      for (int c = 0; c < 4; ++c) tf32_split(a[f][c], ah[f][c], al[f][c]);
#pragma unroll
    for (int u = 0; u < kB; ++u) {
      if constexpr (SPLIT) {
        bh[u] = bw[u];
        bl[u] = bw[kB + u];
      } else {
        tf32_split(bw[u], bh[u], bl[u]);
      }
    }
#pragma unroll
    for (int f = 0; f < NF; ++f)
#pragma unroll
      for (int jb = 0; jb < N::kNB; ++jb) mma_tf32(d[f][jb], al[f], bh[2 * jb], bh[2 * jb + 1]);
#pragma unroll
    for (int f = 0; f < NF; ++f)
#pragma unroll
      for (int jb = 0; jb < N::kNB; ++jb) mma_tf32(d[f][jb], ah[f], bl[2 * jb], bl[2 * jb + 1]);
#pragma unroll
    for (int f = 0; f < NF; ++f)
#pragma unroll
      for (int jb = 0; jb < N::kNB; ++jb) mma_tf32(d[f][jb], ah[f], bh[2 * jb], bh[2 * jb + 1]);
  } else {
#pragma unroll
    for (int f = 0; f < NF; ++f)
#pragma unroll
      for (int jb = 0; jb < N::kNB; ++jb) mma_bf16(d[f][jb], a[f], bw[2 * jb], bw[2 * jb + 1]);
  }
}

// The epilogue of one m16 fragment whose first pixel is fpx (from st.p0):
// bias (fp32, from bsh), ReLU, phantom-column and phantom-row masks, one
// rounding.  Accumulator c of n block jb holds pixel g + 8 (c >> 1), output
// channel 8 jb + 2 tig + (c & 1).  Lanes tig and tig ^ 1 swap halves, so
// that an even lane holds 4 consecutive channels of pixel g and an odd lane
// those of pixel g + 8: one 16-byte (bf16: 8-byte) store.  ONCHIP: a hidden
// layer's output goes to the map `nxt` (where a next layer of the tile reads
// it, else nowhere) at column j + 2; else to the slab `nxt` (R, C, Chp);
// its last two columns to the queue either way.
template <typename T, int CHP, bool MIXED, bool ONCHIP, int NG>
__device__ __forceinline__ void store_fragment(const Params& p, const Step& st,
                                               const float (&acc)[NG / 8][4], int fpx,
                                               const float* bsh, char* nxt, T* qout, T* out,
                                               const T* x, const T* first) {
  const int lane = threadIdx.x & 31, g = lane >> 2, tig = lane & 3;
  const int C = p.C, SC = C + 2;
  const int KC = p.K * C;
  const FastDiv cdiv(C);  // a pixel's row (dividing was 1-3 % slower: k1_ablation div_c)
  const int odd = tig & 1;
  bool keep[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int px = fpx + g + 8 * h;
    const int r = cdiv.div(st.p0 + px), j = st.p0 + px - r * C;
    const int acol = st.k * C - st.l + j;  // absolute column of this output
    keep[h] = px < st.npix && acol >= 0 && acol < p.W &&
              (!st.mask_rows || (r >= st.lo && r < st.hi));
  }
  // this lane's pixel after the swap, and where its 4 channels start
  const int px = fpx + g + 8 * odd;
  const int r = cdiv.div(st.p0 + px), j = st.p0 + px - r * C;
  const int acol = st.k * C - st.l + j;
#pragma unroll
  for (int jb = 0; jb < NG / 8; ++jb) {
    const int co = 8 * jb + 2 * tig;
    const float2 bv = *reinterpret_cast<const float2*>(bsh + co);
    float y[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      float v = acc[jb][c] + (c & 1 ? bv.y : bv.x);
      if (st.relu) v = fmaxf(v, 0.f);
      y[c] = to_f(from_f<T>(keep[c >> 1] ? v : 0.f));  // rounded once, exact in fp32
    }
    // an even lane sends its pixel g + 8 pair and keeps pixel g's
    const float s0 = odd ? y[0] : y[2], s1 = odd ? y[1] : y[3];
    const float t0 = __shfl_xor_sync(0xffffffffu, s0, 1);
    const float t1 = __shfl_xor_sync(0xffffffffu, s1, 1);
    T v[4];
    if (odd) {
      v[0] = from_f<T>(t0); v[1] = from_f<T>(t1);
      v[2] = from_f<T>(y[2]); v[3] = from_f<T>(y[3]);
    } else {
      v[0] = from_f<T>(y[0]); v[1] = from_f<T>(y[1]);
      v[2] = from_f<T>(t0); v[3] = from_f<T>(t1);
    }
    if (px >= st.npix) continue;
    const int c4 = co - 2 * odd;  // the first of this lane's 4 channels
    if (!st.last) {
      if constexpr (ONCHIP) {
        if (nxt) {
          const int cb = c4 * (int)sizeof(T);  // byte of the pixel: chunk, then within it
          store4(reinterpret_cast<T*>(nxt + win_off<T, CHP>(r * SC + j + 2, cb >> 4) +
                                      (cb & 15)), v);
        }
      } else {
        store4(reinterpret_cast<T*>(nxt) + ((size_t)r * C + j) * CHP + c4, v);
      }
      if (j >= C - 2)  // F_{l+1}'s last two columns: tile k+1's carried ones
        store4(qout + ((size_t)r * 2 + j - (C - 2)) * CHP + c4, v);
    } else {
      const int co4 = MIXED ? st.n0 + c4 : c4;  // a group's channels start at n0
      if (p.add_anchor && acol >= 0 && acol < p.W) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (co4 + e < p.in_ch * p.repeats) {
            const int c = (co4 + e) / p.repeats;
            const T a = acol == 0 ? first[r * p.c0p + c]
                                  : x[((size_t)r * KC + acol - 1) * p.c0p + c];
            v[e] = from_f<T>(to_f(v[e]) + to_f(a));
          }
        }
      }
      store4(out + ((size_t)r * KC + st.k * C + j) * (MIXED ? p.out_ch : CHP) + co4, v);
    }
  }
}

template <typename T, int CHP, bool MIXED, bool ONCHIP, int NG, int NF, int KS>
__device__ __forceinline__ void block_mma(const Params& p, const Step& st, const char* stage,
                                          const char* src, uint32_t zero, int f0, char* nxt,
                                          T* qout, T* out, const T* x, const T* first) {
  constexpr bool kSplit = sizeof(T) == 4 && !ONCHIP;  // the device-memory route's stages
  using N = Grp<T, NG, kSplit>;
  const int lane = threadIdx.x & 31;
  const int C = p.C, SC = C + 2, R = p.R;
  const FastDiv cdiv(C);
  const uint32_t src_addr = smem_addr(src);
  const uint4* bsm = reinterpret_cast<const uint4*>(stage + NG * 4);
  // this lane's ldmatrix row, per fragment: row m = (lane & 7) + 8 ((lane
  // >> 3) & 1) of the fragment, chunk 2s + (lane >> 4) of k-step s; a pixel
  // past the block reads the last one.  rowpix: the source pixel of tap (dy,
  // 0), -1 where it reads zeros.
  int rowpix[NF][3];
#pragma unroll
  for (int f = 0; f < NF; ++f) {
    int px = 16 * (f0 + f * kWarps) + (lane & 7) + 8 * ((lane >> 3) & 1);
    px = st.p0 + (px < st.npix ? px : st.npix - 1);
    const int r = cdiv.div(px), j = px - r * C;
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
      if constexpr (ONCHIP) {
        int rr = r + dy - 1;
        const bool out_of_band = rr < 0 || rr >= R;
        if (p.replicate) rr = rr < 0 ? 0 : rr >= R ? R - 1 : rr;
        rowpix[f][dy] = out_of_band && !p.replicate ? -1 : rr * SC + j;
      } else {
        rowpix[f][dy] = (r - st.r0 + dy) * SC + j;
      }
    }
  }
  const int khalf = lane >> 4;
  float acc[NF][N::kNB][4];
#pragma unroll
  for (int f = 0; f < NF; ++f)
#pragma unroll
    for (int jb = 0; jb < N::kNB; ++jb)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[f][jb][c] = 0.f;

  // one k-step s of tap (dy, dx): A by ldmatrix, B from the stage, the MMAs
  // into d
  const int ks = KS > 0 ? KS : st.ks;
  auto kstep = [&](int dy, int dx, int s, float (&d)[NF][N::kNB][4]) {
    uint32_t a[NF][4];
#pragma unroll
    for (int f = 0; f < NF; ++f) {
      // (selected, not indexed: dy is not known when compiling)
      const int rp = dy == 0 ? rowpix[f][0] : dy == 1 ? rowpix[f][1] : rowpix[f][2];
      const uint32_t addr = ONCHIP && rp < 0 ? zero
                                             : src_addr + win_off<T, CHP>(rp + dx, 2 * s + khalf);
      ldmatrix_x4(a[f], addr);
    }
    kstep_mma<T, NG, NF, kSplit>(bsm, (dy * 3 + dx) * ks + s, a, d);
  };
  // Tap t's k-steps.  fp32: into the accumulator.  bf16: into a partial
  // that starts at zero, then added to the accumulator in fp32, tap by tap
  // as the plain version adds its nine products.  One accumulator carried
  // through all 9 x ks bf16 MMAs rounds about twice as many outputs of a
  // 28 -> 28 layer away from the exact value as the plain version does
  // (tools/k1_bf16_rounding.py).
  auto tap = [&](int dy, int dx) {
    if constexpr (sizeof(T) == 4) {
      if constexpr (KS > 0) {
#pragma unroll
        for (int s = 0; s < KS; ++s) kstep(dy, dx, s, acc);
      } else {
#pragma unroll 1
        for (int s = 0; s < ks; ++s) kstep(dy, dx, s, acc);
      }
    } else {
      float part[NF][N::kNB][4];
#pragma unroll
      for (int f = 0; f < NF; ++f)
#pragma unroll
        for (int jb = 0; jb < N::kNB; ++jb)
#pragma unroll
          for (int c = 0; c < 4; ++c) part[f][jb][c] = 0.f;
      if constexpr (KS > 0) {
#pragma unroll
        for (int s = 0; s < KS; ++s) kstep(dy, dx, s, part);
      } else {
#pragma unroll 1
        for (int s = 0; s < ks; ++s) kstep(dy, dx, s, part);
      }
#pragma unroll
      for (int f = 0; f < NF; ++f)
#pragma unroll
        for (int jb = 0; jb < N::kNB; ++jb)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[f][jb][c] += part[f][jb][c];
    }
  };
  // a tap row's 3 taps unrolled, so that the loads of one k-step are
  // issued ahead of the MMAs of the one before
#pragma unroll 1
  for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) tap(dy, dx);
  }

  const float* bsh = reinterpret_cast<const float*>(stage);
#pragma unroll
  for (int f = 0; f < NF; ++f)
    store_fragment<T, CHP, MIXED, ONCHIP, NG>(p, st, acc[f], 16 * (f0 + f * kWarps), bsh, nxt,
                                               qout, out, x, first);
}

// One block of a step over the step's NG outputs, in this warp's one or
// two fragments (none where the block has fewer).
template <typename T, int CHP, bool MIXED, bool ONCHIP, int NG>
__device__ __forceinline__ void run_block(const Params& p, const Step& st, const char* stage,
                                          const char* src, uint32_t zero, int warp, int nf,
                                          char* nxt, T* qout, T* out, const T* x, const T* first) {
  constexpr int KS = Cfg<T, CHP>::kKS;
  if (warp + kWarps < nf) {
    if (st.l > 0)
      block_mma<T, CHP, MIXED, ONCHIP, NG, 2, KS>(p, st, stage, src, zero, warp, nxt, qout, out,
                                                  x, first);
    else
      block_mma<T, CHP, MIXED, ONCHIP, NG, 2, 0>(p, st, stage, src, zero, warp, nxt, qout, out,
                                                 x, first);
  } else if (warp < nf) {
    if (st.l > 0)
      block_mma<T, CHP, MIXED, ONCHIP, NG, 1, KS>(p, st, stage, src, zero, warp, nxt, qout, out,
                                                  x, first);
    else
      block_mma<T, CHP, MIXED, ONCHIP, NG, 1, 0>(p, st, stage, src, zero, warp, nxt, qout, out,
                                                 x, first);
  }
}

// A step's blocks: the step's NG outputs, or on a mixed launch's last
// group of 16 outputs 16.
template <typename T, int CHP, bool MIXED, bool ONCHIP>
__device__ __forceinline__ void run_step_block(const Params& p, const Step& st, int group,
                                               const char* stage, const char* src, uint32_t zero,
                                               int warp, char* nxt, T* qout, T* out, const T* x,
                                               const T* first) {
  const int nf = (st.npix + 15) / 16;
  if constexpr (MIXED) {
    if (st.last && group_width(p.out_ch, group) < CHP) {
      run_block<T, CHP, true, ONCHIP, 16>(p, st, stage, src, zero, warp, nf, nxt, qout, out, x,
                                          first);
      return;
    }
  }
  run_block<T, CHP, MIXED, ONCHIP, CHP>(p, st, stage, src, zero, warp, nf, nxt, qout, out, x,
                                        first);
}

// The steps of tile k (own tiles k >= k0, warm-up tiles before): step i runs
// layer min(i, L - 1), the last layer once an output group on a mixed
// launch.  A warm-up tile runs layers 0..L-2 only: layer L-1's output is not
// carried, and a warm-up tile stores nothing.
__device__ __forceinline__ int tile_steps(const Params& p, bool own, bool mixed) {
  return !own ? p.L - 1 : mixed ? p.L - 1 + out_groups(p.out_ch) : p.L;
}

// The device-memory route (bands whose maps do not fit shared memory): each
// layer's output goes to a slab in device memory and comes back as the next
// layer's window, a row block at a time.  MIXED: a mixed launch (Chp 32,
// out_ch > 32 outputs in output groups); else every step computes Chp
// outputs and the last layer is one step.
template <typename T, int CHP, bool MIXED>
__global__ void __launch_bounds__(kThreads, Cfg<T, CHP>::kMinBlocks)
tilted_fusion_kernel(Params p) {
  using G = Cfg<T, CHP>;
  extern __shared__ uint4 smem[];
  char* stages = reinterpret_cast<char*>(smem);  // 2 x kSplitStageBytes
  char* wins = stages + 2 * G::kSplitStageBytes;  // 2 x kWinBytes

  const int cta = blockIdx.x;  // band * S + segment
  const int band = cta / p.S, seg = cta % p.S;
  const int tid = threadIdx.x, warp = tid >> 5;
  const int R = p.R, K = p.K, C = p.C, L = p.L;
  const int KC = K * C;
  // This segment's own tiles [k0, k1) and the tile kw its sweep starts at.
  const int k0 = (int)((long long)seg * K / p.S);
  const int k1 = (int)((long long)(seg + 1) * K / p.S);
  const int kw = k0 >= p.warm ? k0 - p.warm : 0;

  T* ws = reinterpret_cast<T*>(static_cast<char*>(p.ws) +
                               packed_bytes<T, CHP>(L, p.ks0, MIXED ? p.out_ch : CHP, true)) +
          (size_t)cta * workspace_elems(CHP, R, C, L);
  T* slab[2] = {ws, ws + slab_elems(CHP, R, C)};
  T* queue = ws + 2 * slab_elems(CHP, R, C);  // (2, L-1, R, 2, CHP)
  const size_t qslot = (size_t)R * 2 * CHP, qpar = queue_slot_elems(CHP, R, L);
  const T* x = static_cast<const T*>(p.x) + (size_t)band * R * KC * p.c0p;
  const T* first = static_cast<const T*>(p.first) + (size_t)band * R * p.c0p;
  T* out = static_cast<T*>(p.out) + (size_t)band * R * KC * (MIXED ? p.out_ch : CHP);

  Step st;
  st.mask_rows = p.bounds != nullptr;
  st.lo = st.mask_rows ? p.bounds[2 * band] : 0;
  st.hi = st.mask_rows ? p.bounds[2 * band + 1] : R;
  st.n0 = 0;

  // Start of the sweep at tile kw: every carried column of F_1..F_{L-1}
  // zero (F_0 is read from the stream).  For kw = 0 that is the band start.
  {
    uint4* q = reinterpret_cast<uint4*>(queue + (kw & 1) * qpar);
    const int n16 = (int)(qpar * sizeof(T) / 16);
    for (int i = tid; i < n16; i += kThreads) q[i] = make_uint4(0, 0, 0, 0);
  }
  load_stage<T, CHP, MIXED>(p, 0, stages);
  cp_async_commit();

  const int nblk = (R + p.rows_blk - 1) / p.rows_blk;
  const FastDiv sc(C + 2);
  int step = 0;  // steps run: the weights of step s sit in stage s & 1
  for (int k = kw; k < k1; ++k) {
    const int ns = tile_steps(p, k >= k0, MIXED);
    for (int i = 0; i < ns; ++i, ++step) {
      const int l = MIXED && i > L - 1 ? L - 1 : i;
      const char* stage = stages + (step & 1) * G::kSplitStageBytes;
      const bool has_next = !(i == ns - 1 && k == k1 - 1);
      st.k = k; st.l = l; st.last = l == L - 1; st.relu = (p.relu_mask >> l) & 1;
      if constexpr (MIXED) st.n0 = kGroup * (i - l);
      st.ks = l == 0 ? p.ks0 : G::kKS;
      WindowSrc src;
      src.x = reinterpret_cast<const char*>(x);
      src.first = reinterpret_cast<const char*>(first);
      src.qin = l > 0 ? reinterpret_cast<const char*>(queue + (k & 1) * qpar + (l - 1) * qslot)
                      : nullptr;
      src.slab = l > 0 ? reinterpret_cast<const char*>(slab[(l - 1) & 1]) : nullptr;
      char* nxt = reinterpret_cast<char*>(slab[l & 1]);
      T* qout = st.last ? nullptr : queue + ((k + 1) & 1) * qpar + l * qslot;
      // Row block b computes from window b & 1; the window of block b + 1
      // is copied while block b computes (a step's block 0 reads what the
      // step before it wrote, so it waits for its own).
      for (int b = 0; b < nblk; ++b) {
        st.r0 = b * p.rows_blk;
        st.p0 = st.r0 * C;
        st.npix = min(p.rows_blk, R - st.r0) * C;
        // the other window and the other stage are free; the last
        // epilogue's stores are visible to this CTA
        __syncthreads();
        if (b == 0) {
          load_window<T, CHP>(p, src, l == 0, k, 0, min(p.rows_blk, R), sc, wins);
          cp_async_commit();
          if (has_next)  // the next step's weights, a step ahead
            load_stage<T, CHP, MIXED>(p, i + 1 < ns ? i + 1 : 0,
                                      stages + ((step + 1) & 1) * G::kSplitStageBytes);
          cp_async_commit();
        }
        const bool ahead = b + 1 < nblk;
        if (ahead) {
          const int r1 = (b + 1) * p.rows_blk;
          load_window<T, CHP>(p, src, l == 0, k, r1, min(p.rows_blk, R - r1), sc,
                              wins + ((b + 1) & 1) * G::kWinBytes);
          cp_async_commit();
        }
        // groups newer than the ones this block needs: at b = 0 the next
        // stage (and window 1), later window b + 1
        if (b == 0) {
          if (ahead) cp_async_wait<2>(); else cp_async_wait<1>();
        } else {
          if (ahead) cp_async_wait<1>(); else cp_async_wait<0>();
        }
        __syncthreads();
        run_step_block<T, CHP, MIXED, false>(p, st, i - l, stage, wins + (b & 1) * G::kWinBytes,
                                             0, warp, nxt, qout, out, x, first);
      }
    }
  }
  cp_async_wait<0>();
}

// The on-chip route (every band whose two maps fit: onchip_fits): a tile's
// feature maps stay in shared memory from one layer to the next, as the TPU
// kernel keeps them in VMEM.  Two maps of R x (C + 2) pixels: the layer
// steps of a sweep take turns, F_l of the tile's step g (the sweep's layer
// steps before it plus l) sits in map g & 1, columns 0 and 1 the two
// carried from tile k - 1 and 2 .. C + 1 the C fresh ones, and layer l
// writes F_{l+1} into the other map.  A step's blocks are kBlockPix
// consecutive pixels of the tile; nothing is copied between them, so a
// step has one barrier.  What still moves:
//   * F_0 of tile k + 1 (cp.async, from the stream) into the map the tile's
//     last layer does not read, at that layer's first step, so that it lands
//     behind its MMAs (a tile whose F_0 was not copied ahead, the first of a
//     sweep or one after a warm-up tile of one layer, waits for it);
//   * F_{l+1}'s carried columns (cp.async, from the overlap queue in device
//     memory, zeros at the start of a sweep) into columns 0 and 1 of the map
//     layer l writes, at layer l's step, and layer l's last two output
//     columns to the queue (two of C + 2 columns: the queue does not fit
//     beside the maps in fp32);
//   * the weights: the step's stage, by one bulk copy at the step's start,
//     completed on the stage's mbarrier, while the step's other copies are
//     issued; the barrier that ends a step frees the stage for the next.
template <typename T, int CHP, bool MIXED>
__global__ void __launch_bounds__(kThreads, Cfg<T, CHP>::kMinBlocks)
tilted_fusion_kernel_onchip(Params p) {
  using G = Cfg<T, CHP>;
  extern __shared__ uint4 smem[];
  char* sm = reinterpret_cast<char*>(smem);
  const int mapb = onchip_map_bytes<T, CHP>(p.R, p.C);
  char* maps[2] = {sm, sm + mapb};
  char* stage = sm + 2 * mapb;  // kStageBytes
  char* tail = stage + G::kStageBytes;
  const uint32_t zero = smem_addr(tail);      // 16 zero bytes
  const uint32_t bar = smem_addr(tail + 16);  // the stage's mbarrier

  const int cta = blockIdx.x;  // band * S + segment
  const int band = cta / p.S, seg = cta % p.S;
  const int tid = threadIdx.x, warp = tid >> 5;
  const int R = p.R, K = p.K, C = p.C, L = p.L;
  const int KC = K * C;
  const int k0 = (int)((long long)seg * K / p.S);
  const int k1 = (int)((long long)(seg + 1) * K / p.S);
  const int kw = k0 >= p.warm ? k0 - p.warm : 0;

  T* queue = reinterpret_cast<T*>(static_cast<char*>(p.ws) +
                                  packed_bytes<T, CHP>(L, p.ks0, MIXED ? p.out_ch : CHP, false)) +
             (size_t)cta * onchip_workspace_elems(CHP, R, L);  // (2, L-1, R, 2, CHP)
  const size_t qslot = (size_t)R * 2 * CHP, qpar = queue_slot_elems(CHP, R, L);
  const T* x = static_cast<const T*>(p.x) + (size_t)band * R * KC * p.c0p;
  const T* first = static_cast<const T*>(p.first) + (size_t)band * R * p.c0p;
  T* out = static_cast<T*>(p.out) + (size_t)band * R * KC * (MIXED ? p.out_ch : CHP);
  const char* xc = reinterpret_cast<const char*>(x);
  const char* fc = reinterpret_cast<const char*>(first);

  Step st;
  st.mask_rows = p.bounds != nullptr;
  st.lo = st.mask_rows ? p.bounds[2 * band] : 0;
  st.hi = st.mask_rows ? p.bounds[2 * band + 1] : R;
  st.n0 = 0;
  st.r0 = 0;

  if (tid == 0) {
    *reinterpret_cast<uint4*>(tail) = make_uint4(0, 0, 0, 0);
    mbar_init(bar, 1);
    mbar_init_fence();
  }
  __syncthreads();
  int uses = 0;  // steps run: the mbarrier's phases

  const int npix = R * C, nblk = (npix + kBlockPix - 1) / kBlockPix;
  const FastDiv sc(C + 2);
  bool f0_ready = false;  // F_0 of tile k was copied during tile k - 1
  int base = 0;           // the sweep's layer steps before tile k
  for (int k = kw; k < k1; ++k) {
    const bool own = k >= k0;
    const int nl = own ? L : L - 1;  // layers this tile runs
    const int ns = tile_steps(p, own, MIXED);
    for (int i = 0; i < ns; ++i) {
      const int l = MIXED && i > L - 1 ? L - 1 : i;
      // the last step's maps and queue columns, and the copies it waited
      // for, are visible; the stage is free
      __syncthreads();
      if (tid == 0) {  // this step's weights
        int bytes;
        const char* wsrc = stage_src<T, CHP, MIXED>(p, i, false, bytes);
        bulk_copy(smem_addr(stage), wsrc, bytes, bar);
      }
      if (i == 0 && !f0_ready) {
        load_f0<T, CHP>(p, xc, fc, k, sc, maps[base & 1]);
        cp_async_commit();
        cp_async_wait<0>();
        __syncthreads();
      }
      if (i == l) {  // a layer's first step
        if (l + 1 < nl)  // the carried columns of the map this layer writes
          load_carried<T, CHP>(p, reinterpret_cast<const char*>(queue + (k & 1) * qpar +
                                                                l * qslot),
                               k == kw, maps[(base + l + 1) & 1]);
        f0_ready = l == nl - 1 && k + 1 < k1;
        if (f0_ready)  // the next tile's F_0, into the map this layer does not read
          load_f0<T, CHP>(p, xc, fc, k + 1, sc, maps[(base + nl) & 1]);
        cp_async_commit();
      }
      st.k = k; st.l = l; st.last = l == L - 1; st.relu = (p.relu_mask >> l) & 1;
      if constexpr (MIXED) st.n0 = kGroup * (i - l);
      st.ks = l == 0 ? p.ks0 : G::kKS;
      const char* src = maps[(base + l) & 1];
      char* nxt = l + 1 < nl ? maps[(base + l + 1) & 1] : nullptr;
      T* qout = st.last ? nullptr : queue + ((k + 1) & 1) * qpar + l * qslot;
      mbar_wait(bar, uses++ & 1);
      for (int b = 0; b < nblk; ++b) {
        st.p0 = b * kBlockPix;
        st.npix = min(kBlockPix, npix - st.p0);
        run_step_block<T, CHP, MIXED, true>(p, st, i - l, stage, src, zero, warp, nxt, qout, out,
                                            x, first);
      }
      cp_async_wait<0>();  // this step's copies landed (the next barrier publishes them)
    }
    base += nl;
  }
}

// ---------------------------------------------------------------------------
// The wide instances (Chp > 32)
// ---------------------------------------------------------------------------
// A row block's window for a wide instance: as load_window, with chunk
// counts that need not be powers of 2 (layer 0 copies the 2 ks0 chunks of its
// padded k, c0p channels then zeros; the others all kChunks of a pixel).
template <typename T, int CHP>
__device__ void load_window_wide(const Params& p, const WindowSrc& src, bool layer0, int k,
                                 int r0, int rows, const FastDiv& sc, char* win) {
  using G = Cfg<T, CHP>;
  const int C = p.C, SC = C + 2, R = p.R;
  const int chunks = layer0 ? 2 * p.ks0 : G::kChunks;
  const FastDiv cd(chunks);
  const int data_bytes = layer0 ? p.c0p * (int)sizeof(T) : CHP * (int)sizeof(T);
  const int total = (rows + 2) * SC * chunks;
  const uint32_t base = smem_addr(win);
  for (int i = threadIdx.x; i < total; i += kThreads) {
    const int pix = cd.div(i), ch = i - pix * chunks;
    const int wr = sc.div(pix), wc = pix - wr * SC;
    int rr = r0 - 1 + wr;
    bool ok = ch * 16 < data_bytes;
    if (rr < 0 || rr >= R) {
      if (p.replicate) rr = rr < 0 ? 0 : R - 1;
      else ok = false;
    }
    const char* s = src.x;
    if (layer0) {
      const int a = k * C - 1 + wc;
      if (a < 0) ok = false;
      else if (a == 0) s = src.first + (size_t)rr * data_bytes;
      else s = src.x + ((size_t)rr * p.K * C + a - 1) * data_bytes;
    } else {
      s = wc < 2 ? src.qin + ((size_t)rr * 2 + wc) * data_bytes
                 : src.slab + ((size_t)rr * C + wc - 2) * data_bytes;
    }
    cp_async16(base + win_off<T, CHP>(pix, ch), ok ? s + ch * 16 : src.x, ok ? 16 : 0);
  }
}

// The k-steps [s0, s0 + n) of piece h of a tap of ks k-steps: the whole tap
// (one piece), or one of its two halves.
template <typename T, int CHP>
__device__ __forceinline__ int piece_steps(int ks, int h, int& s0) {
  if (Cfg<T, CHP>::kHalves == 1) {
    s0 = 0;
    return ks;
  }
  const int half = (ks + 1) / 2;
  s0 = h * half;
  return min(ks, s0 + half) - s0;
}

// Copy slice j of layer l's n-group grp into shared memory (cp.async, not
// committed): taps t..t + kTaps - 1 (t = kTaps * j), which lie one after
// another in the packed weights, or piece j % 2 of tap j / 2.
template <typename T, int CHP>
__device__ __forceinline__ void load_slice(const Params& p, int l, int grp, int j, char* dst) {
  using G = Cfg<T, CHP>;
  const int ks = l == 0 ? p.ks0 : G::kKS;
  int s0;
  const int n = piece_steps<T, CHP>(ks, j % G::kHalves, s0);
  const char* src = static_cast<const char*>(p.ws) +
                    4 * (slice_offset<T, CHP>(l, grp, j / G::kHalves * G::kTaps, p.ks0) +
                         (size_t)s0 * G::kQuads * 32 * 4);
  const int n16 = (G::kHalves == 1 ? G::kTaps * ks : n) * G::kQuads * 32;
  const uint32_t base = smem_addr(dst);
  for (int i = threadIdx.x; i < n16; i += kThreads) cp_async16(base + 16 * i, src + 16 * i, 16);
}

// K-steps s0 .. s0 + n - 1 of one tap of one n-group over this warp's NF
// fragments (n = KS where KS > 0, layers >= 1; else n_rt, layer 0): B from
// `slice`, which holds them from its start, A by ldmatrix from the window at
// offset tpix.  fp32 into acc; bf16 (whole taps, s0 = 0) into a partial that
// starts at zero and is then added to acc in fp32, as block_mma sums them.
template <typename T, int CHP, int NF, int KS>
__device__ __forceinline__ void wide_tap(const char* slice, uint32_t win_addr,
                                         const int (&wpix)[2], int tpix, int s0, int n_rt,
                                         float (&acc)[2][Cfg<T, CHP>::kNB][4]) {
  using G = Cfg<T, CHP>;
  const int lane = threadIdx.x & 31, khalf = lane >> 4;
  const uint4* bsm = reinterpret_cast<const uint4*>(slice);
  const int n = KS > 0 ? KS : n_rt;
  float part[NF][G::kNB][4];
#pragma unroll
  for (int f = 0; f < NF; ++f)
#pragma unroll
    for (int jb = 0; jb < G::kNB; ++jb)
#pragma unroll
      for (int c = 0; c < 4; ++c) part[f][jb][c] = G::kF32 ? acc[f][jb][c] : 0.f;
  auto kstep = [&](int i) {
    uint32_t bw[G::kWords];
#pragma unroll
    for (int q = 0; q < G::kQuads; ++q) {
      const uint4 v = bsm[(i * G::kQuads + q) * 32 + lane];
      bw[4 * q] = v.x; bw[4 * q + 1] = v.y; bw[4 * q + 2] = v.z; bw[4 * q + 3] = v.w;
    }
    uint32_t a[NF][4];
#pragma unroll
    for (int f = 0; f < NF; ++f)
      ldmatrix_x4(a[f], win_addr + win_off<T, CHP>(wpix[f] + tpix, 2 * (s0 + i) + khalf));
    if constexpr (G::kF32) {
      uint32_t ah[NF][4], al[NF][4];
#pragma unroll
      for (int f = 0; f < NF; ++f)
#pragma unroll
        for (int c = 0; c < 4; ++c) tf32_split(a[f][c], ah[f][c], al[f][c]);
      constexpr int LO = 2 * G::kNB;  // the lo words of B
#pragma unroll
      for (int f = 0; f < NF; ++f)
#pragma unroll
        for (int jb = 0; jb < G::kNB; ++jb)
          mma_tf32(part[f][jb], al[f], bw[2 * jb], bw[2 * jb + 1]);
#pragma unroll
      for (int f = 0; f < NF; ++f)
#pragma unroll
        for (int jb = 0; jb < G::kNB; ++jb)
          mma_tf32(part[f][jb], ah[f], bw[LO + 2 * jb], bw[LO + 2 * jb + 1]);
#pragma unroll
      for (int f = 0; f < NF; ++f)
#pragma unroll
        for (int jb = 0; jb < G::kNB; ++jb)
          mma_tf32(part[f][jb], ah[f], bw[2 * jb], bw[2 * jb + 1]);
    } else {
#pragma unroll
      for (int f = 0; f < NF; ++f)
#pragma unroll
        for (int jb = 0; jb < G::kNB; ++jb)
          mma_bf16(part[f][jb], a[f], bw[2 * jb], bw[2 * jb + 1]);
    }
  };
  if constexpr (KS > 0) {
#pragma unroll
    for (int i = 0; i < KS; ++i) kstep(i);
  } else {
#pragma unroll 1
    for (int i = 0; i < n; ++i) kstep(i);
  }
#pragma unroll
  for (int f = 0; f < NF; ++f)
#pragma unroll
    for (int jb = 0; jb < G::kNB; ++jb)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        acc[f][jb][c] = G::kF32 ? part[f][jb][c] : acc[f][jb][c] + part[f][jb][c];
}

// The epilogue of n-group grp over this warp's NF fragments, as block_mma's:
// bias (read from the launch's bias), ReLU, the masks, one rounding, and the
// stores of this group's kNG channels.  EPI: the leaky slope in place of
// ReLU, and the band's residual `res` added to the last layer's output.
template <typename T, int CHP, int NF, bool EPI>
__device__ __forceinline__ void wide_epilogue(const Params& p, const Epi& e, const Step& st,
                                              int f0, int grp,
                                              const float (&acc)[2][Cfg<T, CHP>::kNB][4],
                                              T* nxt, T* qout, T* out, const T* x,
                                              const T* first, const T* res) {
  using G = Cfg<T, CHP>;
  const int lane = threadIdx.x & 31, g = lane >> 2, tig = lane & 3;
  const int C = p.C, KC = p.K * C, odd = tig & 1;
  const T* bias = static_cast<const T*>(p.bias) + (size_t)st.l * CHP;
#pragma unroll
  for (int f = 0; f < NF; ++f) {
    bool keep[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int px = 16 * (f0 + f * kWarps) + g + 8 * h;
      const int rb = px / C, j = px - rb * C, r = st.r0 + rb;
      const int acol = st.k * C - st.l + j;
      keep[h] = px < st.npix && acol >= 0 && acol < p.W &&
                (!st.mask_rows || (r >= st.lo && r < st.hi));
    }
    const int px = 16 * (f0 + f * kWarps) + g + 8 * odd;
    const int rb = px / C, j = px - rb * C, r = st.r0 + rb;
    const int acol = st.k * C - st.l + j;
#pragma unroll
    for (int jb = 0; jb < G::kNB; ++jb) {
      const int co = G::kNG * grp + 8 * jb + 2 * tig;
      const float b0 = to_f(bias[co]), b1 = to_f(bias[co + 1]);
      float y[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float v = acc[f][jb][c] + (c & 1 ? b1 : b0);
        if constexpr (EPI) {
          if (st.relu) v = v > 0.f ? v : v * e.slope[st.l];
        } else {
          if (st.relu) v = fmaxf(v, 0.f);
        }
        y[c] = to_f(from_f<T>(keep[c >> 1] ? v : 0.f));
      }
      const float s0 = odd ? y[0] : y[2], s1 = odd ? y[1] : y[3];
      const float t0 = __shfl_xor_sync(0xffffffffu, s0, 1);
      const float t1 = __shfl_xor_sync(0xffffffffu, s1, 1);
      T v[4];
      if (odd) {
        v[0] = from_f<T>(t0); v[1] = from_f<T>(t1);
        v[2] = from_f<T>(y[2]); v[3] = from_f<T>(y[3]);
      } else {
        v[0] = from_f<T>(y[0]); v[1] = from_f<T>(y[1]);
        v[2] = from_f<T>(t0); v[3] = from_f<T>(t1);
      }
      if (px >= st.npix) continue;
      const int c4 = co - 2 * odd;
      if (!st.last) {
        store4(nxt + ((size_t)rb * C + j) * CHP + c4, v);
        if (j >= C - 2) store4(qout + ((size_t)r * 2 + j - (C - 2)) * CHP + c4, v);
      } else {
        if (p.add_anchor && acol >= 0 && acol < p.W) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (c4 + e < p.in_ch * p.repeats) {
              const int c = (c4 + e) / p.repeats;
              const T a = acol == 0 ? first[r * p.c0p + c]
                                    : x[((size_t)r * KC + acol - 1) * p.c0p + c];
              v[e] = from_f<T>(to_f(v[e]) + to_f(a));
            }
          }
        }
        if constexpr (EPI) {
          const int rr = r - e.res_off;
          if (res && acol >= 0 && acol < p.W && rr >= 0 && rr < e.res_rows) {
            const T* rp = res + ((size_t)rr * p.W + acol) * e.res_ch;
#pragma unroll
            for (int i = 0; i < 4; ++i)
              if (c4 + i < e.res_ch) v[i] = from_f<T>(to_f(v[i]) + to_f(rp[c4 + i]));
          }
        }
        store4(out + ((size_t)r * KC + st.k * C + j) * CHP + c4, v);
      }
    }
  }
}

template <typename T, int CHP, bool EPI>
__global__ void __launch_bounds__(kThreads, Cfg<T, CHP>::kMinBlocks)
tilted_fusion_wide_kernel(Params p, Epi e) {
  using G = Cfg<T, CHP>;
  constexpr int kSlices = 9 / G::kTaps * G::kHalves;  // slices of an n-group
  constexpr int KP = G::kKS / G::kHalves;               // k-steps of a piece, layers >= 1
  extern __shared__ uint4 smem[];
  char* slices = reinterpret_cast<char*>(smem);  // 2 x kSliceBytes
  char* win = slices + 2 * G::kSliceBytes;       // kWinBytes
  const uint32_t win_addr = smem_addr(win);

  const int cta = blockIdx.x;  // band * S + segment
  const int band = cta / p.S, seg = cta % p.S;
  const int tid = threadIdx.x, warp = tid >> 5;
  const int R = p.R, K = p.K, C = p.C, L = p.L;
  const int KC = K * C;
  const int k0 = (int)((long long)seg * K / p.S);
  const int k1 = (int)((long long)(seg + 1) * K / p.S);
  const int kw = k0 >= p.warm ? k0 - p.warm : 0;

  T* ws = reinterpret_cast<T*>(static_cast<char*>(p.ws) +
                               packed_bytes<T, CHP>(L, p.ks0, p.out_ch, false)) +
          (size_t)cta * workspace_elems(CHP, R, C, L);
  T* slab[2] = {ws, ws + slab_elems(CHP, R, C)};
  T* queue = ws + 2 * slab_elems(CHP, R, C);  // (2, L-1, R, 2, CHP)
  const size_t qslot = (size_t)R * 2 * CHP, qpar = queue_slot_elems(CHP, R, L);
  const T* x = static_cast<const T*>(p.x) + (size_t)band * R * KC * p.c0p;
  const T* first = static_cast<const T*>(p.first) + (size_t)band * R * p.c0p;
  T* out = static_cast<T*>(p.out) + (size_t)band * R * KC * CHP;
  const T* res = EPI && e.res ? static_cast<const T*>(e.res) +
                                    (size_t)band * e.res_rows * p.W * e.res_ch
                              : nullptr;

  Step st;
  st.mask_rows = p.bounds != nullptr;
  st.lo = st.mask_rows ? p.bounds[2 * band] : 0;
  st.hi = st.mask_rows ? p.bounds[2 * band + 1] : R;

  {
    uint4* q = reinterpret_cast<uint4*>(queue + (kw & 1) * qpar);
    const int n16 = (int)(qpar * sizeof(T) / 16);
    for (int i = tid; i < n16; i += kThreads) q[i] = make_uint4(0, 0, 0, 0);
  }
  load_slice<T, CHP>(p, 0, 0, 0, slices);
  cp_async_commit();

  const int nblk = (R + p.rows_blk - 1) / p.rows_blk;
  const FastDiv sc(C + 2);
  int n = 0;  // slices consumed: slice n sits in stage n & 1
  for (int k = kw; k < k1; ++k) {
    const int nl = k < k0 ? L - 1 : L;
    for (int l = 0; l < nl; ++l) {
      const bool has_next = !(l == nl - 1 && k == k1 - 1);
      st.k = k; st.l = l; st.last = l == L - 1; st.relu = (p.relu_mask >> l) & 1;
      st.ks = l == 0 ? p.ks0 : G::kKS;
      WindowSrc src;
      src.x = reinterpret_cast<const char*>(x);
      src.first = reinterpret_cast<const char*>(first);
      src.qin = l > 0 ? reinterpret_cast<const char*>(queue + (k & 1) * qpar + (l - 1) * qslot)
                      : nullptr;
      src.slab = l > 0 ? reinterpret_cast<const char*>(slab[(l - 1) & 1]) : nullptr;
      T* nxt = slab[l & 1];
      T* qout = st.last ? nullptr : queue + ((k + 1) & 1) * qpar + l * qslot;
      // a tap's B fragments in a slice of whole taps: ks k-steps of kQuads
      // uint4 a lane
      const int tap_bytes = st.ks * G::kQuads * 32 * 16;
      for (int b = 0; b < nblk; ++b) {
        st.r0 = b * p.rows_blk;
        const int rows = min(p.rows_blk, R - st.r0);
        st.npix = rows * C;
        // the layer of the slice that follows this block's last one: this
        // layer's again, the next step's, or none
        const int nxt_l = b + 1 < nblk ? l : has_next ? (l + 1 < nl ? l + 1 : 0) : -1;
        // the window is free and the last epilogue's stores are visible
        __syncthreads();
        load_window_wide<T, CHP>(p, src, l == 0, k, st.r0, rows, sc, win);
        cp_async_commit();
        const int nf = (st.npix + 15) / 16;
        const int mine = (warp < nf) + (warp + kWarps < nf);  // fragments of this warp
        // this lane's ldmatrix row per fragment, as block_mma's
        int wpix[2];
#pragma unroll
        for (int f = 0; f < 2; ++f) {
          int px = 16 * (warp + f * kWarps) + (tid & 7) + 8 * ((tid >> 3) & 1);
          px = px < st.npix ? px : st.npix - 1;
          const int r = px / C, j = px - r * C;
          wpix[f] = r * (C + 2) + j;
        }
        T* nxt_b = nxt + (size_t)st.r0 * C * CHP;
        // Every n-group runs its 9 taps, kTaps a slice (or half a tap),
        // then stores its channels.  Each slice copies the next one (the
        // next taps, group, block or step) into the other stage while it
        // computes.  The barriers are outside the branches on this warp's
        // fragments.
        for (int grp = 0; grp < G::kGroups; ++grp) {
          float acc[2][G::kNB][4];
#pragma unroll
          for (int f = 0; f < 2; ++f)
#pragma unroll
            for (int jb = 0; jb < G::kNB; ++jb)
#pragma unroll
              for (int c = 0; c < 4; ++c) acc[f][jb][c] = 0.f;
#pragma unroll 1
          for (int j = 0; j < kSlices; ++j, ++n) {
            // the stage the next slice goes to was last read by slice n - 1
            // (at a block's first slice, the block's barrier ordered that)
            if (grp > 0 || j > 0) __syncthreads();
            char* next = slices + ((n + 1) & 1) * G::kSliceBytes;
            if (j + 1 < kSlices) load_slice<T, CHP>(p, l, grp, j + 1, next);
            else if (grp + 1 < G::kGroups) load_slice<T, CHP>(p, l, grp + 1, 0, next);
            else if (nxt_l >= 0) load_slice<T, CHP>(p, nxt_l, 0, 0, next);
            cp_async_commit();
            cp_async_wait<1>();  // slice n (and the block's window) landed
            __syncthreads();
            const char* slice = slices + (n & 1) * G::kSliceBytes;
            int s0;  // the slice's k-steps of each of its taps: [s0, s0 + steps)
            const int steps = piece_steps<T, CHP>(st.ks, j % G::kHalves, s0);
#pragma unroll 1
            for (int i = 0; i < G::kTaps; ++i) {
              const int t = j / G::kHalves * G::kTaps + i;
              const int tpix = (t / 3) * (C + 2) + t % 3;
              const char* tb = slice + i * tap_bytes;
              if (mine == 2) {
                if (l > 0) wide_tap<T, CHP, 2, KP>(tb, win_addr, wpix, tpix, s0, steps, acc);
                else wide_tap<T, CHP, 2, 0>(tb, win_addr, wpix, tpix, s0, steps, acc);
              } else if (mine == 1) {
                if (l > 0) wide_tap<T, CHP, 1, KP>(tb, win_addr, wpix, tpix, s0, steps, acc);
                else wide_tap<T, CHP, 1, 0>(tb, win_addr, wpix, tpix, s0, steps, acc);
              }
            }
          }
          if (mine == 2)
            wide_epilogue<T, CHP, 2, EPI>(p, e, st, warp, grp, acc, nxt_b, qout, out, x, first,
                                          res);
          else if (mine == 1)
            wide_epilogue<T, CHP, 1, EPI>(p, e, st, warp, grp, acc, nxt_b, qout, out, x, first,
                                          res);
        }
      }
    }
  }
  cp_async_wait<0>();
}

// A kernel and the dynamic shared memory it takes.  A narrow kernel takes
// (Params), a wide one (Params, Epi).
struct Instance {
  const void* fn;
  int smem;
};

template <typename F> Instance kernel_of(F fn, int smem) {
  return {reinterpret_cast<const void*>(fn), smem};
}

// The narrow <T, CHP> kernel for bands of R rows and tiles of C columns on
// the route the wrapper asks for: on chip (fn null where the maps do not
// fit), or in device memory.
template <typename T, int CHP, bool MIXED> Instance narrow_instance(int R, int C, bool onchip) {
  if (!onchip) return kernel_of(tilted_fusion_kernel<T, CHP, MIXED>, Cfg<T, CHP>::kSmemBytes);
  if (!onchip_fits<T, CHP>(R, C)) return {nullptr, 0};
  return kernel_of(tilted_fusion_kernel_onchip<T, CHP, MIXED>, onchip_smem<T, CHP>(R, C));
}

// A wide instance has one route, its slabs in device memory; EPI (a leaky
// slope or a residual) is built at Chp kEpiChp alone.
template <typename T, int CHP> Instance make_instance(int R, int C, bool onchip, bool epi) {
  if constexpr (Cfg<T, CHP>::kWide) {
    if (onchip) return Instance{nullptr, 0};
    if (!epi) return kernel_of(tilted_fusion_wide_kernel<T, CHP, false>, Cfg<T, CHP>::kSmemBytes);
    if constexpr (CHP == kEpiChp)
      return kernel_of(tilted_fusion_wide_kernel<T, CHP, true>, Cfg<T, CHP>::kSmemBytes);
    return Instance{nullptr, 0};
  } else {
    return epi ? Instance{nullptr, 0} : narrow_instance<T, CHP, false>(R, C, onchip);
  }
}

// The instances built, for the padded widths the wrapper launches
// (tilted_fusion.py SUPPORTED_CHP; launch_chp pads a stack up to the next
// one): Chp 16 and 32 narrow, 48, 64, 96 and 128 wide.
#define K1_INSTANCES(X) X(16) X(32) X(48) X(64) X(96) X(128)

// The <dtype, Chp> instance (dtype 0 = float32, 1 = bfloat16) of out_ch
// outputs for R x C tiles on the route asked for, or fn null: a mixed
// launch (out_ch past Chp 32) has one of its own, the narrow kernel with
// output groups.  epi: the EPI instance (Chp kEpiChp alone).
Instance instance(int dtype, int chp, int out_ch, int R, int C, bool onchip, bool epi) {
  if (out_ch != chp) {
    if (chp != 32 || epi) return {nullptr, 0};
    if (dtype == 0) return narrow_instance<float, 32, true>(R, C, onchip);
    return narrow_instance<__nv_bfloat16, 32, true>(R, C, onchip);
  }
#define K1_INSTANCE(N)                                                              \
  if (dtype == 0 && chp == N) return make_instance<float, N>(R, C, onchip, epi);    \
  if (dtype == 1 && chp == N) return make_instance<__nv_bfloat16, N>(R, C, onchip, epi);
  K1_INSTANCES(K1_INSTANCE)
#undef K1_INSTANCE
  return {nullptr, 0};
}

// The <dtype, chp> instance of out_ch outputs for R x C tiles on the route
// asked for in *k, allowed the shared memory it takes; cudaErrorInvalidValue
// where there is none (no such instance, or maps that do not fit).
cudaError_t prepare(int dtype, int chp, int out_ch, int R, int C, bool onchip, bool epi,
                    Instance* k) {
  *k = instance(dtype, chp, out_ch, R, C, onchip, epi);
  if (!k->fn) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(k->fn, cudaFuncAttributeMaxDynamicSharedMemorySize, k->smem);
}

// Output rows of a full row block: at most kBlockPix pixels, and its
// window (rows + 2) x (C + 2) within kWinPix; 0 where C is too wide.
int block_rows(int C) {
  const int by_pix = kBlockPix / C, by_win = kWinPix / (C + 2) - 2;
  return by_pix < by_win ? by_pix : by_win;
}

// The packed weights of a launch on route `onchip` (a narrow instance's
// stages pre-split on the device-memory route).
template <typename T, int CHP>
cudaError_t launch_pack(const Params& p, bool onchip, cudaStream_t stream) {
  const size_t words = packed_bytes<T, CHP>(p.L, p.ks0, p.out_ch, !onchip) / 4;
  const int grid = (int)((words + kThreads - 1) / kThreads);
  if constexpr (Cfg<T, CHP>::kWide)
    pack_slices_kernel<T, CHP><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(p.w), static_cast<uint32_t*>(p.ws), p.L, p.ks0);
  else
    pack_weights_kernel<T, CHP><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(p.w), static_cast<const T*>(p.bias),
        static_cast<uint32_t*>(p.ws), p.L, p.ks0, p.out_ch, !onchip);
  return cudaGetLastError();
}

cudaError_t pack(int dtype, int chp, const Params& p, bool onchip, cudaStream_t stream) {
#define K1_PACK(N)                                                                      \
  if (dtype == 0 && chp == N) return launch_pack<float, N>(p, onchip, stream);          \
  if (dtype == 1 && chp == N) return launch_pack<__nv_bfloat16, N>(p, onchip, stream);
  K1_INSTANCES(K1_PACK)
#undef K1_PACK
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Launch the weight packing and then B*S CTAs on `stream` (S segments per
// band, `warm` warm-up tiles for a restarted segment; ws holds the packed
// stages and then B*S workspaces of the route the launch takes,
// tilted_fusion.py::workspace_shapes);
// returns the launch's CUDA error code (0 = ok).  dtype: 0 = float32,
// 1 = bfloat16.  chp is the instance; out_ch the last layer's outputs and
// the pitch of w, bias and out: chp, or on a mixed launch of the Chp 32
// instance 48, 64, 96 or 128 (any multiple of 16 from 48 to 128).  onchip:
// the route the wrapper chose (tilted_fusion.py::route), 1 the feature maps
// in shared memory (a narrow instance whose maps fit, else
// cudaErrorInvalidValue), 0 in device-memory slabs.  res (B, res_rows, W,
// res_ch), compute dtype, or null: the residual added to the last layer's
// output at band rows [res_off, res_off + res_rows); slopes (host memory, L
// floats) or null: each activated layer's leaky slope.  Either takes the
// EPI instance, which only Chp 64 has (else cudaErrorInvalidValue).  Does
// not synchronise or allocate.
int tilted_fusion_launch(int dtype, const void* x, const void* first, const void* w,
                         const void* bias, const void* bounds, void* out, void* ws,
                         int B, int R, int K, int C, int c0p, int chp, int out_ch, int L, int W,
                         int relu_mask, int add_anchor, int in_ch, int repeats,
                         int replicate, int S, int warm, int onchip, const void* res,
                         int res_rows, int res_off, int res_ch, const float* slopes,
                         void* stream) {
  if (B == 0) return 0;
  if (S < 1 || S > K || warm < 0 || L < 1 || L > kMaxLayers || c0p < 1 || c0p > chp ||
      c0p % 8 || C < 2 || block_rows(C) < 1)
    return (int)cudaErrorInvalidValue;
  if (res && (res_rows < 1 || res_off < 0 || res_ch < 1 || res_ch > chp))
    return (int)cudaErrorInvalidValue;
  if (out_ch != chp && !(chp == 32 && out_ch > 32 && out_ch <= 128 && out_ch % 16 == 0))
    return (int)cudaErrorInvalidValue;
  Params p;
  p.x = x; p.first = first; p.w = w; p.bias = bias;
  p.bounds = reinterpret_cast<const int*>(bounds);
  p.out = out; p.ws = ws; p.out_ch = out_ch;
  p.R = R; p.K = K; p.C = C; p.c0p = c0p; p.L = L; p.W = W;
  p.S = S; p.warm = warm;
  p.relu_mask = relu_mask; p.add_anchor = add_anchor; p.in_ch = in_ch;
  p.repeats = repeats; p.replicate = replicate;
  Epi ep;
  ep.res = res; ep.res_rows = res_rows; ep.res_off = res_off; ep.res_ch = res_ch;
  for (int l = 0; l < kMaxLayers; ++l) ep.slope[l] = slopes && l < L ? slopes[l] : 0.f;
  const bool epi = res != nullptr || slopes != nullptr;
  const int kk = dtype == 0 ? 8 : 16;
  p.ks0 = (c0p + kk - 1) / kk;
  p.shift0 = 0;
  while ((1 << p.shift0) * 16 < p.ks0 * kk * (dtype == 0 ? 4 : 2)) ++p.shift0;
  p.rows_blk = block_rows(C);
  Instance k;
  cudaError_t e = prepare(dtype, chp, out_ch, R, C, onchip != 0, epi, &k);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  e = pack(dtype, chp, p, onchip != 0, s);
  if (e != cudaSuccess) return (int)e;
  void* args[] = {&p, &ep};  // a narrow kernel reads the first alone
  return (int)cudaLaunchKernel(k.fn, dim3(B * S), dim3(kThreads), args, k.smem, s);
}

// Resident CTAs per SM of the <dtype, chp> instance of out_ch outputs for
// bands of R rows and tiles of C columns on the route `onchip` (as
// tilted_fusion_launch takes it) on the current device
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor at 256 threads and its
// shared memory), written to *blocks; returns the CUDA error code.  An EPI
// instance has its plain twin's launch bounds and shared memory.
int tilted_fusion_blocks_per_sm(int dtype, int chp, int out_ch, int R, int C, int onchip,
                                int* blocks) {
  Instance k;
  cudaError_t e = prepare(dtype, chp, out_ch, R, C, onchip != 0, false, &k);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, k.fn, kThreads, k.smem);
}

const char* tilted_fusion_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
