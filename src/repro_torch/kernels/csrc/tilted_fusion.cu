// Tilted layer fusion on Hopper (sm_90a): the fused L-layer 3x3 conv stack
// swept over a band by tilted column tiles, on the tensor cores.
//
// Replaces: src/repro/kernels/tilted_fusion.py::tilted_fusion_kernel, the
// Pallas TPU kernel launched by tilted_fusion_call over grid (band, tile k).
//
// What bounds it on this card: arithmetic.  ABPN x3 is 42,840 MAC per LR
// pixel; a 360x640 frame is 19.7 GFLOP (38.0 as executed: Chp = 32 padding
// and warm-up tiles) against ~30 MB of output.  On the tensor cores (495
// TFLOP/s TF32, 989 bf16; 3.35 TB/s) fp32 as 3xTF32 (three TF32 products per
// fp32 product) is bound by operations, 0.120 ms a frame for the unpadded
// work; bf16 is bound by its bytes.  The second limit is parallelism: the
// overlap queue carries state from tile k to tile k+1, so a band is one
// sequential sweep, and a 360-row frame has only 6 bands.
//
// What this design does about it:
//   * column segments (unchanged from the FMA design): each band's K tiles
//     are cut into S contiguous segments [k0, k1) of near-equal length
//     (k0 = seg*K/S, rounded down), and each (band, segment) pair is one
//     CTA, so B*S CTAs fill the SMs.  A segment that starts at k0 >= w
//     restarts the sweep at kw = k0 - w with w = ceil((2L-1)/C) warm-up
//     tiles: F_0 is read from the input stream, the deeper layers' carried
//     columns start at zero, and tiles kw..k0-1 run layers 0..L-2 and store
//     nothing.  A wrong carried column of F_l reaches at most one more
//     column per layer, so after w tiles every column a layer carries into
//     tile k0 is the full sweep's, bit for bit; the output does not depend
//     on S.  A segment with k0 < w starts at tile 0 with the band-start state.
//   * every layer's nine shifted (pixels, Chp) @ (Chp, Chp) products run on
//     the tensor cores through mma.sync.  The tile's R x C output pixels,
//     row-major, are cut into m16 fragments of 16 consecutive pixels (two
//     rows at C = 8); N = Chp is Chp/8 n8 blocks.  bf16: m16n8k16 (bf16
//     products are exact in fp32), each tap's k-steps summed by the MMAs
//     from zero and the tap's partial added to the accumulator in fp32, as
//     the plain version adds its nine products.  fp32 (and int8,
//     which computes in fp32): m16n8k8 TF32 three times (3xTF32), each
//     operand split into hi = tf32(a) and lo = tf32(a - hi), rounded as
//     cvt.rna.tf32.f32 rounds, summed lo*hi + hi*lo + hi*hi, small terms
//     first.  Layer 0 reads c0p channels, padded to the MMA's k (8 in TF32,
//     16 in bf16, the pad zero-filled): one k-step a tap at c0p = 8.
//     Every output element is summed in one order (tap, k-step, term)
//     wherever its pixel falls in a fragment, tile, segment or band.
//   * weights packed once per launch.  A first small kernel writes every
//     layer's B fragments, already in the mma register layout (fp32: split
//     into hi and lo words here, once, not at every use) with its bias as
//     fp32, into the head of the workspace.  Each (tile, layer) step copies
//     its layer's stage into shared memory with cp.async, one step ahead,
//     into the other of two stages.
//   * pixel-major workspace in device memory (per CTA, the wrapper
//     allocates B*S of them after the packed weights): two ping-pong slabs
//     (R, C, Chp) that hold a layer's C fresh output columns, and the
//     overlap queue (2, L-1, R, 2, Chp), double-buffered by tile parity:
//     layer l reads the columns F_l carried from tile k-1 in slot
//     [k & 1][l-1] while its epilogue writes F_{l+1}'s last two columns to
//     [(k+1) & 1][l], so nothing is copied between them.  Layer 0 reads its
//     window straight from the input stream (no queue slot for F_0).  The
//     workspace is 307 KB a CTA at R = 60 in fp32, so the resident CTAs'
//     share stays in the 50 MB L2.
//   * A windows streamed through shared memory.  Rows are cut into blocks
//     of at most 256 output pixels in a window of at most 320 (30 rows at
//     C = 8, 15 fragments: at most 2 per warp, each warp all Chp outputs).
//     A block's (rows+2) x (C+2) input window comes into shared memory with
//     cp.async (rows outside the band zero-filled under `zero`, clamped
//     under `replicate`), double-buffered: block b+1's window is copied
//     while block b computes (a step's first block reads what the step
//     before it wrote, so it waits for its own).  A pixel of 128 bytes (fp32
//     Chp 32) is stored with its 16-byte chunks swizzled (chunk ^ pixel % 8),
//     a narrower one padded by 16 bytes, so that the 8 rows of each ldmatrix
//     matrix fall on distinct banks; each fragment is one ldmatrix.x4 per
//     tap and k-step (an fp32 is two b16 halves, so the same instruction
//     gives the m16k8 TF32 fragment).  Shared memory does not depend on R,
//     so every band height the planner derives (divisors up to 60, 74-row
//     halo slabs, a one-band fallback of any height) launches.  fp32 Chp
//     32: two weight stages 2 x 73,856 B + two windows 2 x 40,960 B =
//     229,632 B, one CTA per SM; bf16: 2 x 18,560 + 2 x 25,600 = 88,320 B.
//   * A is split into hi and lo at use, not stored split: stored split, the
//     workspace and the window would double (past the L2 at 8 frames, and
//     past the shared memory with two weight stages), and the window's
//     ldmatrix traffic would double too.  One split of an A register feeds
//     all Chp/8 n blocks.
//   * epilogue from the accumulator fragments: bias, ReLU, the phantom-column
//     mask (acol = k*C - l + j outside [0, W)), the row bounds, one rounding
//     to the storage dtype; a layer's output goes to the next slab (and its
//     last two columns to the queue), the last layer's to `out`, with the
//     anchor read from the input stream (add_anchor).
//   * widths: instances for Chp 16, 32, 48, 64, 96 and 128 (K1_INSTANCES;
//     the wrapper pads a stack to the next, tilted_fusion.py::launch_chp).
//     The above is the "narrow" design of Chp 16 and 32.  A whole layer's
//     pre-split stage and all Chp accumulators of a warp do not fit wider
//     (a fp32 Chp 128 stage is 295 KB; Chp fp32 accumulators a thread), so
//     the "wide" instances (tilted_fusion_wide_kernel) cut the outputs into
//     n-groups of kNG and stream a layer's B fragments through two slices
//     of shared memory, double-buffered by cp.async behind the MMAs and
//     pre-split once a launch by pack_slices_kernel.  Per instance a
//     schedule (wide_sched, chosen on the card by tools/k1_ablation.py
//     --wide) sets what bounds it there.  Its tensor-core work is
//     shared-memory fed: a warp's k-step loads its A fragments (and splits
//     them into TF32 hi and lo) and B's hi and lo words for its kNG
//     outputs, so a larger n-group cuts the loads and splits an MMA: fp32
//     computes 48, 64 or 96 outputs a pass (Chp 64: A loaded and split once
//     a tap and k-step, not twice), and where a whole tap's outputs would
//     not fit beside the window (Chp 96, 128) a slice holds half a tap's
//     k-steps.  Slices of a tap row (3 taps) where they fit cut the
//     barrier pairs of an n-group from 9 to 3 (bf16, fp32 Chp 48).  bf16
//     up to Chp 64 fits 2 CTAs an SM at 128 registers; fp32 at 128
//     registers spills and runs slower than one CTA.  A row block's window
//     (320 pixels) is copied once, then every n-group runs its 9 taps and
//     stores its channels.  A second window, copied behind the MMAs
//     (tools/k1_ablation.py --wide two_windows: fp32 Chp 48 and 64, bf16
//     at every width), was slower or level within about 2 % noise (a
//     step's first block reads the step before it, so only later blocks
//     can be overlapped).  The
//     arithmetic is the narrow design's: every element sums tap, k-step,
//     term in the same order whatever the schedule, so segments stay
//     bit-identical and a stack padded with zero channels gives the narrow
//     instance's result bit for bit.  Shared memory: fp32 Chp 48 177,152
//     B, Chp 128 229,376 B; bf16 Chp 48 63,488 B.
//   * mixed widths: a stack whose feature maps F_0..F_{L-1} fit 32 channels
//     but whose last layer has more outputs (ABPN x4: 3 -> 28 x6 -> 48) runs
//     on the narrow Chp 32 instance with the output width out_ch (48, 64,
//     96 or 128) given at launch.  Its step pipeline is one of (layer,
//     output group) steps: layers 0..L-2 one step each at Chp 32, exactly
//     as a narrow launch; layer L-1 ceil(out_ch / 32) steps, output group g
//     (32 outputs, the last 16 where out_ch = 48) with a stage of its own B
//     fragments and bias.  Group-outer: each group step walks the row
//     blocks and copies their hidden-width windows again (one more layer's
//     window copies a tile at x4), so no stage is larger than a Chp 32
//     layer's and shared memory, occupancy and the segment plan are the
//     narrow instance's.  The slabs and the queue hold 32 channels, so the
//     workspace is the narrow one's.  A group's epilogue stores its channels
//     at offset 32 g of `out` (pitch out_ch) and adds the anchor to those of
//     them it covers.  Each output element sums tap, k-step, term as the
//     Chp = out_ch wide instance does, which only adds exact zeros past 32
//     channels: on the same packed stack the two give the same bits.  A
//     narrow launch is the case out_ch = Chp, one group.
// Left for later work: wgmma and TMA, layer 0's taps folded into K in fp32,
// slabs resident in shared memory across layers; on the wide instances,
// fewer shared-memory bytes an MMA (wgmma's B from shared memory, or warps
// that split the n-groups of one pixel tile).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kFrags = 2;                         // m16 fragments a warp owns in a block
constexpr int kBlockPix = 16 * kFrags * kWarps;   // 256 output pixels a row block
constexpr int kWinPix = 320;                      // window pixels: (30 + 2) x (8 + 2)

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
  int rows_blk;        // output rows of a full row block
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
  static constexpr int kWords = kF32 ? 4 * kNB : 2 * kNB;  // B words a lane, (tap, k-step)
  static constexpr int kQuads = kWords / 4;
  static constexpr int kChunks = CHP * (int)sizeof(T) / 16;       // 16-byte copies a pixel
  // A window pixel: a whole number of 128 bytes of data (fp32 Chp 32, 64,
  // 96, 128; bf16 64, 128) is stored as it is, its 16-byte chunks swizzled
  // (chunk ^ pixel % 8); other pixels are padded by 16 bytes to an odd
  // number of chunks.  Either way the 8 rows of an ldmatrix matrix, 8
  // neighbouring pixels, fall on distinct banks.
  static constexpr bool kSwizzle = kChunks % 8 == 0;
  static constexpr int kPixBytes = kSwizzle ? 16 * kChunks : 16 * kChunks + 16;
  static constexpr int kWinPix = ::kWinPix;
  static constexpr int kStageBytes = CHP * 4 + 9 * kKS * kQuads * 32 * 16;  // bias + B (narrow)
  static constexpr int kTaps = kWide ? kSched.taps : 9;      // taps of a slice (wide)
  static constexpr int kHalves = kWide ? kSched.halves : 1;  // slices a tap (wide)
  // kTaps x (tap, n-group), or half a tap's k-steps
  static constexpr int kSliceBytes = kTaps * (kKS / kHalves) * kQuads * 32 * 16;
  static constexpr int kWinBytes = kWinPix * kPixBytes;
  // narrow: two stages and two windows; wide: two slices and one window
  static constexpr int kSmemBytes =
      kWide ? 2 * kSliceBytes + kWinBytes : 2 * kStageBytes + 2 * kWinBytes;
  // fp32 Chp 32 takes 229,632 B of shared memory: one CTA an SM, all registers
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
// k-step): a narrow instance's step computes NG = Chp outputs, or a last
// layer's output group of NG = 32 or 16.
template <typename T, int NG> struct Grp {
  static constexpr int kNB = NG / 8;                              // n8 blocks
  static constexpr int kWords = sizeof(T) == 4 ? 4 * kNB : 2 * kNB;
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

// n / d for the small n and d of a window (n < 2^16): one multiply by a
// reciprocal made once.
struct FastDiv {
  uint32_t d, m;
  __device__ __forceinline__ explicit FastDiv(int d_) : d(d_), m(0xffffffffu / d_ + 1) {}
  __device__ __forceinline__ int div(int n) const { return (int)__umulhi((uint32_t)n, m); }
};

// Byte offset in a window of 16-byte chunk `chunk` of window pixel `pix`.
template <typename T, int CHP>
__device__ __forceinline__ uint32_t win_off(int pix, int chunk) {
  using G = Cfg<T, CHP>;
  return pix * G::kPixBytes + 16 * (G::kSwizzle ? chunk ^ (pix & 7) : chunk);
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
// conflict-free.  A lane's words u = 4q + e hold, for g = lane / 4, tig =
// lane % 4, nb = ng / 8 and the step's first output n0 (32 x its group):
// fp32: u < 2 nb the hi words, then the lo words; within each half n block
//       jb = (u mod 2 nb) / 2 and register r = u % 2 hold
//       B[8s + tig + 4r][n0 + 8 jb + g];
// bf16: jb = u / 2, r = u % 2 hold B[k][n0 + 8 jb + g] (low half) and
//       B[k + 1][n0 + 8 jb + g] with k = 16s + 2 tig + 8r.
// ---------------------------------------------------------------------------
template <typename T>
__host__ __device__ inline int stage_words(int ng, int ks) {
  return ng + 9 * ks * ((sizeof(T) == 4 ? 4 : 2) * (ng / 8) / 4) * 32 * 4;
}

// Step i of an own tile runs layer min(i, L - 1); steps L - 1 on are the
// last layer's output groups.
template <typename T, int CHP>
__host__ __device__ inline int step_stage_words(int i, int L, int ks0, int out_ch) {
  const int l = i < L - 1 ? i : L - 1;
  return stage_words<T>(i < L - 1 ? CHP : group_width(out_ch, i - l),
                        l == 0 ? ks0 : Cfg<T, CHP>::kKS);
}

// Every stage but the last is Chp wide (a hidden layer, or an output group
// of kGroup = Chp on a mixed launch), with ks0 k-steps at layer 0.
template <typename T, int CHP>
__host__ __device__ inline size_t stage_offset(int i, int L, int ks0) {  // words
  const size_t w0 = stage_words<T>(CHP, ks0), w = stage_words<T>(CHP, Cfg<T, CHP>::kKS);
  return i == 0 ? 0 : L == 1 ? i * w0 : w0 + (i - 1) * w;
}

// Words of all the stages, the last one (a mixed launch's 16-output group)
// at its own width.
template <typename T, int CHP>
__host__ __device__ inline size_t packed_words(int L, int ks0, int out_ch) {
  const int last = L - 2 + out_groups(out_ch);
  return stage_offset<T, CHP>(last, L, ks0) + step_stage_words<T, CHP>(last, L, ks0, out_ch);
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

template <typename T, int CHP>
__host__ __device__ inline size_t packed_bytes(int L, int ks0, int out_ch) {
  if constexpr (Cfg<T, CHP>::kWide) return 4 * slice_offset<T, CHP>(L, 0, 0, ks0);
  else return 4 * packed_words<T, CHP>(L, ks0, out_ch);
}

// A narrow instance's stages (see stage_words) from w (L, 3, 3, out_ch,
// out_ch) and bias (L, out_ch): the hidden layers read their Chp x Chp
// blocks, the last layer its Chp x out_ch block, nothing else.
template <typename T, int CHP>
__global__ void pack_weights_kernel(const T* __restrict__ w, const T* __restrict__ bias,
                                    uint32_t* __restrict__ packed, int L, int ks0, int out_ch) {
  using G = Cfg<T, CHP>;
  const int steps = L - 1 + out_groups(out_ch);
  const size_t total = packed_words<T, CHP>(L, ks0, out_ch);
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    int step = 0;
    while (step + 1 < steps && stage_offset<T, CHP>(step + 1, L, ks0) <= i) ++step;
    const size_t base = stage_offset<T, CHP>(step, L, ks0);  // the stage's first word
    const int l = step < L - 1 ? step : L - 1, grp = step - l;
    const int ng = step < L - 1 ? CHP : group_width(out_ch, grp), n0 = kGroup * grp;
    const int ks = l == 0 ? ks0 : G::kKS, nb = ng / 8;
    const int quads = (G::kF32 ? 4 : 2) * nb / 4;
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
        const int half = u / (2 * nb), v2 = u % (2 * nb);
        const int n = n0 + 8 * (v2 >> 1) + g, k = 8 * s + tig + 4 * (v2 & 1);
        uint32_t hi, lo;
        tf32_split(__float_as_uint(to_f(wt[k * out_ch + n])), hi, lo);
        v = half ? lo : hi;
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
// Elements of one CTA's workspace: two slabs (R, C, Chp) and the overlap
// queue (2, L-1, R, 2, Chp) (tilted_fusion.py::workspace_shapes).
__host__ __device__ inline size_t slab_elems(int chp, int R, int C) {
  return (size_t)R * C * chp;
}
__host__ __device__ inline size_t queue_slot_elems(int chp, int R, int L) {
  return (size_t)(L - 1) * R * 2 * chp;
}
__host__ __device__ inline size_t workspace_elems(int chp, int R, int C, int L) {
  return 2 * slab_elems(chp, R, C) + 2 * queue_slot_elems(chp, R, L);
}

// Copy the packed stage of step i into shared memory (cp.async, not
// committed).
template <typename T, int CHP, bool MIXED>
__device__ __forceinline__ void load_stage(const Params& p, int i, char* stage) {
  // a narrow launch has one step a layer: stage_offset with L > i
  const char* src = static_cast<const char*>(p.ws) +
                    4 * stage_offset<T, CHP>(i, MIXED ? p.L : i + 1, p.ks0);
  const int n16 = (MIXED ? step_stage_words<T, CHP>(i, p.L, p.ks0, p.out_ch)
                         : stage_words<T>(CHP, i == 0 ? p.ks0 : Cfg<T, CHP>::kKS)) / 4;
  const uint32_t dst = smem_addr(stage);
  for (int i = threadIdx.x; i < n16; i += kThreads) cp_async16(dst + 16 * i, src + 16 * i, 16);
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

// One row block of one step: this warp's NF fragments (block fragments f0,
// f0 + kWarps), the step's NG outputs (all Chp of a hidden layer, or one
// output group of the last layer), then the epilogue.  KS > 0: KS k-steps a
// tap, known when compiling (layers >= 1); 0: st.ks (layer 0).  MIXED: the
// last layer's `out` has out_ch channels, this group's from st.n0 on (else
// Chp, from 0).
struct Step {
  int k, l, last, relu;  // tile, layer; last layer; ReLU on
  int n0;                // the step's first output channel (32 x its output group)
  int r0, npix;          // the block's first row and its output pixels
  int lo, hi, mask_rows;
  int ks;                // k-steps a tap
};

template <typename T, int CHP, bool MIXED, int NG, int NF, int KS>
__device__ __forceinline__ void block_mma(const Params& p, const Step& st, const char* stage,
                                          const char* win, int f0, T* nxt, T* qout, T* out,
                                          const T* x, const T* first) {
  using G = Cfg<T, CHP>;
  using N = Grp<T, NG>;
  const int lane = threadIdx.x & 31, g = lane >> 2, tig = lane & 3;
  const int C = p.C, SC = C + 2;
  const uint32_t win_addr = smem_addr(win);
  const uint4* bsm = reinterpret_cast<const uint4*>(stage + NG * 4);
  // this lane's ldmatrix row, per fragment: row m = (lane & 7) + 8 ((lane
  // >> 3) & 1) of the fragment, window pixel wpix for tap (0, 0), chunk
  // 2s + (lane >> 4) of k-step s; a pixel past the block reads the last one
  int wpix[NF];
#pragma unroll
  for (int f = 0; f < NF; ++f) {
    int px = 16 * (f0 + f * kWarps) + (lane & 7) + 8 * ((lane >> 3) & 1);
    px = px < st.npix ? px : st.npix - 1;
    const int r = px / C, j = px - r * C;
    wpix[f] = r * SC + j;
  }
  const int khalf = lane >> 4;
  float acc[NF][N::kNB][4];
#pragma unroll
  for (int f = 0; f < NF; ++f)
#pragma unroll
    for (int jb = 0; jb < N::kNB; ++jb)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[f][jb][c] = 0.f;

  // one k-step s of tap t: B from the stage, A by ldmatrix, the MMAs into d
  const int ks = KS > 0 ? KS : st.ks;
  auto kstep = [&](int t, int tpix, int s, float (&d)[NF][N::kNB][4]) {
    uint32_t bw[N::kWords];
#pragma unroll
    for (int q = 0; q < N::kQuads; ++q) {
      const uint4 v = bsm[((t * ks + s) * N::kQuads + q) * 32 + lane];
      bw[4 * q] = v.x; bw[4 * q + 1] = v.y; bw[4 * q + 2] = v.z; bw[4 * q + 3] = v.w;
    }
    uint32_t a[NF][4];
#pragma unroll
    for (int f = 0; f < NF; ++f)
      ldmatrix_x4(a[f], win_addr + win_off<T, CHP>(wpix[f] + tpix, 2 * s + khalf));
    if constexpr (G::kF32) {
      uint32_t ah[NF][4], al[NF][4];
#pragma unroll
      for (int f = 0; f < NF; ++f)
#pragma unroll
        for (int c = 0; c < 4; ++c) tf32_split(a[f][c], ah[f][c], al[f][c]);
      constexpr int LO = 2 * N::kNB;  // the lo words of B
#pragma unroll
      for (int f = 0; f < NF; ++f)
#pragma unroll
        for (int jb = 0; jb < N::kNB; ++jb)
          mma_tf32(d[f][jb], al[f], bw[2 * jb], bw[2 * jb + 1]);
#pragma unroll
      for (int f = 0; f < NF; ++f)
#pragma unroll
        for (int jb = 0; jb < N::kNB; ++jb)
          mma_tf32(d[f][jb], ah[f], bw[LO + 2 * jb], bw[LO + 2 * jb + 1]);
#pragma unroll
      for (int f = 0; f < NF; ++f)
#pragma unroll
        for (int jb = 0; jb < N::kNB; ++jb)
          mma_tf32(d[f][jb], ah[f], bw[2 * jb], bw[2 * jb + 1]);
    } else {
#pragma unroll
      for (int f = 0; f < NF; ++f)
#pragma unroll
        for (int jb = 0; jb < N::kNB; ++jb)
          mma_bf16(d[f][jb], a[f], bw[2 * jb], bw[2 * jb + 1]);
    }
  };
  // Tap t's k-steps.  fp32: into the accumulator.  bf16: into a partial
  // that starts at zero, then added to the accumulator in fp32, tap by tap
  // as the plain version adds its nine products.  One accumulator carried
  // through all 9 x ks bf16 MMAs rounds about twice as many outputs of a
  // 28 -> 28 layer away from the exact value as the plain version does
  // (tools/k1_bf16_rounding.py).
  auto tap = [&](int t, int tpix) {
    if constexpr (G::kF32) {
      if constexpr (KS > 0) {
#pragma unroll
        for (int s = 0; s < KS; ++s) kstep(t, tpix, s, acc);
      } else {
#pragma unroll 1
        for (int s = 0; s < ks; ++s) kstep(t, tpix, s, acc);
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
        for (int s = 0; s < KS; ++s) kstep(t, tpix, s, part);
      } else {
#pragma unroll 1
        for (int s = 0; s < ks; ++s) kstep(t, tpix, s, part);
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
    for (int dx = 0; dx < 3; ++dx) tap(dy * 3 + dx, dy * SC + dx);
  }

  // Epilogue: bias, ReLU, phantom-column and phantom-row masks, one rounding.
  // Accumulator c of n block jb holds pixel 16f + g + 8 (c >> 1), output
  // channel 8 jb + 2 tig + (c & 1).  Lanes tig and tig ^ 1 swap halves, so
  // that an even lane holds 4 consecutive channels of pixel 16f + g and an
  // odd lane those of pixel 16f + g + 8: one 16-byte (bf16: 8-byte) store.
  const float* bsh = reinterpret_cast<const float*>(stage);
  const int KC = p.K * C;
  const int odd = tig & 1;
#pragma unroll
  for (int f = 0; f < NF; ++f) {
    bool keep[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int px = 16 * (f0 + f * kWarps) + g + 8 * h;
      const int rb = px / C, j = px - rb * C, r = st.r0 + rb;
      const int acol = st.k * C - st.l + j;  // absolute column of this output
      keep[h] = px < st.npix && acol >= 0 && acol < p.W &&
                (!st.mask_rows || (r >= st.lo && r < st.hi));
    }
    // this lane's pixel after the swap, and where its 4 channels start
    const int px = 16 * (f0 + f * kWarps) + g + 8 * odd;
    const int rb = px / C, j = px - rb * C, r = st.r0 + rb;
    const int acol = st.k * C - st.l + j;
#pragma unroll
    for (int jb = 0; jb < N::kNB; ++jb) {
      const int co = 8 * jb + 2 * tig;
      const float2 bv = *reinterpret_cast<const float2*>(bsh + co);
      float y[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float v = acc[f][jb][c] + (c & 1 ? bv.y : bv.x);
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
        store4(nxt + ((size_t)rb * C + j) * CHP + c4, v);
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
}

// One row block of a step over the step's NG outputs, in this warp's one or
// two fragments (none where the block has fewer).
template <typename T, int CHP, bool MIXED, int NG>
__device__ __forceinline__ void run_block(const Params& p, const Step& st, const char* stage,
                                          const char* win, int warp, int nf, T* nxt, T* qout,
                                          T* out, const T* x, const T* first) {
  constexpr int KS = Cfg<T, CHP>::kKS;
  if (warp + kWarps < nf) {
    if (st.l > 0)
      block_mma<T, CHP, MIXED, NG, 2, KS>(p, st, stage, win, warp, nxt, qout, out, x, first);
    else
      block_mma<T, CHP, MIXED, NG, 2, 0>(p, st, stage, win, warp, nxt, qout, out, x, first);
  } else if (warp < nf) {
    if (st.l > 0)
      block_mma<T, CHP, MIXED, NG, 1, KS>(p, st, stage, win, warp, nxt, qout, out, x, first);
    else
      block_mma<T, CHP, MIXED, NG, 1, 0>(p, st, stage, win, warp, nxt, qout, out, x, first);
  }
}

// MIXED: a mixed launch (Chp 32, out_ch > 32 outputs in output groups);
// else every step computes Chp outputs and the last layer is one step.
template <typename T, int CHP, bool MIXED>
__global__ void __launch_bounds__(kThreads, Cfg<T, CHP>::kMinBlocks)
tilted_fusion_kernel(Params p) {
  using G = Cfg<T, CHP>;
  extern __shared__ uint4 smem[];
  char* stages = reinterpret_cast<char*>(smem);  // 2 x kStageBytes
  char* wins = stages + 2 * G::kStageBytes;      // 2 x kWinBytes

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
                               packed_bytes<T, CHP>(L, p.ks0, MIXED ? p.out_ch : CHP)) +
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
  if constexpr (MIXED) st.n0 = 0;

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
    // Steps i of tile k: layer min(i, L - 1), the last layer once an output
    // group.  A warm-up tile (k < k0) runs layers 0..L-2 only: layer L-1's
    // output is not carried, and a warm-up tile stores nothing.
    const int ns = k < k0 ? L - 1 : MIXED ? L - 1 + out_groups(p.out_ch) : L;
    for (int i = 0; i < ns; ++i, ++step) {
      const int l = MIXED && i > L - 1 ? L - 1 : i;
      const char* stage = stages + (step & 1) * G::kStageBytes;
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
      T* nxt = slab[l & 1];
      T* qout = st.last ? nullptr : queue + ((k + 1) & 1) * qpar + l * qslot;
      // Row block b computes from window b & 1; the window of block b + 1
      // is copied while block b computes (a step's block 0 reads what the
      // step before it wrote, so it waits for its own window).
      for (int b = 0; b < nblk; ++b) {
        st.r0 = b * p.rows_blk;
        st.npix = min(p.rows_blk, R - st.r0) * C;
        // the other window and the other stage are free; the last
        // epilogue's stores are visible to this CTA
        __syncthreads();
        if (b == 0) {
          load_window<T, CHP>(p, src, l == 0, k, 0, min(p.rows_blk, R), sc, wins);
          cp_async_commit();
          if (has_next)  // the next step's weights, a step ahead
            load_stage<T, CHP, MIXED>(p, i + 1 < ns ? i + 1 : 0,
                                      stages + ((step + 1) & 1) * G::kStageBytes);
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
        const char* win = wins + (b & 1) * G::kWinBytes;
        const int nf = (st.npix + 15) / 16;
        T* nxt_b = nxt + (size_t)st.r0 * C * CHP;
        // a hidden layer's step, or an output group of 32, computes Chp
        // outputs; only a mixed launch's last group of 16 fewer
        if constexpr (MIXED) {
          if (st.last && group_width(p.out_ch, i - l) < CHP) {
            run_block<T, CHP, true, 16>(p, st, stage, win, warp, nf, nxt_b, qout, out, x, first);
            continue;
          }
        }
        run_block<T, CHP, MIXED, CHP>(p, st, stage, win, warp, nf, nxt_b, qout, out, x, first);
      }
    }
  }
  cp_async_wait<0>();
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
// stores of this group's kNG channels.
template <typename T, int CHP, int NF>
__device__ __forceinline__ void wide_epilogue(const Params& p, const Step& st, int f0, int grp,
                                              const float (&acc)[2][Cfg<T, CHP>::kNB][4],
                                              T* nxt, T* qout, T* out, const T* x,
                                              const T* first) {
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
        if (st.relu) v = fmaxf(v, 0.f);
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
        store4(out + ((size_t)r * KC + st.k * C + j) * CHP + c4, v);
      }
    }
  }
}

template <typename T, int CHP>
__global__ void __launch_bounds__(kThreads, Cfg<T, CHP>::kMinBlocks)
tilted_fusion_wide_kernel(Params p) {
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
                               packed_bytes<T, CHP>(L, p.ks0, p.out_ch)) +
          (size_t)cta * workspace_elems(CHP, R, C, L);
  T* slab[2] = {ws, ws + slab_elems(CHP, R, C)};
  T* queue = ws + 2 * slab_elems(CHP, R, C);  // (2, L-1, R, 2, CHP)
  const size_t qslot = (size_t)R * 2 * CHP, qpar = queue_slot_elems(CHP, R, L);
  const T* x = static_cast<const T*>(p.x) + (size_t)band * R * KC * p.c0p;
  const T* first = static_cast<const T*>(p.first) + (size_t)band * R * p.c0p;
  T* out = static_cast<T*>(p.out) + (size_t)band * R * KC * CHP;

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
          if (mine == 2) wide_epilogue<T, CHP, 2>(p, st, warp, grp, acc, nxt_b, qout, out, x, first);
          else if (mine == 1)
            wide_epilogue<T, CHP, 1>(p, st, warp, grp, acc, nxt_b, qout, out, x, first);
        }
      }
    }
  }
  cp_async_wait<0>();
}

using KernelFn = void (*)(Params);

struct Instance {
  KernelFn fn;
  int smem;
};

template <typename T, int CHP> Instance make_instance() {
  if constexpr (Cfg<T, CHP>::kWide)
    return {tilted_fusion_wide_kernel<T, CHP>, Cfg<T, CHP>::kSmemBytes};
  else
    return {tilted_fusion_kernel<T, CHP, false>, Cfg<T, CHP>::kSmemBytes};
}

// The instances built, for the padded widths the wrapper launches
// (tilted_fusion.py SUPPORTED_CHP; launch_chp pads a stack up to the next
// one): Chp 16 and 32 narrow, 48, 64, 96 and 128 wide.
#define K1_INSTANCES(X) X(16) X(32) X(48) X(64) X(96) X(128)

// The <dtype, Chp> instance (dtype 0 = float32, 1 = bfloat16) of out_ch
// outputs, or fn null: a mixed launch (out_ch past Chp 32) has one of its
// own, the narrow kernel with output groups.
Instance instance(int dtype, int chp, int out_ch) {
  if (out_ch != chp) {
    if (chp != 32) return {nullptr, 0};
    if (dtype == 0) return {tilted_fusion_kernel<float, 32, true>, Cfg<float, 32>::kSmemBytes};
    return {tilted_fusion_kernel<__nv_bfloat16, 32, true>, Cfg<__nv_bfloat16, 32>::kSmemBytes};
  }
#define K1_INSTANCE(N)                                                  \
  if (dtype == 0 && chp == N) return make_instance<float, N>();         \
  if (dtype == 1 && chp == N) return make_instance<__nv_bfloat16, N>();
  K1_INSTANCES(K1_INSTANCE)
#undef K1_INSTANCE
  return {nullptr, 0};
}

// The <dtype, chp> instance of out_ch outputs in *k, allowed the shared
// memory it takes.
cudaError_t prepare(int dtype, int chp, int out_ch, Instance* k) {
  *k = instance(dtype, chp, out_ch);
  if (!k->fn) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(k->fn, cudaFuncAttributeMaxDynamicSharedMemorySize, k->smem);
}

// Output rows of a full row block: at most kBlockPix pixels, and its
// window (rows + 2) x (C + 2) within kWinPix; 0 where C is too wide.
int block_rows(int C) {
  const int by_pix = kBlockPix / C, by_win = kWinPix / (C + 2) - 2;
  return by_pix < by_win ? by_pix : by_win;
}

template <typename T, int CHP>
cudaError_t launch_pack(const Params& p, cudaStream_t stream) {
  const size_t words = packed_bytes<T, CHP>(p.L, p.ks0, p.out_ch) / 4;
  const int grid = (int)((words + kThreads - 1) / kThreads);
  if constexpr (Cfg<T, CHP>::kWide)
    pack_slices_kernel<T, CHP><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(p.w), static_cast<uint32_t*>(p.ws), p.L, p.ks0);
  else
    pack_weights_kernel<T, CHP><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(p.w), static_cast<const T*>(p.bias),
        static_cast<uint32_t*>(p.ws), p.L, p.ks0, p.out_ch);
  return cudaGetLastError();
}

cudaError_t pack(int dtype, int chp, const Params& p, cudaStream_t stream) {
#define K1_PACK(N)                                                              \
  if (dtype == 0 && chp == N) return launch_pack<float, N>(p, stream);          \
  if (dtype == 1 && chp == N) return launch_pack<__nv_bfloat16, N>(p, stream);
  K1_INSTANCES(K1_PACK)
#undef K1_PACK
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Launch the weight packing and then B*S CTAs on `stream` (S segments per
// band, `warm` warm-up tiles for a restarted segment; ws holds the packed
// stages and then B*S workspaces, tilted_fusion.py::workspace_bytes);
// returns the launch's CUDA error code (0 = ok).  dtype: 0 = float32,
// 1 = bfloat16.  chp is the instance; out_ch the last layer's outputs and
// the pitch of w, bias and out: chp, or on a mixed launch of the Chp 32
// instance 48, 64, 96 or 128 (any multiple of 16 from 48 to 128).  Does not
// synchronise or allocate.
int tilted_fusion_launch(int dtype, const void* x, const void* first, const void* w,
                         const void* bias, const void* bounds, void* out, void* ws,
                         int B, int R, int K, int C, int c0p, int chp, int out_ch, int L, int W,
                         int relu_mask, int add_anchor, int in_ch, int repeats,
                         int replicate, int S, int warm, void* stream) {
  if (B == 0) return 0;
  if (S < 1 || S > K || warm < 0 || L < 1 || c0p < 1 || c0p > chp || c0p % 8 || C < 2 ||
      block_rows(C) < 1)
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
  const int kk = dtype == 0 ? 8 : 16;
  p.ks0 = (c0p + kk - 1) / kk;
  p.shift0 = 0;
  while ((1 << p.shift0) * 16 < p.ks0 * kk * (dtype == 0 ? 4 : 2)) ++p.shift0;
  p.rows_blk = block_rows(C);
  Instance k;
  cudaError_t e = prepare(dtype, chp, out_ch, &k);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  e = pack(dtype, chp, p, s);
  if (e != cudaSuccess) return (int)e;
  void* args[] = {&p};
  return (int)cudaLaunchKernel(reinterpret_cast<const void*>(k.fn), dim3(B * S), dim3(kThreads),
                               args, k.smem, s);
}

// Resident CTAs per SM of the <dtype, chp> instance of out_ch outputs on
// the current device (cudaOccupancyMaxActiveBlocksPerMultiprocessor at 256
// threads and its shared memory), written to *blocks; returns the CUDA
// error code.
int tilted_fusion_blocks_per_sm(int dtype, int chp, int out_ch, int* blocks) {
  Instance k;
  cudaError_t e = prepare(dtype, chp, out_ch, &k);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, k.fn, kThreads, k.smem);
}

const char* tilted_fusion_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
