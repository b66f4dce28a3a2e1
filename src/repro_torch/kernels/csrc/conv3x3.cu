// One SAME 3x3 conv layer on Hopper (sm_90a): the layer-by-layer baseline
// datapath, on the tensor cores.
//
// Replaces: src/repro/kernels/conv3x3.py::_kernel, the Pallas TPU kernel
// launched by conv3x3_call over a grid of column tiles of one whole band.
//
// What it computes, as the TPU kernel does: out = x (*) w + b over an
// (R, W, Ci) NHWC band with HWIO weights (3, 3, Ci, Co), SAME zero padding on
// all four sides, fp32 accumulation, the bias added in fp32, then the
// optional ReLU, then ONE rounding to the storage dtype at the store.
//
// What bounds it on this card, on the tensor cores (989 TFLOP/s bf16, 495
// TF32, 3.35 TB/s): a 360x640 map at 28 -> 28 channels is 3.25 GFLOP against
// one read of the input and one write of the output, 51.6 MB in fp32 and
// 25.8 MB in bf16.  bf16 is bound by bytes (7.7 us against 3.3 us of
// operations); fp32 through 3xTF32 (three TF32 products per fp32 product) by
// operations, 19.7 us.  The 3 -> 28 first layer is bound by bytes in both.
//
// The design:
//   * persistent CTAs, weights resident.  The grid is at most the SM count
//     times the resident CTAs per SM (the wrapper asks
//     conv3x3_blocks_per_sm); each CTA loads the whole weight tensor into
//     shared memory once, already in the mma B-fragment layout, zero-padded
//     to K = 32 and N = 32 (fp32: split into TF32 hi and lo words), then
//     walks the output tiles t = blockIdx.x, blockIdx.x + gridDim.x, ...
//     A tile is kTileRows x kTileCols = 8 x 32 output pixels, 16 m16
//     fragments of 16 pixels of one row; each of the 8 warps owns a row.
//   * asynchronous, double-buffered input windows.  Tile t's (10, 34, Ci)
//     window, zero outside the image, comes into shared memory with
//     cp.async while the CTA computes the tile before it.  A pixel's row of
//     the window is padded to 36 32-bit words in fp32 and 20 in bf16, so the
//     8 rows of each 8x8 matrix an ldmatrix reads fall on distinct banks.
//     The copy granule is the largest of 16, 8 and 4 bytes that divides a
//     pixel's bytes and the input's address: 16 at Ci = 28 fp32 (112 B), 8
//     at Ci = 28 bf16 (56 B), 4 at Ci = 3 fp32 (12 B).  A bf16 map with an
//     odd Ci has 2-byte pixel boundaries that no cp.async size meets; it is
//     read with plain loads into the same buffer, at the same point (ahead
//     of the tile that reads it, but not overlapped with the compute).
//     Channels Ci..K-1 of every pixel are zeroed once and never written,
//     and a copy of a pixel outside the image has source size 0 (cp.async's
//     zero fill).  Each thread walks its copies without dividing by the
//     runtime copies-per-pixel.
//   * tensor cores through mma.sync.  Per tap (dy, dx), A is the window
//     shifted by (dy, dx), 16 pixels x 32 channels per fragment, loaded with
//     one ldmatrix.x4 (an fp32 is two b16 halves, so the same instruction
//     gives the m16k8 TF32 fragment), and B is W[dy, dx], 32 x 32.  bf16:
//     m16n8k16 with fp32 accumulation; bf16 products are exact in fp32.
//     fp32: m16n8k8 TF32 three times (3xTF32): each operand splits into
//     hi = tf32(a) and lo = tf32(a - hi), rounded as cvt.rna.tf32.f32 rounds
//     (to nearest, ties away; tf32_rna does it in two integer operations),
//     and the sum is lo*hi + hi*lo + hi*hi, small terms first.  Single TF32
//     keeps about 11 bits of a product and is not fp32; 3xTF32 keeps ~22 and
//     holds the fp32 tolerance (2e-5 + 1e-5 |want|) with room to spare.
//     With Ci <= 3 the 9 taps fold into K (k = tap * Ci + ci, 27 -> 32 at
//     Ci = 3) instead of padding each tap's 3 channels to 32: one pass of
//     K = 32 instead of nine, from a window of 4-element pixels.
//     Why mma.sync and not wgmma: N is only 32 (Co <= 32), and on the tensor
//     cores the bf16 layer is bound by bytes (7.7 us), not by the MMA issue
//     rate (3.3 us).  wgmma's 64-row warpgroup tiles and swizzled
//     shared-memory descriptors are left for a later change.  On an H100
//     the fp32 layer's loop time splits about evenly between the 3xTF32
//     MMAs and the fragment loads and hi/lo splits that feed them, while
//     the bf16 MMAs hide entirely (tools/k2_ablation.py, PERF.md).
//   * epilogue through shared memory.  Each warp adds the fp32 bias, applies
//     the ReLU and rounds once into its own staging run, laid out as its
//     tile row's (32, Co) NHWC run is in device memory and at the same
//     address modulo 16; it then stores the run with 16-byte vector stores
//     (32 lanes = 512 contiguous bytes) and element stores at the ends.
//     Ragged R and W shorten or skip a run; Co = 27 needs nothing special.
//
// Shared memory per CTA and resident CTAs per SM (their registers bound
// the folded ones): fp32 per tap 204,544 B, 1; bf16 per tap 89,344 B, 2;
// fp32 folded 51,968 B, 2; bf16 folded 24,000 B, 3.
// Limits: Ci, Co <= 32 for these persistent instances (the window row and
// B fragments are sized for 32).  A wider layer (Ci or Co up to 128, ABPN
// x4's 28 -> 48 among them) runs the wide instance below: n-groups of 32
// outputs on a second grid axis and Ci in k-chunks of 32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileRows = 8;   // output rows of a tile
constexpr int kTileCols = 32;  // output columns of a tile: two m16 fragments a row
constexpr int kWinCols = kTileCols + 2;
constexpr int kWinPix = (kTileRows + 2) * kWinCols;  // 340 window pixels
constexpr int kTileFrags = kTileRows * kTileCols / 16;  // 16 m16 fragments a tile
constexpr int kMaxChannels = 32;                     // Ci, Co limit (conv3x3.py MAX_CHANNELS)
constexpr int kFoldMaxCi = 3;                        // 9 * Ci <= 32: taps fold into K

// The MMA of each storage dtype.
template <typename T> struct Mma;
template <> struct Mma<float> {  // m16n8k8 TF32, three times (3xTF32)
  static constexpr int kSteps = 4;      // k-steps of 8 over K = 32
  static constexpr int kBQuads = 4;     // uint4 of B per lane and k-step: hi, lo
  static constexpr int kPixWords = 36;  // a window pixel, taps not folded: 32 + 4
};
template <> struct Mma<__nv_bfloat16> {  // m16n8k16 bf16
  static constexpr int kSteps = 2;      // k-steps of 16 over K = 32
  static constexpr int kBQuads = 2;
  static constexpr int kPixWords = 20;  // 32 channels + 8
};

// What each instance <dtype, taps folded> is built for: m16 fragments a
// warp (so 16 / kFrags warps a CTA) and the resident CTAs per SM its
// registers are bounded for (chosen by timing the alternatives at the ABPN
// layer shapes on an H100: one m16 fragment a warp, or more CTAs, was no
// faster, and a tighter bound spilled).  With the taps folded into K
// (Ci <= 3) a window pixel is 4 elements, so weights and windows are small
// and several CTAs share an SM.
template <typename T, bool kFold> struct Plan {
  static constexpr int kFrags = 2;
  static constexpr int kMinBlocks = sizeof(T) == 4 ? (kFold ? 2 : 1) : (kFold ? 3 : 2);
};

template <typename T, bool kFold> struct Layout {
  static constexpr int kThreads = 32 * kTileFrags / Plan<T, kFold>::kFrags;
  static constexpr int kWarps = kThreads / 32;
  static constexpr int kTaps = kFold ? 1 : 9;
  static constexpr int kPixWords = kFold ? (int)sizeof(T) : Mma<T>::kPixWords;
  static constexpr int kPixElems = kPixWords * 4 / (int)sizeof(T);
  static constexpr int kWeightBytes = kTaps * Mma<T>::kSteps * Mma<T>::kBQuads * 32 * 16;
  static constexpr int kWindowBytes = kWinPix * kPixWords * 4;
  // a warp's staging run: its 16 * kFrags pixels x up to 32 outputs, plus
  // 16 bytes so that it can start at its global address modulo 16
  static constexpr int kStageBytes =
      16 * Plan<T, kFold>::kFrags * kMaxChannels * (int)sizeof(T) + 16;
  static constexpr int kSmemBytes = kWeightBytes + 2 * kWindowBytes + kWarps * kStageBytes;
  static_assert(kWeightBytes % 16 == 0 && kWindowBytes % 16 == 0 && kStageBytes % 16 == 0,
                "16-byte aligned sections");
  static_assert(kPixElems > (kFold ? kFoldMaxCi : kMaxChannels),
                "the last element of a window pixel is a zero pad");
  static_assert(kWindowBytes >= 9 * (kFold ? kFoldMaxCi : kMaxChannels) * kMaxChannels *
                                    (int)sizeof(T), "window 1 holds the raw weights");
};

struct Params {
  const void* x;     // (R, W, Ci), storage dtype
  const void* w;     // (3, 3, Ci, Co), storage dtype
  const void* bias;  // (Co,), storage dtype
  void* out;         // (R, W, Co), storage dtype
  int R, W, ci, co, relu;
  int tiles_c, tiles;  // column tiles, all tiles
  int gran;            // bytes per window copy: 16, 8, 4 (cp.async) or 2 (plain)
};

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

// src_bytes = 0 fills the N destination bytes with zeros
template <int N>
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src, int src_bytes) {
  if constexpr (N == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(dst), "l"(src), "r"(src_bytes));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n"
                 :: "r"(dst), "l"(src), "n"(N), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Four 8x8 b16 matrices from shared memory: lanes 8i..8i+7 give the row
// addresses of matrix i, and matrix i lands in register i.  An m16k8 TF32
// A fragment is the same four matrices with each fp32 read as two b16, so
// one ldmatrix loads an A fragment in either dtype.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&a)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(addr));
}

// The TF32 value of fp32 bits, rounded as cvt.rna.tf32.f32 rounds (to
// nearest, ties away from zero; the 13 low mantissa bits cleared) for every
// finite input, in two integer operations: half of the cleared unit added
// to the magnitude bits rounds the magnitude half up, whatever the sign.
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

// Index into w of B[k][n] for tap t (folded: k = tap * Ci + ci over one
// "tap"), or -1 where B is zero padding.
template <bool kFold>
__device__ __forceinline__ int weight_index(const Params& p, int t, int k, int n) {
  if (k >= (kFold ? 9 * p.ci : p.ci) || n >= p.co) return -1;
  return ((kFold ? 0 : t * p.ci) + k) * p.co + n;
}

// The (3, 3, Ci, Co) weights, copied as they are into `raw` in shared
// memory in two steps: load() issues all of a thread's loads (at most 36,
// or 4 with the taps folded) into registers, so the CTA waits for device memory once, and store()
// stores them once they arrive.
template <typename T, int kThreads, int kMaxCi>
struct RawWeights {
  static constexpr int kPer = (9 * kMaxCi * kMaxChannels + kThreads - 1) / kThreads;
  T v[kPer];

  __device__ __forceinline__ void load(const Params& p) {
    const int n = 9 * p.ci * p.co;
    const T* w = static_cast<const T*>(p.w);
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int i = threadIdx.x + u * kThreads;
      if (i < n) v[u] = w[i];
    }
  }
  __device__ __forceinline__ void store(const Params& p, T* raw) const {
    const int n = 9 * p.ci * p.co;
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int i = threadIdx.x + u * kThreads;
      if (i < n) raw[i] = v[u];
    }
  }
};

// The weights into shared memory in the B-fragment layout, from `raw`.
// For tap t and k-step s, uint4 number q of lane l sits at
// ((t * kSteps + s) * kBQuads + q) * 32 + l, so a warp's 128-bit loads are
// conflict-free.  A lane's words u = 4q + e:
// fp32: q < 2 hi, q >= 2 lo; n-fragment j = (u % 8) / 2, register r = u % 2,
//       holding B[8s + tig + 4r][8j + g];
// bf16: j = u / 2, r = u % 2, holding B[k][8j + g] (low half) and
//       B[k + 1][8j + g] with k = 16s + 2 tig + 8r.
// Thread i builds word e of lane l for (l, e) = ((i / 4) % 32, i % 4), and
// both the hi and the lo word of a fp32 weight.
template <typename T, bool kFold>
__device__ void build_weights(const Params& p, const T* raw, uint32_t* ws) {
  using L = Layout<T, kFold>;
  constexpr int kS = Mma<T>::kSteps;
  constexpr int kQB = sizeof(T) == 4 ? 2 : Mma<T>::kBQuads;  // quads built per (t, s)
  const int e = threadIdx.x & 3, lane = (threadIdx.x >> 2) & 31;
  const int g = lane >> 2, tig = lane & 3;
  for (int i = threadIdx.x >> 7; i < L::kTaps * kS * kQB; i += L::kThreads >> 7) {
    const int q = i % kQB, ts = i / kQB, t = ts / kS, s = ts % kS;
    const int u = 4 * q + e, r = u & 1, n = 8 * (u >> 1) + g;
    const int at = ((ts * Mma<T>::kBQuads + q) * 32 + lane) * 4 + e;  // the word in ws
    if constexpr (sizeof(T) == 4) {
      const int idx = weight_index<kFold>(p, t, 8 * s + tig + 4 * r, n);
      uint32_t hi, lo;
      tf32_split(idx < 0 ? 0u : __float_as_uint(raw[idx]), hi, lo);
      ws[at] = hi;
      ws[at + 2 * 32 * 4] = lo;  // two uint4 further on
    } else {
      const int k = 16 * s + 2 * tig + 8 * r;
      const uint16_t* w = reinterpret_cast<const uint16_t*>(raw);
      const int i0 = weight_index<kFold>(p, t, k, n), i1 = weight_index<kFold>(p, t, k + 1, n);
      ws[at] = (i0 < 0 ? 0u : w[i0]) | ((i1 < 0 ? 0u : (uint32_t)w[i1]) << 16);
    }
  }
}

// This thread's window copies: copy i = pix * gpp + gi for i = tid, tid +
// kThreads, ...; the first, and the step from one to the next as
// (pixels, copies) so that no copy divides by the runtime gpp.
struct CopyWalk {
  int gpp, pix0, gi0, dpix, dgi;
};

template <typename T, bool kFold>
__device__ CopyWalk copy_walk(const Params& p) {
  CopyWalk w;
  w.gpp = p.ci * (int)sizeof(T) / p.gran;
  w.pix0 = threadIdx.x / w.gpp;
  w.gi0 = threadIdx.x - w.pix0 * w.gpp;
  w.dpix = Layout<T, kFold>::kThreads / w.gpp;
  w.dgi = Layout<T, kFold>::kThreads - w.dpix * w.gpp;
  return w;
}

// Issue the copies of a tile's window into `win`: window rows
// r0-1 .. r0+kTileRows, columns c0-1 .. c0+kTileCols, zero outside the map.
template <typename T, bool kFold, int G>
__device__ void load_window_g(const Params& p, const CopyWalk& w, char* win, int r0, int c0) {
  using L = Layout<T, kFold>;
  const char* x = static_cast<const char*>(p.x);
  const int pixel_bytes = p.ci * (int)sizeof(T);
  const uint32_t base = smem_addr(win);
  for (int pix = w.pix0, gi = w.gi0; pix < kWinPix;) {
    const int row = pix / kWinCols, col = pix - row * kWinCols;
    const int gr = r0 - 1 + row, gc = c0 - 1 + col;
    const bool in = gr >= 0 && gr < p.R && gc >= 0 && gc < p.W;
    const char* src = in ? x + (size_t)(gr * p.W + gc) * pixel_bytes + gi * G : x;
    const int dst = pix * L::kPixWords * 4 + gi * G;
    if constexpr (G >= 4) {
      cp_async<G>(base + dst, src, in ? G : 0);
    } else {  // 2-byte pixel boundaries (bf16, odd Ci): a plain load
      *reinterpret_cast<uint16_t*>(win + dst) = in ? *reinterpret_cast<const uint16_t*>(src) : 0;
    }
    pix += w.dpix;
    gi += w.dgi;
    if (gi >= w.gpp) {
      gi -= w.gpp;
      ++pix;
    }
  }
}

template <typename T, bool kFold>
__device__ void load_window(const Params& p, const CopyWalk& w, char* win, int tile) {
  const int r0 = tile / p.tiles_c * kTileRows, c0 = tile % p.tiles_c * kTileCols;
  switch (p.gran) {
    case 16: load_window_g<T, kFold, 16>(p, w, win, r0, c0); break;
    case 8: load_window_g<T, kFold, 8>(p, w, win, r0, c0); break;
    case 4: load_window_g<T, kFold, 4>(p, w, win, r0, c0); break;
    default: load_window_g<T, kFold, 2>(p, w, win, r0, c0); break;
  }
}

// Window element offset (from a fragment row's own pixel) of folded K index
// k = tap * Ci + ci; beyond 9 * Ci, the pixel's last element, a zero pad.
template <typename T>
__device__ __forceinline__ int fold_offset(int k, int ci) {
  constexpr int kPE = Layout<T, true>::kPixElems;
  if (k >= 9 * ci) return kPE - 1;
  const int tap = k / ci;
  return ((tap / 3) * kWinCols + tap % 3) * kPE + k % ci;
}

template <typename T, bool kFold>
__global__ void __launch_bounds__(Layout<T, kFold>::kThreads, Plan<T, kFold>::kMinBlocks)
conv3x3_kernel(Params p) {
  using L = Layout<T, kFold>;
  constexpr int kS = Mma<T>::kSteps, kQ = Mma<T>::kBQuads, kPW = L::kPixWords;
  constexpr int kPE = L::kPixElems, kF = Plan<T, kFold>::kFrags;
  constexpr bool kF32 = sizeof(T) == 4;
  extern __shared__ uint4 smem[];
  char* base = reinterpret_cast<char*>(smem);
  const uint4* wsm = smem;
  char* win0 = base + L::kWeightBytes;
  char* stage = win0 + 2 * L::kWindowBytes;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tig = lane & 3;
  // this warp's kF fragments of a tile: tile row `wrow`, columns from wcol
  const int wrow = warp * kF / 2, wcol = 16 * (warp * kF % 2);

  // Channels Ci..K-1 of every window pixel are zero from here on: buffer 0
  // now, buffer 1 once it has served as the weights' scratch.
  RawWeights<T, L::kThreads, kFold ? kFoldMaxCi : kMaxChannels> rw;
  rw.load(p);  // in flight while the first window is zeroed and requested
  uint4* zero0 = reinterpret_cast<uint4*>(win0);
  uint4* zero1 = reinterpret_cast<uint4*>(win0 + L::kWindowBytes);
  for (int i = tid; i < L::kWindowBytes / 16; i += L::kThreads) zero0[i] = make_uint4(0, 0, 0, 0);
  __syncthreads();  // the zeros are in place before any copy lands
  int tile = blockIdx.x;
  const CopyWalk walk = copy_walk<T, kFold>(p);
  load_window<T, kFold>(p, walk, win0, tile);  // the grid has at most one CTA per tile
  cp_async_commit();
  T* raw = reinterpret_cast<T*>(zero1);
  rw.store(p, raw);
  __syncthreads();
  build_weights<T, kFold>(p, raw, reinterpret_cast<uint32_t*>(smem));
  __syncthreads();  // the scratch is read; the first loop barrier orders the zeros
  for (int i = tid; i < L::kWindowBytes / 16; i += L::kThreads) zero1[i] = make_uint4(0, 0, 0, 0);

  // this thread's output channels 8j + 2 tig + e, and its bias for them
  float bias[4][2];
  const T* bsrc = static_cast<const T*>(p.bias);
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int co = 8 * j + 2 * tig + e;
      bias[j][e] = co < p.co ? to_f(bsrc[co]) : 0.f;
    }
  // per tap: this lane's ldmatrix row, pixel m = r + 8 (i & 1) of matrix
  // i = lane / 8 at k offset 16 (i / 2) bytes
  const int lane_off = ((lane & 7) + 8 * ((lane >> 3) & 1)) * kPW * 4 + 16 * (lane >> 4);
  // folded K: window offsets of this thread's A elements for each k-step
  // (fp32: k = 8s + tig + {0, 4}; bf16: k = 16s + 2 tig + {0, 1, 8, 9})
  constexpr int kOffs = kF32 ? 2 : 4;
  int off[kS][kOffs];
#pragma unroll
  for (int s = 0; s < kS; ++s)
#pragma unroll
    for (int h = 0; h < kOffs; ++h)
      off[s][h] = kFold ? fold_offset<T>(kF32 ? 8 * s + tig + 4 * h
                                              : 16 * s + 2 * tig + (h & 1) + 8 * (h >> 1), p.ci)
                        : 0;

  for (int it = 0; tile < p.tiles; ++it, tile += gridDim.x) {
    const char* win = win0 + (it & 1) * L::kWindowBytes;
    cp_async_wait_all();
    __syncthreads();  // this tile's window has landed; the other buffer is free
    if (tile + (int)gridDim.x < p.tiles)
      load_window<T, kFold>(p, walk, win0 + ((it + 1) & 1) * L::kWindowBytes, tile + gridDim.x);
    cp_async_commit();

    float acc[kF][4][4];
#pragma unroll
    for (int f = 0; f < kF; ++f)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[f][j][c] = 0.f;

    const uint32_t win_addr = smem_addr(win);
#pragma unroll 1
    for (int dy = 0; dy < (kFold ? 1 : 3); ++dy) {
#pragma unroll
      for (int dx = 0; dx < (kFold ? 1 : 3); ++dx) {
        const int t = dy * 3 + dx;
#pragma unroll
        for (int s = 0; s < kS; ++s) {
          uint32_t bw[4 * kQ];
#pragma unroll
          for (int q = 0; q < kQ; ++q) {
            const uint4 v = wsm[((t * kS + s) * kQ + q) * 32 + lane];
            bw[4 * q] = v.x; bw[4 * q + 1] = v.y; bw[4 * q + 2] = v.z; bw[4 * q + 3] = v.w;
          }
#pragma unroll
          for (int f = 0; f < kF; ++f) {
            // the fragment's 16 rows are window pixels pix0 .. pix0 + 15
            const int pix0 = (wrow + dy) * kWinCols + wcol + 16 * f + dx, pix = pix0 + g;
            uint32_t a[4];
            if constexpr (kFold && kF32) {
              const float* pe = reinterpret_cast<const float*>(win) + pix * kPE;
              a[0] = __float_as_uint(pe[off[s][0]]);
              a[1] = __float_as_uint(pe[8 * kPE + off[s][0]]);
              a[2] = __float_as_uint(pe[off[s][1]]);
              a[3] = __float_as_uint(pe[8 * kPE + off[s][1]]);
            } else if constexpr (kFold) {
              const uint16_t* pe = reinterpret_cast<const uint16_t*>(win) + pix * kPE;
              a[0] = pe[off[s][0]] | ((uint32_t)pe[off[s][1]] << 16);
              a[1] = pe[8 * kPE + off[s][0]] | ((uint32_t)pe[8 * kPE + off[s][1]] << 16);
              a[2] = pe[off[s][2]] | ((uint32_t)pe[off[s][3]] << 16);
              a[3] = pe[8 * kPE + off[s][2]] | ((uint32_t)pe[8 * kPE + off[s][3]] << 16);
            } else {  // 32 bytes per k-step in both dtypes (8 fp32 or 16 bf16)
              ldmatrix_x4(a, win_addr + pix0 * kPW * 4 + 32 * s + lane_off);
            }
            if constexpr (kF32) {
              uint32_t ah[4], al[4];
#pragma unroll
              for (int c = 0; c < 4; ++c) tf32_split(a[c], ah[c], al[c]);
#pragma unroll
              for (int j = 0; j < 4; ++j) {
                mma_tf32(acc[f][j], al, bw[2 * j], bw[2 * j + 1]);
                mma_tf32(acc[f][j], ah, bw[8 + 2 * j], bw[8 + 2 * j + 1]);
                mma_tf32(acc[f][j], ah, bw[2 * j], bw[2 * j + 1]);
              }
            } else {
#pragma unroll
              for (int j = 0; j < 4; ++j) mma_bf16(acc[f][j], a, bw[2 * j], bw[2 * j + 1]);
            }
          }
        }
      }
    }

    // Epilogue: the warp stages its 16 * kF pixels of tile row `wrow` as
    // their NHWC run, then stores the run.
    const int r0 = tile / p.tiles_c * kTileRows, c0 = tile % p.tiles_c * kTileCols + wcol;
    const int row = r0 + wrow, ncols = min(16 * kF, p.W - c0);
    if (row >= p.R || ncols <= 0) continue;  // warp-uniform
    char* gdst = static_cast<char*>(p.out) + ((size_t)row * p.W + c0) * p.co * sizeof(T);
    const int mis = (int)(reinterpret_cast<uintptr_t>(gdst) & 15);
    char* srun = stage + warp * L::kStageBytes + mis;  // == gdst modulo 16
    T* st = reinterpret_cast<T*>(srun);
#pragma unroll
    for (int f = 0; f < kF; ++f)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int col = 16 * f + g + 8 * (c >> 1), co = 8 * j + 2 * tig + (c & 1);
          if (co < p.co) {
            float y = acc[f][j][c] + bias[j][c & 1];
            if (p.relu) y = fmaxf(y, 0.f);
            st[col * p.co + co] = from_f<T>(y);
          }
        }
    __syncwarp();
    const int nbytes = ncols * p.co * (int)sizeof(T);
    const int head = min((16 - mis) & 15, nbytes);
    const int body_end = head + ((nbytes - head) & ~15);
    for (int b = head + 16 * lane; b < body_end; b += 16 * 32)
      *reinterpret_cast<uint4*>(gdst + b) = *reinterpret_cast<const uint4*>(srun + b);
    constexpr int kE = (int)sizeof(T);
    for (int b = kE * lane; b < head; b += kE * 32)
      *reinterpret_cast<T*>(gdst + b) = *reinterpret_cast<const T*>(srun + b);
    for (int b = body_end + kE * lane; b < nbytes; b += kE * 32)
      *reinterpret_cast<T*>(gdst + b) = *reinterpret_cast<const T*>(srun + b);
    __syncwarp();
  }
  cp_async_wait_all();
}

// ---------------------------------------------------------------------------
// Wide layers: Ci or Co above 32 (both at most 128)
// ---------------------------------------------------------------------------
// One CTA a (tile, n-group) pair: blockIdx.x walks the same 8 x 32 output
// tiles, blockIdx.y the n-groups of 32 outputs.  Ci is cut into k-chunks of
// 32 channels; for each chunk the CTA copies the tile's (10, 34, 32) window
// of the chunk and the chunk's weights for its n-group (pre-packed once a
// launch by pack_wide_kernel, in the B-fragment layout build_weights gives
// the per-tap instance) into shared memory, waits for both, and runs the
// chunk's 9 taps x k-steps on the tensor cores: each (chunk, tap)'s k-steps
// into a partial from zero (3xTF32 terms in fp32), added to one fp32
// accumulator carried across taps and chunks.  Then the bias, the ReLU and
// one rounding, stored from the fragments.  Neither the
// window nor the weights are double-buffered: a first design that is right
// (fp32: 122,688 B, one CTA an SM; bf16: 64,064 B, three).
constexpr int kWideMaxChannels = 128;  // Ci, Co limit of the wide instance (MAX_CHANNELS)
constexpr int kWideThreads = 256;      // 8 warps x 2 fragments, as the per-tap instance

template <typename T> struct Wide {
  static constexpr int kPixWords = Mma<T>::kPixWords;  // a chunk's 32 channels, padded
  static constexpr int kWindowBytes = kWinPix * kPixWords * 4;
  static constexpr int kWeightBytes = 9 * Mma<T>::kSteps * Mma<T>::kBQuads * 32 * 16;
  static constexpr int kSmemBytes = kWeightBytes + kWindowBytes;
  static constexpr int kMinBlocks = sizeof(T) == 4 ? 1 : 2;
};

// Packed weights of a wide launch: for n-group grp and k-chunk c a block of
// Wide<T>::kWeightBytes, blocks in (grp, c) order; inside it, as
// build_weights lays out the per-tap instance's (with k = 32 c + the chunk's
// k and n = 32 grp + the group's n; zero past Ci or Co).
template <typename T>
__global__ void pack_wide_kernel(Params p, uint32_t* __restrict__ packed, int chunks,
                                 int groups) {
  constexpr int kS = Mma<T>::kSteps, kQ = Mma<T>::kBQuads;
  const size_t total = (size_t)groups * chunks * 9 * kS * kQ * 32 * 4;
  const T* w = static_cast<const T*>(p.w);
  auto weight = [&](int t, int k, int n) -> T {
    return k < p.ci && n < p.co ? w[((size_t)t * p.ci + k) * p.co + n] : from_f<T>(0.f);
  };
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    const int e = (int)(i & 3), lane = (int)((i >> 2) & 31);
    size_t rest = i >> 7;
    const int q = (int)(rest % kQ); rest /= kQ;
    const int s = (int)(rest % kS); rest /= kS;
    const int t = (int)(rest % 9); rest /= 9;
    const int c = (int)(rest % chunks), grp = (int)(rest / chunks);
    const int g = lane >> 2, tig = lane & 3, u = 4 * q + e;
    uint32_t v;
    if constexpr (sizeof(T) == 4) {  // q < 2 hi words, q >= 2 lo words
      const int uu = u & 7, n = 32 * grp + 8 * (uu >> 1) + g;
      const int k = 32 * c + 8 * s + tig + 4 * (uu & 1);
      uint32_t hi, lo;
      tf32_split(__float_as_uint(to_f(weight(t, k, n))), hi, lo);
      v = u < 8 ? hi : lo;
    } else {
      const int n = 32 * grp + 8 * (u >> 1) + g, k = 32 * c + 16 * s + 2 * tig + 8 * (u & 1);
      const T lo = weight(t, k, n), hi = weight(t, k + 1, n);
      v = (uint32_t)*reinterpret_cast<const uint16_t*>(&lo) |
          ((uint32_t)*reinterpret_cast<const uint16_t*>(&hi) << 16);
    }
    packed[i] = v;
  }
}

// Issue the copies of k-chunk c of a tile's window into `win` (window rows
// r0-1 .. r0+kTileRows, columns c0-1 .. c0+kTileCols): the chunk's 32
// channels of every pixel in copies of G bytes, zero outside the map and
// past Ci (cp.async's zero fill; plain 2-byte loads where G = 2).
template <typename T, int G>
__device__ void load_wide_window(const Params& p, char* win, int r0, int c0, int c) {
  constexpr int kPer = 32 * (int)sizeof(T) / G;  // copies a pixel's chunk
  const char* x = static_cast<const char*>(p.x);
  const int pixel_bytes = p.ci * (int)sizeof(T);
  const uint32_t base = smem_addr(win);
  for (int i = threadIdx.x; i < kWinPix * kPer; i += kWideThreads) {
    const int pix = i / kPer, gi = i - pix * kPer;
    const int row = pix / kWinCols, col = pix - row * kWinCols;
    const int gr = r0 - 1 + row, gc = c0 - 1 + col;
    const int ch = 32 * c + gi * G / (int)sizeof(T);  // the copy's first channel
    const bool in = gr >= 0 && gr < p.R && gc >= 0 && gc < p.W && ch < p.ci;
    const char* src = in ? x + (size_t)(gr * p.W + gc) * pixel_bytes + ch * sizeof(T) : x;
    const int dst = pix * Wide<T>::kPixWords * 4 + gi * G;
    if constexpr (G >= 4) {
      cp_async<G>(base + dst, src, in ? G : 0);
    } else {
      *reinterpret_cast<uint16_t*>(win + dst) = in ? *reinterpret_cast<const uint16_t*>(src) : 0;
    }
  }
}

template <typename T>
__device__ void load_wide_window_any(const Params& p, char* win, int r0, int c0, int c) {
  switch (p.gran) {
    case 16: load_wide_window<T, 16>(p, win, r0, c0, c); break;
    case 8: load_wide_window<T, 8>(p, win, r0, c0, c); break;
    case 4: load_wide_window<T, 4>(p, win, r0, c0, c); break;
    default: load_wide_window<T, 2>(p, win, r0, c0, c); break;
  }
}

template <typename T>
__global__ void __launch_bounds__(kWideThreads, Wide<T>::kMinBlocks)
conv3x3_wide_kernel(Params p, const uint4* __restrict__ packed, int chunks) {
  using Wd = Wide<T>;
  constexpr int kS = Mma<T>::kSteps, kQ = Mma<T>::kBQuads, kPW = Wd::kPixWords;
  constexpr int kF = 2;
  constexpr bool kF32 = sizeof(T) == 4;
  extern __shared__ uint4 smem[];
  const uint4* wsm = smem;
  char* win = reinterpret_cast<char*>(smem) + Wd::kWeightBytes;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int wrow = warp * kF / 2, wcol = 16 * (warp * kF % 2);
  const int tile = blockIdx.x, grp = blockIdx.y;
  const int r0 = tile / p.tiles_c * kTileRows, c0 = tile % p.tiles_c * kTileCols;
  const int lane_off = ((lane & 7) + 8 * ((lane >> 3) & 1)) * kPW * 4 + 16 * (lane >> 4);
  const uint32_t win_addr = smem_addr(win);

  float acc[kF][4][4];
#pragma unroll
  for (int f = 0; f < kF; ++f)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[f][j][c] = 0.f;

  for (int c = 0; c < chunks; ++c) {
    if (c > 0) __syncthreads();  // the last chunk's window and weights are read
    load_wide_window_any<T>(p, win, r0, c0, c);
    const uint4* src = packed + ((size_t)grp * chunks + c) * (Wd::kWeightBytes / 16);
    const uint32_t wdst = smem_addr(smem);
    for (int i = tid; i < Wd::kWeightBytes / 16; i += kWideThreads)
      cp_async<16>(wdst + 16 * i, src + i, 16);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();
#pragma unroll 1
    for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        const int t = dy * 3 + dx;
        // the tap's k-steps from zero, then one fp32 add: the tensor cores
        // do not round their fp32 accumulation to nearest, and one chained
        // accumulator over the 432 3xTF32 MMAs of a 128 -> 128 element
        // drifted 1.3e-4 from the plain sum on an H100, past K2's fp32
        // tolerance
        float part[kF][4][4];
#pragma unroll
        for (int f = 0; f < kF; ++f)
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) part[f][j][e] = 0.f;
#pragma unroll
        for (int s = 0; s < kS; ++s) {
          uint32_t bw[4 * kQ];
#pragma unroll
          for (int q = 0; q < kQ; ++q) {
            const uint4 v = wsm[((t * kS + s) * kQ + q) * 32 + lane];
            bw[4 * q] = v.x; bw[4 * q + 1] = v.y; bw[4 * q + 2] = v.z; bw[4 * q + 3] = v.w;
          }
#pragma unroll
          for (int f = 0; f < kF; ++f) {
            const int pix0 = (wrow + dy) * kWinCols + wcol + 16 * f + dx;
            uint32_t a[4];
            ldmatrix_x4(a, win_addr + pix0 * kPW * 4 + 32 * s + lane_off);
            if constexpr (kF32) {
              uint32_t ah[4], al[4];
#pragma unroll
              for (int e = 0; e < 4; ++e) tf32_split(a[e], ah[e], al[e]);
#pragma unroll
              for (int j = 0; j < 4; ++j) {
                mma_tf32(part[f][j], al, bw[2 * j], bw[2 * j + 1]);
                mma_tf32(part[f][j], ah, bw[8 + 2 * j], bw[8 + 2 * j + 1]);
                mma_tf32(part[f][j], ah, bw[2 * j], bw[2 * j + 1]);
              }
            } else {
#pragma unroll
              for (int j = 0; j < 4; ++j) mma_bf16(part[f][j], a, bw[2 * j], bw[2 * j + 1]);
            }
          }
        }
#pragma unroll
        for (int f = 0; f < kF; ++f)
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[f][j][e] += part[f][j][e];
      }
    }
  }

  // Epilogue: accumulator e of n block j holds pixel 16 f + g + 8 (e >> 1)
  // of the warp's tile row, output channel 32 grp + 8 j + 2 tig + (e & 1).
  const int row = r0 + wrow;
  if (row >= p.R) return;
  const T* bsrc = static_cast<const T*>(p.bias);
  T* out = static_cast<T*>(p.out);
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int co = 32 * grp + 8 * j + 2 * tig + (e & 1);
      if (co >= p.co) continue;
      const float bias = to_f(bsrc[co]);
#pragma unroll
      for (int f = 0; f < kF; ++f) {
        const int col = c0 + wcol + 16 * f + g + 8 * (e >> 1);
        if (col >= p.W) continue;
        float y = acc[f][j][e] + bias;
        if (p.relu) y = fmaxf(y, 0.f);
        out[((size_t)row * p.W + col) * p.co + co] = from_f<T>(y);
      }
    }
}

using KernelFn = void (*)(Params);

struct Instance {
  KernelFn fn;
  int threads, smem;
};

template <typename T, bool kFold> Instance make_instance() {
  using L = Layout<T, kFold>;
  return {conv3x3_kernel<T, kFold>, L::kThreads, L::kSmemBytes};
}

// The instance for (dtype, ci) in *k, allowed the shared memory it takes.
cudaError_t prepare(int dtype, int ci, Instance* k) {
  const bool fold = ci <= kFoldMaxCi;
  if (dtype == 0) *k = fold ? make_instance<float, true>() : make_instance<float, false>();
  else if (dtype == 1)
    *k = fold ? make_instance<__nv_bfloat16, true>() : make_instance<__nv_bfloat16, false>();
  else return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(k->fn, cudaFuncAttributeMaxDynamicSharedMemorySize, k->smem);
}

// The widest cp.async size (16, 8, 4 bytes) that both a pixel's bytes and
// the input's address are multiples of; 2 where none is (bf16, odd Ci).
int copy_granule(const void* x, int pixel_bytes) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(x);
  for (int g = 16; g >= 4; g /= 2)
    if (pixel_bytes % g == 0 && a % g == 0) return g;
  return 2;
}

}  // namespace

extern "C" {

// Launch min(ctas, tiles) persistent CTAs on `stream`; returns the launch's
// CUDA error code (0 = ok).  dtype: 0 = float32, 1 = bfloat16.  Does not
// synchronise or allocate.
int conv3x3_launch(int dtype, const void* x, const void* w, const void* bias, void* out,
                   int R, int W, int ci, int co, int relu, int ctas, void* stream) {
  if (R <= 0 || W <= 0) return 0;
  if (ci < 1 || co < 1 || ci > kMaxChannels || co > kMaxChannels || ctas < 1)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.x = x; p.w = w; p.bias = bias; p.out = out;
  p.R = R; p.W = W; p.ci = ci; p.co = co; p.relu = relu;
  p.tiles_c = (W + kTileCols - 1) / kTileCols;
  p.tiles = (R + kTileRows - 1) / kTileRows * p.tiles_c;
  p.gran = copy_granule(x, ci * (dtype == 0 ? 4 : 2));
  Instance k;
  cudaError_t e = prepare(dtype, ci, &k);
  if (e != cudaSuccess) return (int)e;
  void* args[] = {&p};
  const int grid = ctas < p.tiles ? ctas : p.tiles;
  return (int)cudaLaunchKernel(reinterpret_cast<const void*>(k.fn), dim3(grid), dim3(k.threads),
                               args, k.smem, reinterpret_cast<cudaStream_t>(stream));
}

// Resident CTAs per SM of the instance a launch with (dtype, ci) takes, on
// the current device (cudaOccupancyMaxActiveBlocksPerMultiprocessor at its
// threads and shared memory), written to *blocks; returns the CUDA error
// code.
int conv3x3_blocks_per_sm(int dtype, int ci, int* blocks) {
  Instance k;
  cudaError_t e = prepare(dtype, ci, &k);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, k.fn, k.threads, k.smem);
}

// Dynamic shared memory of one CTA of the instance a launch with (dtype,
// ci) takes, in bytes, written to *bytes; returns the CUDA error code.
int conv3x3_smem_bytes(int dtype, int ci, int* bytes) {
  Instance k;
  cudaError_t e = prepare(dtype, ci, &k);
  if (e != cudaSuccess) return (int)e;
  *bytes = k.smem;
  return 0;
}

// The wide instance (Ci or Co above 32, both at most 128): bytes of the
// packed weights a launch needs in `ws`.
int conv3x3_wide_workspace_bytes(int dtype, int ci, int co) {
  const int chunks = (ci + 31) / 32, groups = (co + 31) / 32;
  const int block = dtype == 0 ? Wide<float>::kWeightBytes : Wide<__nv_bfloat16>::kWeightBytes;
  return groups * chunks * block;
}

// Pack the weights into ws, then launch one CTA a (tile, n-group) pair on
// `stream`; returns the launch's CUDA error code (0 = ok).  Does not
// synchronise or allocate.
int conv3x3_wide_launch(int dtype, const void* x, const void* w, const void* bias, void* out,
                        void* ws, int R, int W, int ci, int co, int relu, void* stream) {
  if (R <= 0 || W <= 0) return 0;
  if (ci < 1 || co < 1 || ci > kWideMaxChannels || co > kWideMaxChannels ||
      (dtype != 0 && dtype != 1) || reinterpret_cast<uintptr_t>(ws) % 16)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.x = x; p.w = w; p.bias = bias; p.out = out;
  p.R = R; p.W = W; p.ci = ci; p.co = co; p.relu = relu;
  p.tiles_c = (W + kTileCols - 1) / kTileCols;
  p.tiles = (R + kTileRows - 1) / kTileRows * p.tiles_c;
  p.gran = copy_granule(x, ci * (dtype == 0 ? 4 : 2));
  const int chunks = (ci + 31) / 32, groups = (co + 31) / 32;
  const int words = conv3x3_wide_workspace_bytes(dtype, ci, co) / 4;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const dim3 grid(p.tiles, groups);
  void* args[] = {&p, &ws, const_cast<int*>(&chunks)};
  cudaError_t e;
  if (dtype == 0) {
    pack_wide_kernel<float><<<(words + 255) / 256, 256, 0, s>>>(p, static_cast<uint32_t*>(ws),
                                                                chunks, groups);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    const void* fn = reinterpret_cast<const void*>(conv3x3_wide_kernel<float>);
    e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             Wide<float>::kSmemBytes);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaLaunchKernel(fn, grid, dim3(kWideThreads), args, Wide<float>::kSmemBytes, s);
  }
  pack_wide_kernel<__nv_bfloat16><<<(words + 255) / 256, 256, 0, s>>>(
      p, static_cast<uint32_t*>(ws), chunks, groups);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  const void* fn = reinterpret_cast<const void*>(conv3x3_wide_kernel<__nv_bfloat16>);
  e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           Wide<__nv_bfloat16>::kSmemBytes);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaLaunchKernel(fn, grid, dim3(kWideThreads), args,
                               Wide<__nv_bfloat16>::kSmemBytes, s);
}

// Resident CTAs per SM and dynamic shared memory of the wide instance of
// `dtype`, written to *blocks and *bytes; returns the CUDA error code.
int conv3x3_wide_occupancy(int dtype, int* blocks, int* bytes) {
  const void* fn;
  int smem;
  if (dtype == 0) {
    fn = reinterpret_cast<const void*>(conv3x3_wide_kernel<float>);
    smem = Wide<float>::kSmemBytes;
  } else if (dtype == 1) {
    fn = reinterpret_cast<const void*>(conv3x3_wide_kernel<__nv_bfloat16>);
    smem = Wide<__nv_bfloat16>::kSmemBytes;
  } else {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  *bytes = smem;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, fn, kWideThreads, smem);
}

const char* conv3x3_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
