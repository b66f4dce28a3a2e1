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
//     Why mma.sync here and wgmma in the wide instance below: these
//     instances' N is at most 32 (Co <= 32), below the 64-128 outputs a
//     wgmma tile is made for, and on the tensor cores the bf16 layer is
//     bound by bytes (7.7 us), not by the MMA rate (3.3 us).  On an
//     H100 the fp32 layer's loop time splits about evenly between the
//     3xTF32 MMAs and the fragment loads and hi/lo splits that feed them,
//     while the bf16 MMAs hide entirely (tools/k2_ablation.py, PERF.md).
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
// B fragments are sized for 32).  A wider layer (Ci or Co up to 128: ABPN
// x4's 28 -> 48, and every layer of ABPN x3 at 64 or 128 feature channels)
// runs the wide instance below, on wgmma.

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
// What bounds it: a 128 -> 128 layer over a 360x640 map is 67.9 GFLOP
// against 236 MB of maps in fp32, so fp32 (3xTF32, 0.41 ms) and bf16 (0.069
// ms against 0.035 ms of bytes) are both bound by operations; a 3 -> F
// layer is bound by the bytes it writes.
// Persistent CTAs of two warpgroups walk the output tiles (t = blockIdx.x,
// blockIdx.x + gridDim.x, ...), 32 columns each, every tile with all its Co
// outputs (padded to the instance's N: 32, 48, 64, 96 or 128).  Ci is cut
// into k-chunks of 32 channels, each (chunk, tap) with its own 32 x N slice
// of weights; the wrapper's workspace holds every slice, packed once a
// launch by pack_wide_kernel in the layout the MMAs read (below).  A step
// of a tile is tp taps of a chunk (one, a row of three or all nine): its
// slices are copied, waited for and released together, and on an H100 the
// loop around the MMAs costs about the same per step whatever its work, so
// the fewer steps the better where shared memory holds three stages of
// them.  With Ci <= 3 the 9 taps fold into K (k = tap * Ci + ci, 27 of 32)
// and a tile is one step, as in the persistent instances.
//   * Copies behind the MMAs.  The steps' slices stream through a ring of
//     kStages stages, kStages - 2 steps ahead, each one bulk copy
//     (cp.async.bulk, the async proxy wgmma reads through) completed on the
//     stage's full mbarrier and refilled once its empty mbarrier says all 8
//     warps are done with it, so the warpgroups drift apart within a chunk
//     (a CTA barrier once a chunk); a chunk's window is double-buffered and
//     copied by cp.async one chunk ahead, so the next tile's first window
//     is in flight during the last chunk of this one and its epilogue.
//     Where all of a tile's steps fit in the ring (taps folded, or one
//     chunk with a small N) the slices stay resident.
//   * A warpgroup's work (kWidePlan, one row an instance): og = 1, the
//     warpgroups take the tile's pixel halves with all N outputs, A loaded
//     (and in fp32 split) once for all of them; og = 2, each takes N / 2
//     outputs over all the tile's pixels, because registers decide: a
//     thread holds mb m64 blocks of N / og / 2 accumulators beside the
//     partial sums in flight.  A tile is 2 * mb * (2 / og) rows of 32
//     pixels.  A block's outputs are computed in nh pieces, pp of them in
//     flight, so that one piece's partial sum is added while the next one's
//     MMAs run.
//   * Tensor cores through wgmma.  A warp's A is 16 pixels of a window row
//     shifted by the tap, loaded by ldmatrix as in the persistent instances
//     (a tap-shifted window is no canonical wgmma operand), and B is read
//     from the slice through a shared-memory descriptor: m64nNk8 TF32 three
//     times for fp32 (lo*hi, hi*lo, hi*hi; A split in registers, B packed
//     as TF32 hi and lo words), m64nNk16 for bf16.  mma.sync, with B
//     fragments by ldmatrix from the same slices, was slower on an H100
//     wherever a piece has 48 or more outputs, and level at bf16 N = 32
//     (tools/k2_ablation.py --wide: mma_sync).
//   * The arithmetic of the first wide instance: each (chunk, tap) is summed
//     into a partial from zero (wgmma's scale-d off on its first k-step) and
//     the partial is added to one fp32 accumulator.  The tensor cores do not
//     round their fp32 accumulation to nearest, and one chained accumulator
//     over the 432 3xTF32 MMAs of a 128 -> 128 output drifted 1.3e-4 from
//     the plain sum on an H100, past K2's fp32 tolerance.
//   * Epilogue through shared memory.  The warps that hold a run of 16
//     pixels (one warp, og = 1; a pair of warps, og = 2) stage its Co
//     outputs (bias, ReLU, one rounding; neighbouring channels stored in
//     pairs) as the run lies in device memory and store it together with
//     16-byte vectors.
// The slice layout is the canonical no-swizzle K-major operand of wgmma,
// which ldmatrix also reads as mma.sync B fragments: for k-step s and part
// u (fp32: 0 the TF32 hi words, 1 the lo words; bf16: one part), N / 8 core
// matrices of 8 outputs x 16 bytes of k for each k-half h, the core matrix
// of outputs 8j .. 8j + 7 at ((s * kParts + u) * (N / 8) + j) * 256 + 128 h.
constexpr int kWideMaxChannels = 128;  // Ci, Co limit of the wide instance (MAX_CHANNELS)
constexpr int kWideThreads = 256;      // two warpgroups
constexpr int kWideRingBytes = 98304;  // the slice ring's shared memory, at most
constexpr int kWideMaxStages = 9;      // ring stages, at most: one a tap of a chunk

// wide_plan: an instance (element bytes, N) -> the warpgroups' output split
// og, m64 blocks mb a warpgroup, the pieces nh each block's outputs are
// computed in, the pieces pp in flight (their partial sums) and the taps tp a
// step (1, a row of 3 or all 9 of a chunk: one slice copy, one wait and one
// producer turn for them, where shared memory holds three stages of them),
// chosen on an H100 with tools/k2_ablation.py --wide.  Every instance takes
// one CTA an SM: its registers (up to 255 a thread) decide.
struct WidePlanRow {
  int bytes, n, og, mb, nh, pp, tp;
};
constexpr WidePlanRow kWidePlan[] = {
    {4, 32, 1, 2, 1, 2, 3}, {4, 48, 1, 2, 1, 2, 1}, {4, 64, 1, 2, 1, 1, 1},
    {4, 96, 2, 4, 1, 1, 1}, {4, 128, 2, 4, 1, 1, 1}, {2, 32, 1, 2, 1, 2, 9},
    {2, 48, 1, 2, 1, 2, 9}, {2, 64, 1, 2, 1, 2, 9},  {2, 96, 1, 2, 2, 2, 3},
    {2, 128, 1, 2, 4, 3, 3},
};

constexpr WidePlanRow wide_row(int bytes, int n) {
  for (const WidePlanRow& r : kWidePlan)
    if (r.bytes == bytes && r.n == n) return r;
  return WidePlanRow{0, 0, 0, 0, 0, 0, 0};
}

// The instance's N for a layer of `co` outputs.
constexpr int wide_n(int co) {
  return co <= 32 ? 32 : co <= 48 ? 48 : co <= 64 ? 64 : co <= 96 ? 96 : 128;
}

template <typename T, int N, bool kFold> struct WideCfg {
  static constexpr WidePlanRow kRow = wide_row((int)sizeof(T), N);
  static_assert(kRow.n == N && (kRow.og == 1 || kRow.og == 2) && kRow.mb >= 1 &&
                    kRow.nh >= 1 && kRow.pp >= 1 && kRow.pp <= kRow.mb * kRow.nh &&
                    kRow.pp <= 4,
                "a wide_plan row for every instance");
  static constexpr int kOG = kRow.og, kMB = kRow.mb, kNH = kRow.nh, kPP = kRow.pp;
  static constexpr int kTP = kFold ? 1 : kRow.tp;  // taps a step
  static_assert(9 % kTP == 0, "a step is a tap, a row of taps or a chunk's nine");
  static constexpr int kNW = N / kOG;                // outputs of a warpgroup
  static constexpr int kNP = kNW / kNH;              // outputs of a piece
  static_assert(kNP % 16 == 0 && kNP * kNH == kNW, "pieces of whole pairs of n8 blocks");
  static constexpr int kRows = 2 * kMB * (2 / kOG);  // tile rows of 32 pixels
  static constexpr int kWinPix = (kRows + 2) * kWinCols;
  static constexpr int kPixWords = kFold ? (int)sizeof(T) : Mma<T>::kPixWords;
  static constexpr int kWindowBytes = kWinPix * kPixWords * 4;
  static constexpr int kKS = Mma<T>::kSteps;         // k-steps of a 32-deep slice
  static constexpr int kParts = sizeof(T) == 4 ? 2 : 1;
  static constexpr int kPartBytes = N * 32;          // one part of a k-step
  static constexpr int kSliceBytes = kKS * kParts * kPartBytes;  // a tap's
  static constexpr int kStepBytes = kTP * kSliceBytes;              // a step's
  // ring stages: as many as kWideRingBytes holds, at most kWideMaxStages,
  // at least three (a streamed step's slices are copied kStages - 2 steps
  // ahead)
  static constexpr int kFit = kWideRingBytes / kStepBytes;
  static constexpr int kStages =
      kFold ? 1 : kFit < 3 ? 3 : kFit < kWideMaxStages ? kFit : kWideMaxStages;
  // staging: a run of 16 pixels' Co outputs, starting at its global
  // address modulo 16, for each warp (og = 1) or each pair of warps that
  // share pixels (og = 2)
  static constexpr int kRuns = 8 / kOG;
  static constexpr int kRunBytes = 16 * N * (int)sizeof(T) + 16;
  // the slice ring's mbarriers, a full and an empty one a stage, 8 bytes each
  static constexpr int kBarBytes = (kStages * 16 + 15) / 16 * 16;
  static constexpr int kSmemBytes =
      kStages * kStepBytes + 2 * kWindowBytes + kRuns * kRunBytes + N * 4 + kBarBytes;
  static_assert(kSliceBytes % 1024 == 0 && kWindowBytes % 16 == 0 && kRunBytes % 16 == 0,
                "aligned sections");
};

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The slice ring's copies: one bulk copy a slice (the async proxy, which
// wgmma reads through), completed on the stage's mbarrier.
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
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
// returns once the barrier's phase `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(bar), "r"(parity) : "memory");
}
// the 64 threads of warps w and w + 4 (a pair that shares pixels)
__device__ __forceinline__ void pair_sync(int w) {
  asm volatile("bar.sync %0, 64;\n" ::"r"(1 + w) : "memory");
}

// A wgmma descriptor of a no-swizzle K-major operand at shared address
// `addr`: core matrices 128 bytes apart along k (the leading offset), 256
// along n (the stride offset).
__device__ __forceinline__ uint64_t wide_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3ffff) >> 4) | ((uint64_t)(128 >> 4) << 16) |
         ((uint64_t)(256 >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most n wgmma groups are in flight (n, 0 .. 3, is a
// constant once the caller's loop is unrolled)
__device__ __forceinline__ void wgmma_wait(int n) {
  switch (n) {
    case 0: asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory"); break;
    case 1: asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory"); break;
    case 2: asm volatile("wgmma.wait_group.sync.aligned 2;\n" ::: "memory"); break;
    default: asm volatile("wgmma.wait_group.sync.aligned 3;\n" ::: "memory"); break;
  }
}
// keeps the compiler from moving reads or writes of r across a wgmma fence
// or wait
template <int K>
__device__ __forceinline__ void fence_regs(float (&r)[K]) {
#pragma unroll
  for (int i = 0; i < K; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// wgmma m64nNk8 (TF32) / m64nNk16 (bf16) with A from registers (a warp's 16
// rows, laid out as mma.sync's A fragment) and B from a descriptor, D += A B
// (D = A B when accumulate is 0), for the pieces the plan runs (N = 32,
// 48, 64).
template <typename T, int N> struct Wgmma;
template <> struct Wgmma<float, 32> {
  static __device__ __forceinline__ void mma(float (&d)[16], const uint32_t (&a)[4], uint64_t b,
                                             int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
  }
};
template <> struct Wgmma<float, 48> {
  static __device__ __forceinline__ void mma(float (&d)[24], const uint32_t (&a)[4], uint64_t b,
                                             int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n48k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23}, "
        "{%24, %25, %26, %27}, %28, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
  }
};
template <> struct Wgmma<float, 64> {
  static __device__ __forceinline__ void mma(float (&d)[32], const uint32_t (&a)[4], uint64_t b,
                                             int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
  }
};
template <> struct Wgmma<__nv_bfloat16, 32> {
  static __device__ __forceinline__ void mma(float (&d)[16], const uint32_t (&a)[4], uint64_t b,
                                             int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
  }
};
template <> struct Wgmma<__nv_bfloat16, 48> {
  static __device__ __forceinline__ void mma(float (&d)[24], const uint32_t (&a)[4], uint64_t b,
                                             int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23}, "
        "{%24, %25, %26, %27}, %28, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
  }
};
template <> struct Wgmma<__nv_bfloat16, 64> {
  static __device__ __forceinline__ void mma(float (&d)[32], const uint32_t (&a)[4], uint64_t b,
                                             int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
  }
};

// The weights of a wide launch as its slices, slice after slice in step
// order (per tap: step = 9 * chunk + tap; folded: one slice), each in the
// layout above, zero past Ci (folded: past 9 * Ci) and past Co.
template <typename T, int N, bool kFold>
__global__ void pack_wide_kernel(Params p, uint32_t* __restrict__ packed, int steps) {
  constexpr int kWords = WideCfg<T, N, kFold>::kSliceBytes / 4;
  const T* w = static_cast<const T*>(p.w);
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < (size_t)steps * kWords;
       i += (size_t)gridDim.x * blockDim.x) {
    const int sl = (int)(i / kWords), u = (int)(i % kWords);
    const int chunk = sl / 9, tap = sl % 9;
    // B[k][n] of the slice
    auto weight = [&](int k, int n) -> T {
      if (n >= p.co) return from_f<T>(0.f);
      if (kFold) return k < 9 * p.ci ? w[(size_t)k * p.co + n] : from_f<T>(0.f);
      const int ci = 32 * chunk + k;
      return ci < p.ci ? w[((size_t)tap * p.ci + ci) * p.co + n] : from_f<T>(0.f);
    };
    // word u: e (4), row r (8), k-half h (2), core matrix j (N / 8), then
    // fp32: part (2), k-step (4); bf16: k-step (2)
    const int e = u & 3, r = (u >> 2) & 7, h = (u >> 5) & 1, j = (u >> 6) % (N / 8);
    const int rest = (u >> 6) / (N / 8), n = 8 * j + r;
    uint32_t v;
    if constexpr (sizeof(T) == 4) {
      const int part = rest & 1, s = rest >> 1;
      uint32_t hi, lo;
      tf32_split(__float_as_uint(to_f(weight(8 * s + 4 * h + e, n))), hi, lo);
      v = part ? lo : hi;
    } else {
      const int k = 16 * rest + 8 * h + 2 * e;
      const T a = weight(k, n), b = weight(k + 1, n);
      v = (uint32_t)*reinterpret_cast<const uint16_t*>(&a) |
          ((uint32_t)*reinterpret_cast<const uint16_t*>(&b) << 16);
    }
    packed[i] = v;
  }
}

// Issue the copies of k-chunk c of a tile's window into `win` (window rows
// r0-1 .. r0+kRows, columns c0-1 .. c0+kTileCols, kWinPixN pixels), zero
// outside the map: taps folded, each pixel's Ci channels (the rest of its
// slot stays zero); else the chunk's 32 channels, zero past Ci (cp.async's
// zero fill; plain 2-byte loads where G = 2).
template <typename T, bool kFold, int kWinPixN, int kPW, int G>
__device__ void load_wide_window(const Params& p, char* win, int r0, int c0, int c) {
  constexpr int kSz = (int)sizeof(T);
  const int per = kFold ? p.ci * kSz / G : 32 * kSz / G;  // copies a pixel
  const char* x = static_cast<const char*>(p.x);
  const int pixel_bytes = p.ci * kSz;
  const uint32_t base = smem_addr(win);
  for (int i = threadIdx.x; i < kWinPixN * per; i += kWideThreads) {
    const int pix = i / per, gi = i - pix * per;
    const int row = pix / kWinCols, col = pix - row * kWinCols;
    const int gr = r0 - 1 + row, gc = c0 - 1 + col;
    const int ch = 32 * c + gi * G / kSz;  // the copy's first channel
    const bool in = gr >= 0 && gr < p.R && gc >= 0 && gc < p.W && ch < p.ci;
    const char* src = in ? x + (size_t)(gr * p.W + gc) * pixel_bytes + ch * kSz : x;
    const int dst = pix * kPW * 4 + gi * G;
    if constexpr (G >= 4) {
      cp_async<G>(base + dst, src, in ? G : 0);
    } else {
      *reinterpret_cast<uint16_t*>(win + dst) = in ? *reinterpret_cast<const uint16_t*>(src) : 0;
    }
  }
}

template <typename T, bool kFold, int kWinPixN, int kPW>
__device__ void load_wide_window_any(const Params& p, char* win, int r0, int c0, int c) {
  switch (p.gran) {
    case 16: load_wide_window<T, kFold, kWinPixN, kPW, 16>(p, win, r0, c0, c); break;
    case 8: load_wide_window<T, kFold, kWinPixN, kPW, 8>(p, win, r0, c0, c); break;
    case 4: load_wide_window<T, kFold, kWinPixN, kPW, 4>(p, win, r0, c0, c); break;
    default: load_wide_window<T, kFold, kWinPixN, kPW, 2>(p, win, r0, c0, c); break;
  }
}

// One step's product for one m64 block of a warpgroup: part = A B over the
// slice's k-steps, from zero, started as one wgmma group (wide_wait(n)
// returns once at most n groups are in flight).  a: this warp's A
// fragments, one a k-step; b: the shared address of the warpgroup's first
// output in part 0 of k-step 0.
template <typename T, int N, int kNP>
__device__ __forceinline__ void wide_start(float (&part)[kNP / 2],
                                           const uint32_t (&a)[Mma<T>::kSteps][4], uint32_t b) {
  constexpr int kKS = Mma<T>::kSteps, kPart = N * 32;
  fence_regs(part);
  if constexpr (sizeof(T) == 4) {
    uint32_t ah[kKS][4], al[kKS][4];
#pragma unroll
    for (int s = 0; s < kKS; ++s)
#pragma unroll
      for (int e = 0; e < 4; ++e) tf32_split(a[s][e], ah[s][e], al[s][e]);
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < kKS; ++s) {
      const uint64_t hi = wide_desc(b + 2 * s * kPart), lo = wide_desc(b + (2 * s + 1) * kPart);
      Wgmma<float, kNP>::mma(part, al[s], hi, s);
      Wgmma<float, kNP>::mma(part, ah[s], lo, 1);
      Wgmma<float, kNP>::mma(part, ah[s], hi, 1);
    }
  } else {
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < kKS; ++s) Wgmma<T, kNP>::mma(part, a[s], wide_desc(b + s * kPart), s);
  }
  wgmma_commit();
}

template <int K>
__device__ __forceinline__ void wide_wait(int n, float (&part)[K]) {
  wgmma_wait(n);
  fence_regs(part);
}

template <typename T, int N, bool kFold>
__global__ void __launch_bounds__(kWideThreads, 1)
conv3x3_wide_kernel(Params p, const uint4* __restrict__ packed, int chunks) {
  using C = WideCfg<T, N, kFold>;
  constexpr int kNW = C::kNW, kMB = C::kMB, kNH = C::kNH, kNP = C::kNP, kPP = C::kPP;
  constexpr int kKS = C::kKS, kPW = C::kPixWords, kS = C::kStages;
  constexpr int kPE = kPW * 4 / (int)sizeof(T), kE = (int)sizeof(T);
  constexpr bool kF32 = sizeof(T) == 4;
  extern __shared__ uint4 smem[];
  char* ring = reinterpret_cast<char*>(smem);
  char* win0 = ring + kS * C::kStepBytes;
  char* stage = win0 + 2 * C::kWindowBytes;
  float* sbias = reinterpret_cast<float*>(stage + C::kRuns * C::kRunBytes);
  // stage st's full mbarrier (its slice has landed) at bars + 8 st, its
  // empty one (all 8 warps are done reading it) at empties + 8 st
  const uint32_t bars = smem_addr(sbias + N), empties = bars + 8 * kS;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, wi = warp & 3;
  const int g = lane >> 2, tig = lane & 3;
  // this warpgroup's outputs og * kNW .. and m64 blocks pg * kMB ..
  const int og = C::kOG == 2 ? warp >> 2 : 0, pg = C::kOG == 2 ? 0 : warp >> 2;
  const int spc = kFold ? 1 : 9 / C::kTP, steps = chunks * spc;  // steps a chunk, a tile
  const bool resident = steps <= kS;

  for (int i = tid; i < 2 * C::kWindowBytes / 16; i += kWideThreads)
    reinterpret_cast<uint4*>(win0)[i] = make_uint4(0, 0, 0, 0);
  const T* bsrc = static_cast<const T*>(p.bias);
  for (int i = tid; i < N; i += kWideThreads) sbias[i] = i < p.co ? to_f(bsrc[i]) : 0.f;
  if (tid < kS) {
    mbar_init(bars + 8 * tid, 1);
    mbar_init(empties + 8 * tid, kWideThreads / 32);
  }
  mbar_init_fence();
  __syncthreads();  // the zeros and the barriers are in place before any copy lands

  const uint32_t ring_addr = smem_addr(ring);
  auto load_slice = [&](int sl, int st) {  // by one thread
    bulk_copy(ring_addr + st * C::kStepBytes, packed + (size_t)sl * (C::kStepBytes / 16),
              C::kStepBytes, bars + 8 * st);
  };
  auto load_win = [&](int t, int c, int buf) {
    load_wide_window_any<T, kFold, C::kWinPix, kPW>(p, win0 + buf * C::kWindowBytes,
                                                    t / p.tiles_c * C::kRows,
                                                    t % p.tiles_c * kTileCols, c);
  };

  // per tap: this lane's ldmatrix row, pixel m = r + 8 (i & 1) of matrix
  // i = lane / 8 at k offset 16 (i / 2) bytes
  const int lane_off = ((lane & 7) + 8 * ((lane >> 3) & 1)) * kPW * 4 + 16 * (lane >> 4);
  // folded K: window offsets of this thread's A elements for each k-step
  // (fp32: k = 8s + tig + {0, 4}; bf16: k = 16s + 2 tig + {0, 1, 8, 9})
  constexpr int kOffs = kF32 ? 2 : 4;
  int off[kKS][kOffs];
#pragma unroll
  for (int s = 0; s < kKS; ++s)
#pragma unroll
    for (int h = 0; h < kOffs; ++h)
      off[s][h] = kFold ? fold_offset<T>(kF32 ? 8 * s + tig + 4 * h
                                              : 16 * s + 2 * tig + (h & 1) + 8 * (h >> 1), p.ci)
                        : 0;

  int tile = blockIdx.x;  // the grid has at most one CTA per tile
  load_win(tile, 0, 0);
  cp_async_commit();
  if (tid == 0) {  // resident: every slice; streamed: steps 0 .. kS - 3, which this CTA runs
    for (int sl = 0; sl < (resident ? steps : kS - 2); ++sl) load_slice(sl, sl);
  }

  float acc[kMB][kNW / 2];
  float part[kPP][kNP / 2];  // partial sums in flight
  // the A fragments of the blocks whose pieces may be in flight, read by the
  // MMAs until they finish: a block's buffer is reused kAS blocks later
  constexpr int kAS = (kPP - 1 + kNH - 1) / kNH + 1;
  uint32_t as[kAS][kKS][4];
#pragma unroll
  for (int x = 0; x < kPP; ++x)
#pragma unroll
    for (int i = 0; i < kNP / 2; ++i) part[x][i] = 0.f;
  int q = 0, cc = 0;  // this CTA's steps and chunks so far
  for (; tile < p.tiles; tile += gridDim.x) {
#pragma unroll
    for (int mb = 0; mb < kMB; ++mb)
#pragma unroll
      for (int i = 0; i < kNW / 2; ++i) acc[mb][i] = 0.f;
    for (int c = 0; c < chunks; ++c, ++cc) {
      const char* win = win0 + (cc & 1) * C::kWindowBytes;
      const uint32_t win_addr = smem_addr(win);
#pragma unroll 1
      for (int j = 0; j < spc; ++j, ++q) {
        // this chunk's window (copied a chunk ago) and this step's slices
        // have landed.  The barrier, once a chunk: every warp is done with
        // the chunk before, so the other window buffer may be refilled;
        // within a chunk the warps drift apart, a ring stage refilled only
        // once all 8 warps are done with it (its empty mbarrier).
        if (j == 0) cp_async_wait<0>();
        const int st = resident ? c * spc + j : q % kS;
        mbar_wait(bars + 8 * st, resident ? 0 : (q / kS) & 1);
        if (j == 0) __syncthreads();
        if (j == 0) {  // the next chunk's window (or the next tile's first)
          const bool last = c + 1 == chunks;
          const int nt = last ? tile + (int)gridDim.x : tile;
          if (nt < p.tiles) load_win(nt, last ? 0 : c + 1, (cc + 1) & 1);
          cp_async_commit();
        }
        if (!resident && tid == 0) {  // the slice of step q + kS - 2, where this CTA runs it,
          const int qa = q + kS - 2;  // into the stage of step q - 2
          if ((int)blockIdx.x + qa / steps * (int)gridDim.x < p.tiles) {
            if (q >= 2) mbar_wait(empties + 8 * (qa % kS), ((q - 2) / kS) & 1);
            load_slice(qa % steps, qa % kS);
          }
        }
        __syncwarp();

#pragma unroll 1
        for (int tt = 0; tt < C::kTP; ++tt) {
        const int t = j * C::kTP + tt;
        const uint32_t slice =
            ring_addr + st * C::kStepBytes + tt * C::kSliceBytes + og * kNW * 32;
        const int dy = t / 3, dx = t - 3 * dy;
        // the warpgroup's pieces (m64 block mb, outputs h * kNP ..), up to
        // kPP in flight: piece u is started, then piece u - kPP + 1 is waited
        // for and its partial sum added
#pragma unroll
        for (int u = 0; u < kMB * kNH + kPP - 1; ++u) {
          if (u < kMB * kNH) {
            const int mb = u / kNH, h = u % kNH;
            uint32_t (&a)[kKS][4] = as[mb % kAS];
            if (h == 0) {
              const int trow = 2 * (pg * kMB + mb) + (wi >> 1), tcol = 16 * (wi & 1);
              if constexpr (kFold) {
                // fragment row g's own pixel; the tap offsets are in off
                const int pix = trow * kWinCols + tcol + g;
#pragma unroll
                for (int s = 0; s < kKS; ++s) {
                  if constexpr (kF32) {
                    const float* pe = reinterpret_cast<const float*>(win) + pix * kPE;
                    a[s][0] = __float_as_uint(pe[off[s][0]]);
                    a[s][1] = __float_as_uint(pe[8 * kPE + off[s][0]]);
                    a[s][2] = __float_as_uint(pe[off[s][1]]);
                    a[s][3] = __float_as_uint(pe[8 * kPE + off[s][1]]);
                  } else {
                    const uint16_t* pe = reinterpret_cast<const uint16_t*>(win) + pix * kPE;
                    a[s][0] = pe[off[s][0]] | ((uint32_t)pe[off[s][1]] << 16);
                    a[s][1] = pe[8 * kPE + off[s][0]] | ((uint32_t)pe[8 * kPE + off[s][1]] << 16);
                    a[s][2] = pe[off[s][2]] | ((uint32_t)pe[off[s][3]] << 16);
                    a[s][3] = pe[8 * kPE + off[s][2]] | ((uint32_t)pe[8 * kPE + off[s][3]] << 16);
                  }
                }
              } else {  // 32 bytes a k-step in both dtypes (8 fp32 or 16 bf16)
                const uint32_t at =
                    win_addr + ((trow + dy) * kWinCols + tcol + dx) * kPW * 4 + lane_off;
#pragma unroll
                for (int s = 0; s < kKS; ++s) ldmatrix_x4(a[s], at + 32 * s);
              }
            }
            wide_start<T, N, kNP>(part[u % kPP], a, slice + h * kNP * 32);
          }
          const int d = u - (kPP - 1);  // the piece whose sum is added now
          if (d >= 0) {
            wide_wait(u < kMB * kNH ? kPP - 1 : kMB * kNH - 1 - d, part[d % kPP]);
#pragma unroll
            for (int i = 0; i < kNP / 2; ++i)
              acc[d / kNH][(d % kNH) * (kNP / 2) + i] += part[d % kPP][i];
          }
        }
        }
        // this warp's MMAs have read the stage: it may be refilled
        if (!resident && lane == 0) mbar_arrive(empties + 8 * st);
      }
    }

    // Epilogue: accumulator i of block mb holds pixel g + 8 ((i >> 1) & 1)
    // of the warp's 16, output og * kNW + 8 (i >> 2) + 2 tig + (i & 1).
    // The run's owners (the warp, or the pair of warps that share its
    // pixels) stage the 16 pixels' Co outputs as they lie in device memory,
    // then store them together.
    const int r0 = tile / p.tiles_c * C::kRows, c0 = tile % p.tiles_c * kTileCols + 16 * (wi & 1);
    const int nrun = min(kNW, p.co - og * kNW), ncols = min(16, p.W - c0);
    char* run = stage + (C::kOG == 1 ? warp : wi) * C::kRunBytes;
    const int owner = lane + 32 * og;  // this lane among the run's owners
#pragma unroll
    for (int mb = 0; mb < kMB; ++mb) {
      const int row = r0 + 2 * (pg * kMB + mb) + (wi >> 1);
      if (row >= p.R || ncols <= 0) continue;  // uniform among the run's owners
      char* gdst = static_cast<char*>(p.out) + ((size_t)row * p.W + c0) * p.co * kE;
      const int mis = (int)(reinterpret_cast<uintptr_t>(gdst) & 15);
      T* srun = reinterpret_cast<T*>(run + mis) + og * kNW;
      // a thread's outputs come in pairs of neighbouring channels, stored
      // together where Co is even (the pair then sits 2-element aligned)
      if ((p.co & 1) == 0) {
#pragma unroll
        for (int i = 0; i < kNW / 2; i += 2) {
          const int col = g + 8 * ((i >> 1) & 1), ch = 8 * (i >> 2) + 2 * tig;
          if (ch < nrun) {
            const float2 b2 = *reinterpret_cast<const float2*>(sbias + og * kNW + ch);
            float y0 = acc[mb][i] + b2.x, y1 = acc[mb][i + 1] + b2.y;
            if (p.relu) y0 = fmaxf(y0, 0.f), y1 = fmaxf(y1, 0.f);
            T* at = srun + col * p.co + ch;
            if constexpr (kF32) *reinterpret_cast<float2*>(at) = make_float2(y0, y1);
            else *reinterpret_cast<__nv_bfloat162*>(at) = __floats2bfloat162_rn(y0, y1);
          }
        }
      } else {
#pragma unroll
        for (int i = 0; i < kNW / 2; ++i) {
          const int col = g + 8 * ((i >> 1) & 1), ch = 8 * (i >> 2) + 2 * tig + (i & 1);
          if (ch < nrun) {
            float y = acc[mb][i] + sbias[og * kNW + ch];
            if (p.relu) y = fmaxf(y, 0.f);
            srun[col * p.co + ch] = from_f<T>(y);
          }
        }
      }
      if (C::kOG == 1) __syncwarp();
      else pair_sync(wi);
      const char* sd = run + mis;
      const int nbytes = ncols * p.co * kE;
      const int head = min((16 - mis) & 15, nbytes);
      const int body_end = head + ((nbytes - head) & ~15);
      for (int b = head + 16 * owner; b < body_end; b += 16 * 32 * C::kOG)
        *reinterpret_cast<uint4*>(gdst + b) = *reinterpret_cast<const uint4*>(sd + b);
      for (int b = kE * owner; b < head; b += kE * 32 * C::kOG)
        *reinterpret_cast<T*>(gdst + b) = *reinterpret_cast<const T*>(sd + b);
      for (int b = body_end + kE * owner; b < nbytes; b += kE * 32 * C::kOG)
        *reinterpret_cast<T*>(gdst + b) = *reinterpret_cast<const T*>(sd + b);
      if (C::kOG == 1) __syncwarp();
      else pair_sync(wi);
    }
  }
  cp_async_wait<0>();
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

// The wide instance of a layer: kernel, weight packing and their sizes.
struct WideInstance {
  const void* kernel;
  const void* pack;
  int smem, slice_bytes, rows;
};

template <typename T, int N, bool kFold> WideInstance make_wide() {
  using C = WideCfg<T, N, kFold>;
  return {reinterpret_cast<const void*>(conv3x3_wide_kernel<T, N, kFold>),
          reinterpret_cast<const void*>(pack_wide_kernel<T, N, kFold>), C::kSmemBytes,
          C::kSliceBytes, C::kRows};
}

template <typename T, bool kFold> bool pick_wide(int n, WideInstance* k) {
  switch (n) {
    case 32:
      if constexpr (!kFold) {  // a folded layer with Co <= 32 is not wide
        *k = make_wide<T, 32, kFold>();
        return true;
      }
      return false;
    case 48: *k = make_wide<T, 48, kFold>(); return true;
    case 64: *k = make_wide<T, 64, kFold>(); return true;
    case 96: *k = make_wide<T, 96, kFold>(); return true;
    case 128: *k = make_wide<T, 128, kFold>(); return true;
    default: return false;
  }
}

// The wide instance for (dtype, ci, co) in *k, allowed the shared memory it
// takes.
cudaError_t prepare_wide(int dtype, int ci, int co, WideInstance* k) {
  const bool fold = ci <= kFoldMaxCi;
  const int n = wide_n(co);
  bool ok;
  if (dtype == 0) ok = fold ? pick_wide<float, true>(n, k) : pick_wide<float, false>(n, k);
  else if (dtype == 1)
    ok = fold ? pick_wide<__nv_bfloat16, true>(n, k) : pick_wide<__nv_bfloat16, false>(n, k);
  else ok = false;
  if (!ok) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(k->kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, k->smem);
}

int wide_steps(int ci) { return ci <= kFoldMaxCi ? 1 : 9 * ((ci + 31) / 32); }

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
// packed weights a launch needs in `ws` (every step's slice), or 0 where
// the layer is not one the wide instance takes.
int conv3x3_wide_workspace_bytes(int dtype, int ci, int co) {
  if (ci < 1 || co < 1 || ci > kWideMaxChannels || co > kWideMaxChannels ||
      (dtype != 0 && dtype != 1) || (ci <= kFoldMaxCi && co <= kMaxChannels))
    return 0;
  const int slice = (dtype == 0 ? 8 : 2) * 32 * wide_n(co);
  return wide_steps(ci) * slice;
}

// Pack the weights into ws, then launch min(ctas, tiles) persistent CTAs of
// the wide instance on `stream`; returns the launch's CUDA error code (0 =
// ok).  Does not synchronise or allocate.
int conv3x3_wide_launch(int dtype, const void* x, const void* w, const void* bias, void* out,
                        void* ws, int R, int W, int ci, int co, int relu, int ctas,
                        void* stream) {
  if (R <= 0 || W <= 0) return 0;
  if (ci < 1 || co < 1 || ci > kWideMaxChannels || co > kWideMaxChannels || ctas < 1 ||
      (dtype != 0 && dtype != 1) || reinterpret_cast<uintptr_t>(ws) % 16)
    return (int)cudaErrorInvalidValue;
  WideInstance k;
  cudaError_t e = prepare_wide(dtype, ci, co, &k);
  if (e != cudaSuccess) return (int)e;
  Params p;
  p.x = x; p.w = w; p.bias = bias; p.out = out;
  p.R = R; p.W = W; p.ci = ci; p.co = co; p.relu = relu;
  p.tiles_c = (W + kTileCols - 1) / kTileCols;
  p.tiles = (R + k.rows - 1) / k.rows * p.tiles_c;
  p.gran = copy_granule(x, ci * (dtype == 0 ? 4 : 2));
  int steps = wide_steps(ci), chunks = ci <= kFoldMaxCi ? 1 : (ci + 31) / 32;
  const int words = steps * k.slice_bytes / 4;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  void* pack_args[] = {&p, &ws, &steps};
  const int pack_blocks = (words + 255) / 256 < 1024 ? (words + 255) / 256 : 1024;
  e = cudaLaunchKernel(k.pack, dim3(pack_blocks), dim3(256), pack_args, 0, s);
  if (e != cudaSuccess) return (int)e;
  void* args[] = {&p, &ws, &chunks};
  const int grid = ctas < p.tiles ? ctas : p.tiles;
  return (int)cudaLaunchKernel(k.kernel, dim3(grid), dim3(kWideThreads), args, k.smem, s);
}

// Resident CTAs per SM and dynamic shared memory of the wide instance a
// (dtype, ci, co) layer runs on, written to *blocks and *bytes; returns the
// CUDA error code.
int conv3x3_wide_occupancy(int dtype, int ci, int co, int* blocks, int* bytes) {
  WideInstance k;
  cudaError_t e = prepare_wide(dtype, ci, co, &k);
  if (e != cudaSuccess) return (int)e;
  *bytes = k.smem;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, k.kernel, kWideThreads,
                                                            k.smem);
}

const char* conv3x3_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
