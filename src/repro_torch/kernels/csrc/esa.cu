// RLFN's residual block tail on Hopper (sm_90a): c5 and ESA (enhanced
// spatial attention, Kong et al., CVPRW 2022) over whole NHWC frames, in
// four launches a block.
//
// Replaces no TPU kernel: the JAX package has no RLFN.  The port ran this
// tail as a dozen PyTorch passes a block (kernels/esa.py::esa_plain: 1x1
// convolutions and their bias adds, a strided 3x3, the max-pool, a 3x3, the
// bilinear resize, a sum, the sigmoid, the gate), each intermediate map a
// round trip to device memory at 52 or 16 channels.
//
// What it computes, per block, with h (N, H, W, 52) the segment's output:
//   u   = c5(h)                                  1x1, 52 -> 52
//   c1_ = conv1(u)                               1x1, 52 -> 16
//   c3  = conv3(maxpool7s3(conv2(c1_)))          3x3 stride 2 pad 0; 3x3 pad 1
//   out = u * sigmoid(conv4(up(c3) + conv_f(c1_)))   up: bilinear to H x W,
//                                                align_corners=False; 1x1s
// every convolution with its bias, summed in fp32.  A map rounds to the
// compute dtype where the plain chain's does: c1_, conv2's output, c3, the
// resized c3, the sum, u (before the gate) and the output.
//
// What bounds it on this card: bytes.  The passes below read h twice (52
// channels), write c1_ and cf (16 each) and read them once, and write the
// output once: 101 MB a block at 360x640 in bf16 against the family's 48
// (each stage's input and output once), 0.03 ms at 3.35 TB/s.  The work,
// 2.5 GFLOP a block with u computed twice, is 3 us on the tensor cores.
//
// The design, for bytes:
//   * pass A (full resolution): a persistent CTA streams tiles of 128
//     pixels into shared memory (cp.async, three tiles in flight); each warp
//     runs one 16-pixel tile through c5, conv1 and conv_f on the tensor cores
//     (mma.sync m16n8k16 in bf16, fp32 sums, the weights' B fragments by
//     ldmatrix), each product's C fragments reused in registers as the next
//     one's A fragments, so u never leaves the registers; it writes c1_ and
//     cf only (16 channels each), staged for 16-byte stores;
//   * pass B (reduced resolution, two launches): conv2 at stride 2 and the
//     7x7 stride-3 max-pool, a CTA a tile of 8 x 16 pooled outputs over the
//     conv2 outputs they pool, held in shared memory (the 179 x 319 map
//     never reaches device memory; in bf16 conv2 runs on the tensor cores, a
//     tap a k-block); then conv3 on the pooled map (58 x 105 at 360 x 640)
//     on the CUDA cores;
//   * pass C (full resolution): h and cf streamed as in pass A, u recomputed
//     exactly as there (24 MB a frame, where writing u and reading it back
//     would cost 48), c3 sampled bilinearly from L2 (PyTorch's
//     align_corners=False source index, clamped at 0; the loads issued
//     before c5), conv4 on the tensor cores, the sigmoid on the
//     special-function units and the gate; the output staged in the tile's
//     own rows of shared memory and written as contiguous NHWC by 16-byte
//     stores.
// fp32 keeps full fp32: passes A and C run a thread a pixel on CUDA-core
// FMAs, conv2 too (no cell serves fp32 RLFN; the tests and chip_smoke.py do).
//
// The widths (52 features, 16 ESA channels) are compile-time; H and W, from
// which the pool's and the resize's geometry follow, are run-time values.
// The kernels allocate nothing: the wrapper passes every map.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kF = 52;          // RLFN's feature channels
constexpr int kE = 16;          // ESA's channels
constexpr int kNT = 7;          // n-tiles of 8 over kF (56 outputs, 4 zero)
constexpr int kKB = 4;          // k-blocks of 16 over kF (64, 12 zero)
constexpr int kLdF = 72;        // shared row of a [n][k] weight over kF: conflict-free fragments
constexpr int kLdE = 24;        // the same over kE
constexpr int kThreads = 256;
constexpr int kTile = 128;      // pixels a tile of the mma passes: 8 warps x 16
constexpr int kStages = 3;      // tiles a persistent CTA has in flight (cp.async buffers)
constexpr int kPoolY = 8, kPoolX = 16;                    // pooled outputs a pass-B CTA
constexpr int kRegY = 3 * kPoolY + 4, kRegX = 3 * kPoolX + 4;  // conv2 outputs they pool

struct Args {
  const void* x;              // h (m, kF)
  const void* wt[12];         // c5, conv1, conv_f, conv2, conv3, conv4: (Co, Ci, k, k), bias
  void* c1;                   // c1_ (m, kE)
  void* cf;                   // conv_f(c1_) (m, kE)
  void* pool;                 // (n, h3, w3, kE)
  void* c3;                   // (n, h3, w3, kE)
  void* out;                  // (m, kF)
  long long m;                // pixels: n * h * w
  int n, h, w, h2, w2, h3, w3;
  float rh, rw;               // the resize's scales h3 / h, w3 / w, as PyTorch computes them
  int tiles_x, tiles_y;       // pass B1's tiles a frame
};

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(bf16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T narrow(float v);
template <> __device__ __forceinline__ float narrow<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 narrow<bf16>(float v) { return __float2bfloat16_rn(v); }

// v as the dtype T holds it
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return widen(narrow<T>(v));
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}
__device__ __forceinline__ void st32(bf16* p, uint32_t v) { *reinterpret_cast<uint32_t*>(p) = v; }

// two floats rounded to bf16, the first in the low half
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ float2 unpack(uint32_t u) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&u));
}

// c += a * b, m16n8k16, bf16 in, fp32 sums
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four 8x8 bf16 matrices from shared memory, lane l giving row l % 8 of
// matrix l / 8; each lane gets, of each matrix, row l / 4, columns 2 (l % 4)
// and the next: the B fragments of m16n8k16 from a [n][k] weight
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* row) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}
// n-tile j's B fragments at k-blocks kb and kb + 1: r[0..1] and r[2..3]
__device__ __forceinline__ void b_frags_k2(uint32_t (&r)[4], const bf16* w, int ld, int j, int kb,
                                           int lane) {
  ldsm_x4(r, w + (8 * j + (lane & 7)) * ld + 16 * kb + 8 * (lane >> 3));
}
// n-tiles j and j + 1's B fragments at k-block kb: r[0..1] and r[2..3]
__device__ __forceinline__ void b_frags_n2(uint32_t (&r)[4], const bf16* w, int ld, int j, int kb,
                                           int lane) {
  ldsm_x4(r, w + (8 * j + 8 * (lane >> 4) + (lane & 7)) * ld + 16 * kb + 8 * ((lane >> 3) & 1));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
// every group but the newest `pending` has landed
template <int pending> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(pending));
}

__device__ __forceinline__ float sigmoid(float v) { return 1.0f / (1.0f + expf(-v)); }
// the same on the special-function units (ex2 and rcp, ~2^-21 relative):
// far below a bf16 output's rounding
__device__ __forceinline__ float fast_sigmoid(float v) {
  return __fdividef(1.0f, 1.0f + __expf(-v));
}

// ---------------------------------------------------------------------------
// Passes A and C in bf16: tensor cores
// ---------------------------------------------------------------------------

// shared layout, bytes
constexpr int kW5Bytes = 8 * kNT * kLdF * 2;   // c5 [56][kLdF]
constexpr int kW1Bytes = kE * kLdF * 2;        // conv1 [16][kLdF]
constexpr int kWfBytes = kE * kLdE * 2;        // conv_f [16][kLdE]
constexpr int kW4Bytes = 8 * (kNT + 1) * kLdE * 2;  // conv4 [64][kLdE]: n-tiles read in pairs
constexpr int kXTileBytes = kTile * kF * 2;    // a tile of h
constexpr int kETileBytes = kTile * kE * 2;    // a tile of a 16-channel map
constexpr int kABiasBytes = (8 * kNT + 2 * kE) * 4;
constexpr int kCBiasBytes = 2 * 8 * kNT * 4;
constexpr int kAStageBytes = (kThreads / 32) * 16 * 2 * kE * 2;  // a warp's c1_ and cf
constexpr int kASmem = kW5Bytes + kW1Bytes + kWfBytes + kABiasBytes + kStages * kXTileBytes +
                       kAStageBytes;
constexpr int kCSmem = kW5Bytes + kW4Bytes + kCBiasBytes + kStages * (kXTileBytes + kETileBytes);
static_assert(kW5Bytes % 16 == 0 && kW1Bytes % 16 == 0 && kWfBytes % 16 == 0 &&
              kW4Bytes % 16 == 0 && kABiasBytes % 16 == 0 && kCBiasBytes % 16 == 0,
              "shared regions stay 16-byte aligned");

// a (co, ci) weight (1x1 conv, row-major) into a zero-padded [rows][ld] tile
__device__ void stage_nk(bf16* s, int rows, int ld, const bf16* w, int co, int ci) {
  for (int i = threadIdx.x; i < rows * ld; i += blockDim.x) {
    const int r = i / ld, k = i - r * ld;
    s[i] = (r < co && k < ci) ? w[r * ci + k] : __float2bfloat16_rn(0.0f);
  }
}

template <typename T>
__device__ void stage_bias(float* s, int rows, const T* b, int co) {
  for (int i = threadIdx.x; i < rows; i += blockDim.x) s[i] = i < co ? widen(b[i]) : 0.0f;
}

// `rows` rows of `width` elements from src into dst by 16-byte cp.async,
// the last vector cut at the end (the rest of it zero-filled)
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src, int rows, int width) {
  const int bytes = rows * width * 2;
  const char* s = reinterpret_cast<const char*>(src);
  char* d = reinterpret_cast<char*>(dst);
  for (int v = threadIdx.x; v * 16 < bytes; v += blockDim.x)
    cp_async16(d + v * 16, s + v * 16, min(16, bytes - v * 16));
}

// u = c5(h) + b for a warp's 16 pixels (rows of hs, kF apart), rounded to
// bf16: n-tile j's C fragment as two packed pairs (rows g and g + 8, columns
// 8j + 2t, 8j + 2t + 1)
__device__ __forceinline__ void c5_tile(const bf16* hs, const bf16* w5, const float* b5, int lane,
                                        uint32_t (&uq)[kNT][2]) {
  const int g = lane >> 2, t2 = 2 * (lane & 3);
  uint32_t a[kKB][4];
#pragma unroll
  for (int kb = 0; kb < kKB; ++kb) {
    const int k = kb * 16 + t2;
    a[kb][0] = k < kF ? ld32(hs + g * kF + k) : 0u;
    a[kb][1] = k < kF ? ld32(hs + (g + 8) * kF + k) : 0u;
    a[kb][2] = k + 8 < kF ? ld32(hs + g * kF + k + 8) : 0u;
    a[kb][3] = k + 8 < kF ? ld32(hs + (g + 8) * kF + k + 8) : 0u;
  }
#pragma unroll
  for (int j = 0; j < kNT; ++j) {
    float c[4] = {b5[8 * j + t2], b5[8 * j + t2 + 1], b5[8 * j + t2], b5[8 * j + t2 + 1]};
#pragma unroll
    for (int kb = 0; kb < kKB; kb += 2) {
      uint32_t b[4];
      b_frags_k2(b, w5, kLdF, j, kb, lane);
      mma(c, a[kb], b[0], b[1]);
      mma(c, a[kb + 1], b[2], b[3]);
    }
    uq[j][0] = pack(c[0], c[1]);
    uq[j][1] = pack(c[2], c[3]);
  }
}

__global__ void __launch_bounds__(kThreads, 2) esa_a_mma_kernel(const Args p) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* w5 = reinterpret_cast<bf16*>(smem);
  bf16* w1 = reinterpret_cast<bf16*>(smem + kW5Bytes);
  bf16* wf = reinterpret_cast<bf16*>(smem + kW5Bytes + kW1Bytes);
  float* b5 = reinterpret_cast<float*>(smem + kW5Bytes + kW1Bytes + kWfBytes);
  float* b1 = b5 + 8 * kNT;
  float* bf = b1 + kE;
  bf16* tiles = reinterpret_cast<bf16*>(smem + kW5Bytes + kW1Bytes + kWfBytes + kABiasBytes);
  bf16* stage = tiles + kStages * kTile * kF;  // a warp's [16 px][16] of c1_, then of cf

  const bf16* const* w = reinterpret_cast<const bf16* const*>(p.wt);
  stage_nk(w5, 8 * kNT, kLdF, w[0], kF, kF);
  stage_nk(w1, kE, kLdF, w[2], kE, kF);
  stage_nk(wf, kE, kLdE, w[4], kE, kE);
  stage_bias(b5, 8 * kNT, w[1], kF);
  stage_bias(b1, kE, w[3], kE);
  stage_bias(bf, kE, w[5], kE);

  const bf16* x = static_cast<const bf16*>(p.x);
  const long long ntiles = (p.m + kTile - 1) / kTile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3, t2 = 2 * t;
  uint32_t* s32 = reinterpret_cast<uint32_t*>(stage + warp * 16 * 2 * kE);
  // the CTA's tiles blockIdx.x + i gridDim.x, the i-th in buffer i % kStages
  auto fetch = [&](long long t) {
    if (t < ntiles)
      load_rows(tiles + (int)((t - blockIdx.x) / gridDim.x % kStages) * kTile * kF,
                x + t * kTile * kF, (int)min((long long)kTile, p.m - t * kTile), kF);
    cp_async_commit();
  };
  for (int i = 0; i < kStages - 1; ++i) fetch(blockIdx.x + (long long)i * gridDim.x);
  long long tile = blockIdx.x;
  for (int cur = 0; tile < ntiles; tile += gridDim.x, cur = (cur + 1) % kStages) {
    fetch(tile + (long long)(kStages - 1) * gridDim.x);  // into the buffer freed last step
    cp_async_wait<kStages - 1>();
    __syncthreads();  // the tile (and, the first time, the weights) for every warp
    const long long p0 = tile * kTile + warp * 16;
    if (p0 < p.m) {
      uint32_t uq[kNT][2];
      c5_tile(tiles + cur * kTile * kF + warp * 16 * kF, w5, b5, lane, uq);
      // c1_ = conv1(u): u's n-tiles 2kb and 2kb + 1 are k-block kb's A fragment
      float c1[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        c1[j][0] = c1[j][2] = b1[8 * j + t2];
        c1[j][1] = c1[j][3] = b1[8 * j + t2 + 1];
      }
#pragma unroll
      for (int kb = 0; kb < kKB; kb += 2) {
        const uint32_t a0[4] = {uq[2 * kb][0], uq[2 * kb][1], uq[2 * kb + 1][0],
                                uq[2 * kb + 1][1]};
        const uint32_t a1[4] = {uq[2 * kb + 2][0], uq[2 * kb + 2][1],
                                2 * kb + 3 < kNT ? uq[2 * kb + 3][0] : 0u,
                                2 * kb + 3 < kNT ? uq[2 * kb + 3][1] : 0u};
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          uint32_t b[4];
          b_frags_k2(b, w1, kLdF, j, kb, lane);
          mma(c1[j], a0, b[0], b[1]);
          mma(c1[j], a1, b[2], b[3]);
        }
      }
      const uint32_t c1q[4] = {pack(c1[0][0], c1[0][1]), pack(c1[0][2], c1[0][3]),
                               pack(c1[1][0], c1[1][1]), pack(c1[1][2], c1[1][3])};
      // cf = conv_f(c1_): one k-block, c1_ rounded as it is stored
      float cf[2][4];
      uint32_t bfr[4];
      b_frags_n2(bfr, wf, kLdE, 0, 0, lane);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        cf[j][0] = cf[j][2] = bf[8 * j + t2];
        cf[j][1] = cf[j][3] = bf[8 * j + t2 + 1];
        mma(cf[j], c1q, bfr[2 * j], bfr[2 * j + 1]);
      }
      const uint32_t cfq[4] = {pack(cf[0][0], cf[0][1]), pack(cf[0][2], cf[0][3]),
                               pack(cf[1][0], cf[1][1]), pack(cf[1][2], cf[1][3])};
      // staged as [16 px][16 channels] (8 words a pixel), then 16-byte stores
      const int q[4] = {g * 8 + t, (g + 8) * 8 + t, g * 8 + 4 + t, (g + 8) * 8 + 4 + t};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s32[q[i]] = c1q[i];
        s32[128 + q[i]] = cfq[i];
      }
      __syncwarp();
      if (p0 + lane / 2 < p.m) {
        reinterpret_cast<uint4*>(static_cast<bf16*>(p.c1) + p0 * kE)[lane] =
            reinterpret_cast<const uint4*>(s32)[lane];
        reinterpret_cast<uint4*>(static_cast<bf16*>(p.cf) + p0 * kE)[lane] =
            reinterpret_cast<const uint4*>(s32 + 128)[lane];
      }
      __syncwarp();
    }
    __syncthreads();  // every warp is done with this buffer before it is refilled
  }
}

__global__ void __launch_bounds__(kThreads, 3) esa_c_mma_kernel(const Args p) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* w5 = reinterpret_cast<bf16*>(smem);
  bf16* w4 = reinterpret_cast<bf16*>(smem + kW5Bytes);
  float* b5 = reinterpret_cast<float*>(smem + kW5Bytes + kW4Bytes);
  float* b4 = b5 + 8 * kNT;
  bf16* tiles = reinterpret_cast<bf16*>(smem + kW5Bytes + kW4Bytes + kCBiasBytes);
  bf16* ftiles = tiles + kStages * kTile * kF;  // cf

  const bf16* const* w = reinterpret_cast<const bf16* const*>(p.wt);
  stage_nk(w5, 8 * kNT, kLdF, w[0], kF, kF);
  stage_nk(w4, 8 * (kNT + 1), kLdE, w[10], kF, kE);
  stage_bias(b5, 8 * kNT, w[1], kF);
  stage_bias(b4, 8 * kNT, w[11], kF);

  const bf16* x = static_cast<const bf16*>(p.x);
  const bf16* cfg = static_cast<const bf16*>(p.cf);
  const bf16* c3 = static_cast<const bf16*>(p.c3);
  const long long ntiles = (p.m + kTile - 1) / kTile;
  const int hw = p.h * p.w;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t2 = 2 * (lane & 3);
  // the CTA's tiles blockIdx.x + i gridDim.x, the i-th in buffer i % kStages
  auto fetch = [&](long long t) {
    if (t < ntiles) {
      const int b = (int)((t - blockIdx.x) / gridDim.x % kStages);
      const int rows = (int)min((long long)kTile, p.m - t * kTile);
      load_rows(tiles + b * kTile * kF, x + t * kTile * kF, rows, kF);
      load_rows(ftiles + b * kTile * kE, cfg + t * kTile * kE, rows, kE);
    }
    cp_async_commit();
  };
  for (int i = 0; i < kStages - 1; ++i) fetch(blockIdx.x + (long long)i * gridDim.x);
  long long tile = blockIdx.x;
  for (int cur = 0; tile < ntiles; tile += gridDim.x, cur = (cur + 1) % kStages) {
    fetch(tile + (long long)(kStages - 1) * gridDim.x);  // into the buffer freed last step
    cp_async_wait<kStages - 1>();
    __syncthreads();
    const long long p0 = tile * kTile + warp * 16;
    if (p0 < p.m) {
      bf16* hs = tiles + cur * kTile * kF + warp * 16 * kF;
      const bf16* fs = ftiles + cur * kTile * kE + warp * 16 * kE;
      // up(c3) at rows g and g + 8, channels t2, t2 + 1 and t2 + 8, t2 + 9:
      // the four corners' loads issued before c5, which hides them
      uint32_t v[2][2][4];  // [row][half][corner 00, 01, 10, 11]
      float lam[2][4];      // [row][ly0, ly1, lx0, lx1]
      // the warp's first pixel; rows g and g + 8 are at most one image row on
      const int n0 = (int)p0 / hw, rem0 = (int)p0 - n0 * hw, ya = rem0 / p.w, xa = rem0 - ya * p.w;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const bool in = p0 + g + 8 * r < p.m;  // rows past the end read the first's, not stored
        int n = n0, y = ya, xx = xa + (in ? g + 8 * r : 0);
        if (xx >= p.w) {
          xx -= p.w;
          if (++y == p.h) {
            y = 0;
            ++n;
          }
        }
        const float sy = fmaxf(p.rh * ((float)y + 0.5f) - 0.5f, 0.0f);
        const float sx = fmaxf(p.rw * ((float)xx + 0.5f) - 0.5f, 0.0f);
        const int y0 = (int)sy, x0 = (int)sx;
        const int y1 = y0 + (y0 < p.h3 - 1 ? 1 : 0), x1 = x0 + (x0 < p.w3 - 1 ? 1 : 0);
        lam[r][1] = sy - (float)y0;
        lam[r][0] = 1.0f - lam[r][1];
        lam[r][3] = sx - (float)x0;
        lam[r][2] = 1.0f - lam[r][3];
        const bf16* f0 = c3 + (long long)((n * p.h3 + y0) * p.w3) * kE + t2;
        const bf16* f1 = c3 + (long long)((n * p.h3 + y1) * p.w3) * kE + t2;
        const bf16* at[4] = {f0 + x0 * kE, f0 + x1 * kE, f1 + x0 * kE, f1 + x1 * kE};
#pragma unroll
        for (int hlf = 0; hlf < 2; ++hlf)
#pragma unroll
          for (int k = 0; k < 4; ++k)
            v[r][hlf][k] = __ldg(reinterpret_cast<const unsigned*>(at[k] + 8 * hlf));
      }
      uint32_t uq[kNT][2];
      c5_tile(hs, w5, b5, lane, uq);
      // s = up(c3) + cf: conv4's A fragment
      uint32_t a[4];
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int hlf = 0; hlf < 2; ++hlf) {
          const float2 v00 = unpack(v[r][hlf][0]), v01 = unpack(v[r][hlf][1]);
          const float2 v10 = unpack(v[r][hlf][2]), v11 = unpack(v[r][hlf][3]);
          const float2 cf = unpack(ld32(fs + (g + 8 * r) * kE + t2 + 8 * hlf));
          const float ly0 = lam[r][0], ly1 = lam[r][1], lx0 = lam[r][2], lx1 = lam[r][3];
          const float ux = round_to<bf16>(ly0 * (lx0 * v00.x + lx1 * v01.x) +
                                          ly1 * (lx0 * v10.x + lx1 * v11.x));
          const float uy = round_to<bf16>(ly0 * (lx0 * v00.y + lx1 * v01.y) +
                                          ly1 * (lx0 * v10.y + lx1 * v11.y));
          a[r + 2 * hlf] = pack(ux + cf.x, uy + cf.y);
        }
      __syncwarp();  // every lane has read its h fragments before the rows are overwritten
      uint32_t b[4];
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        float c[4] = {b4[8 * j + t2], b4[8 * j + t2 + 1], b4[8 * j + t2], b4[8 * j + t2 + 1]};
        if (j % 2 == 0) b_frags_n2(b, w4, kLdE, j, 0, lane);  // n-tiles j and j + 1
        mma(c, a, b[2 * (j % 2)], b[2 * (j % 2) + 1]);
        const int col = 8 * j + t2;
        if (col < kF) {
          const float2 u0 = unpack(uq[j][0]), u1 = unpack(uq[j][1]);
          st32(hs + g * kF + col, pack(u0.x * fast_sigmoid(c[0]), u0.y * fast_sigmoid(c[1])));
          st32(hs + (g + 8) * kF + col,
               pack(u1.x * fast_sigmoid(c[2]), u1.y * fast_sigmoid(c[3])));
        }
      }
      __syncwarp();
      // the warp's 16 rows, contiguous in shared memory and in the output
      const int bytes = (int)min(16LL, p.m - p0) * kF * 2;
      const char* src = reinterpret_cast<const char*>(hs);
      char* dst = reinterpret_cast<char*>(static_cast<bf16*>(p.out) + p0 * kF);
      for (int v = lane; v * 16 < bytes; v += 32) {
        if (v * 16 + 16 <= bytes)
          *reinterpret_cast<uint4*>(dst + v * 16) = *reinterpret_cast<const uint4*>(src + v * 16);
        else
          *reinterpret_cast<uint2*>(dst + v * 16) = *reinterpret_cast<const uint2*>(src + v * 16);
      }
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// Passes A and C in fp32: a thread a pixel, CUDA-core FMAs
// ---------------------------------------------------------------------------

constexpr int kAFmaSmem = (kF * kF + kF * kE + kE * kE + kF + 2 * kE) * 4;
constexpr int kCFmaSmem = (kF * kF + kE * kF + 2 * kF) * 4;

// a (co, ci, 1, 1) weight transposed to [ci][co] (a row a broadcast read)
__device__ void stage_kn(float* s, const float* w, int co, int ci) {
  for (int i = threadIdx.x; i < co * ci; i += blockDim.x) {
    const int k = i / co, n = i - k * co;
    s[i] = w[n * ci + k];
  }
}

__device__ __forceinline__ void c5_pixel(const float* xp, const float* w5, const float* b5,
                                         float (&u)[kF]) {
  float h[kF];
#pragma unroll
  for (int i = 0; i < kF / 4; ++i) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(xp) + i);
    h[4 * i] = v.x; h[4 * i + 1] = v.y; h[4 * i + 2] = v.z; h[4 * i + 3] = v.w;
  }
#pragma unroll
  for (int n = 0; n < kF; ++n) u[n] = b5[n];
#pragma unroll
  for (int k = 0; k < kF; ++k)
#pragma unroll
    for (int n = 0; n < kF; ++n) u[n] = fmaf(h[k], w5[k * kF + n], u[n]);
}

__device__ __forceinline__ void store16(float* dst, const float (&v)[kE]) {
#pragma unroll
  for (int i = 0; i < kE / 4; ++i)
    reinterpret_cast<float4*>(dst)[i] = make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2],
                                                    v[4 * i + 3]);
}

__global__ void __launch_bounds__(kThreads) esa_a_fma_kernel(const Args p) {
  extern __shared__ __align__(16) float fsm[];
  float* w5 = fsm;
  float* w1 = w5 + kF * kF;
  float* wf = w1 + kF * kE;
  float* b5 = wf + kE * kE;
  float* b1 = b5 + kF;
  float* bf = b1 + kE;
  const float* const* w = reinterpret_cast<const float* const*>(p.wt);
  stage_kn(w5, w[0], kF, kF);
  stage_kn(w1, w[2], kE, kF);
  stage_kn(wf, w[4], kE, kE);
  stage_bias(b5, kF, w[1], kF);
  stage_bias(b1, kE, w[3], kE);
  stage_bias(bf, kE, w[5], kE);
  __syncthreads();
  for (long long px = (long long)blockIdx.x * blockDim.x + threadIdx.x; px < p.m;
       px += (long long)gridDim.x * blockDim.x) {
    float u[kF];
    c5_pixel(static_cast<const float*>(p.x) + px * kF, w5, b5, u);
    float c1[kE], cf[kE];
#pragma unroll
    for (int n = 0; n < kE; ++n) c1[n] = b1[n];
#pragma unroll
    for (int k = 0; k < kF; ++k)
#pragma unroll
      for (int n = 0; n < kE; ++n) c1[n] = fmaf(u[k], w1[k * kE + n], c1[n]);
#pragma unroll
    for (int n = 0; n < kE; ++n) cf[n] = bf[n];
#pragma unroll
    for (int k = 0; k < kE; ++k)
#pragma unroll
      for (int n = 0; n < kE; ++n) cf[n] = fmaf(c1[k], wf[k * kE + n], cf[n]);
    store16(static_cast<float*>(p.c1) + px * kE, c1);
    store16(static_cast<float*>(p.cf) + px * kE, cf);
  }
}

__global__ void __launch_bounds__(kThreads) esa_c_fma_kernel(const Args p) {
  extern __shared__ __align__(16) float fsm[];
  float* w5 = fsm;
  float* w4 = w5 + kF * kF;
  float* b5 = w4 + kE * kF;
  float* b4 = b5 + kF;
  const float* const* w = reinterpret_cast<const float* const*>(p.wt);
  stage_kn(w5, w[0], kF, kF);
  stage_kn(w4, w[10], kF, kE);
  stage_bias(b5, kF, w[1], kF);
  stage_bias(b4, kF, w[11], kF);
  __syncthreads();
  const float* c3 = static_cast<const float*>(p.c3);
  const long long hw = (long long)p.h * p.w;
  for (long long px = (long long)blockIdx.x * blockDim.x + threadIdx.x; px < p.m;
       px += (long long)gridDim.x * blockDim.x) {
    float u[kF];
    c5_pixel(static_cast<const float*>(p.x) + px * kF, w5, b5, u);
    const long long n = px / hw;
    const int rem = (int)(px - n * hw), y = rem / p.w, xx = rem - y * p.w;
    const float sy = fmaxf(p.rh * ((float)y + 0.5f) - 0.5f, 0.0f);
    const float sx = fmaxf(p.rw * ((float)xx + 0.5f) - 0.5f, 0.0f);
    const int y0 = (int)sy, x0 = (int)sx;
    const int y1 = y0 + (y0 < p.h3 - 1 ? 1 : 0), x1 = x0 + (x0 < p.w3 - 1 ? 1 : 0);
    const float ly1 = sy - (float)y0, ly0 = 1.0f - ly1;
    const float lx1 = sx - (float)x0, lx0 = 1.0f - lx1;
    const float* f00 = c3 + ((n * p.h3 + y0) * p.w3 + x0) * kE;
    const float* f01 = c3 + ((n * p.h3 + y0) * p.w3 + x1) * kE;
    const float* f10 = c3 + ((n * p.h3 + y1) * p.w3 + x0) * kE;
    const float* f11 = c3 + ((n * p.h3 + y1) * p.w3 + x1) * kE;
    const float* cfp = static_cast<const float*>(p.cf) + px * kE;
    float s[kE];
#pragma unroll
    for (int c = 0; c < kE; ++c)
      s[c] = ly0 * (lx0 * __ldg(f00 + c) + lx1 * __ldg(f01 + c)) +
             ly1 * (lx0 * __ldg(f10 + c) + lx1 * __ldg(f11 + c)) + __ldg(cfp + c);
    float* op = static_cast<float*>(p.out) + px * kF;
#pragma unroll
    for (int i = 0; i < kF / 4; ++i) {
      float o[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int nn = 4 * i + e;
        float acc = b4[nn];
#pragma unroll
        for (int k = 0; k < kE; ++k) acc = fmaf(s[k], w4[k * kF + nn], acc);
        o[e] = u[nn] * sigmoid(acc);
      }
      reinterpret_cast<float4*>(op)[i] = make_float4(o[0], o[1], o[2], o[3]);
    }
  }
}

// ---------------------------------------------------------------------------
// Pass B: conv2 (3x3, stride 2) and the 7x7 stride-3 max-pool; conv3 (3x3,
// padding 1).  CUDA-core FMAs, fp32 sums, both dtypes.
// ---------------------------------------------------------------------------

constexpr int kB1Smem = (kE + 9 * kE * kE + kRegY * kRegX * kE) * 4;

// a (co, ci, 3, 3) weight as [tap][ci][co]
template <typename T>
__device__ void stage_taps(float* s, const T* w) {
  for (int i = threadIdx.x; i < 9 * kE * kE; i += blockDim.x) {
    const int tap = i / (kE * kE), ci = (i / kE) % kE, co = i % kE;
    s[i] = widen(w[(co * kE + ci) * 9 + tap]);
  }
}

__device__ __forceinline__ void load16(const float* p, float (&v)[kE]) {
#pragma unroll
  for (int i = 0; i < kE / 4; ++i) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p) + i);
    v[4 * i] = q.x; v[4 * i + 1] = q.y; v[4 * i + 2] = q.z; v[4 * i + 3] = q.w;
  }
}
__device__ __forceinline__ void load16(const bf16* p, float (&v)[kE]) {
#pragma unroll
  for (int i = 0; i < kE / 8; ++i) {
    const uint4 q = __ldg(reinterpret_cast<const uint4*>(p) + i);
    const uint32_t words[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = unpack(words[j]);
      v[8 * i + 2 * j] = f.x;
      v[8 * i + 2 * j + 1] = f.y;
    }
  }
}
__device__ __forceinline__ void store16(bf16* p, const float (&v)[kE]) {
#pragma unroll
  for (int i = 0; i < kE / 8; ++i)
    reinterpret_cast<uint4*>(p)[i] = make_uint4(pack(v[8 * i], v[8 * i + 1]),
                                                pack(v[8 * i + 2], v[8 * i + 3]),
                                                pack(v[8 * i + 4], v[8 * i + 5]),
                                                pack(v[8 * i + 6], v[8 * i + 7]));
}

__device__ __forceinline__ void tap_fma(const float (&in)[kE], const float* wt, float (&acc)[kE]) {
#pragma unroll
  for (int ci = 0; ci < kE; ++ci)
#pragma unroll
    for (int co = 0; co < kE; ++co) acc[co] = fmaf(in[ci], wt[ci * kE + co], acc[co]);
}

// conv2 over a CTA's region in bf16 on the tensor cores: a warp an m16 tile
// of 16 neighbouring outputs of one row, the nine taps nine k-blocks of 16
// input channels (A fragments loaded from c1_, two pixels apart), the
// weights' B fragments in registers
__device__ void conv2_region_mma(const Args& p, const bf16* src, const bf16* w2, const float* b2,
                                 int py0, int px0, int ryn, int rxn, float* reg) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t2 = 2 * (lane & 3);
  uint32_t wb[9][2][2];  // [tap][n-tile][b0, b1]: W[co][ci][tap] at co = 8j + g
#pragma unroll
  for (int tap = 0; tap < 9; ++tap)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const bf16* q = w2 + ((8 * j + g) * kE + t2 + 8 * r) * 9 + tap;
        wb[tap][j][r] = (uint32_t)__bfloat16_as_ushort(q[0]) |
                        ((uint32_t)__bfloat16_as_ushort(q[9]) << 16);
      }
  const int chunks = (rxn + 15) / 16;
  for (int mt = warp; mt < ryn * chunks; mt += kThreads / 32) {
    const int oy = mt / chunks, ox0 = (mt - oy * chunks) * 16;
    // outputs past the region read its last one's inputs and are not kept
    const int oxa = min(ox0 + g, rxn - 1), oxb = min(ox0 + g + 8, rxn - 1);
    const long long row = (long long)2 * (3 * py0 + oy) * p.w;
    const bf16* ra = src + (row + 2 * (3 * px0 + oxa)) * kE + t2;
    const bf16* rb = src + (row + 2 * (3 * px0 + oxb)) * kE + t2;
    float c[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      c[j][0] = c[j][2] = b2[8 * j + t2];
      c[j][1] = c[j][3] = b2[8 * j + t2 + 1];
    }
#pragma unroll
    for (int ky = 0; ky < 3; ++ky)
#pragma unroll
      for (int kx = 0; kx < 3; ++kx) {
        const long long off = ((long long)ky * p.w + kx) * kE;
        const uint32_t a[4] = {__ldg(reinterpret_cast<const unsigned*>(ra + off)),
                               __ldg(reinterpret_cast<const unsigned*>(rb + off)),
                               __ldg(reinterpret_cast<const unsigned*>(ra + off + 8)),
                               __ldg(reinterpret_cast<const unsigned*>(rb + off + 8))};
#pragma unroll
        for (int j = 0; j < 2; ++j) mma(c[j], a, wb[ky * 3 + kx][j][0], wb[ky * 3 + kx][j][1]);
      }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int co = 8 * j + t2;
      if (ox0 + g < rxn) {
        float* r0 = reg + (oy * kRegX + ox0 + g) * kE + co;
        r0[0] = round_to<bf16>(c[j][0]);
        r0[1] = round_to<bf16>(c[j][1]);
      }
      if (ox0 + g + 8 < rxn) {
        float* r1 = reg + (oy * kRegX + ox0 + g + 8) * kE + co;
        r1[0] = round_to<bf16>(c[j][2]);
        r1[1] = round_to<bf16>(c[j][3]);
      }
    }
  }
}

// conv2 over a CTA's region in fp32: a thread an output, CUDA-core FMAs
__device__ void conv2_region_fma(const Args& p, const float* src, const float* w2,
                                 const float* b2, int py0, int px0, int ryn, int rxn,
                                 float* reg) {
  for (int i = threadIdx.x; i < ryn * rxn; i += blockDim.x) {
    const int oy = i / rxn, ox = i - oy * rxn;
    float acc[kE];
#pragma unroll
    for (int c = 0; c < kE; ++c) acc[c] = b2[c];
    const float* base = src + ((long long)2 * (3 * py0 + oy) * p.w + 2 * (3 * px0 + ox)) * kE;
#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const float* q = base + ((long long)(tap / 3) * p.w + tap % 3) * kE;
      const float4* wt = reinterpret_cast<const float4*>(w2 + tap * kE * kE);
#pragma unroll 4
      for (int ci = 0; ci < kE; ++ci) {
        const float v = __ldg(q + ci);
#pragma unroll
        for (int k = 0; k < kE / 4; ++k) {
          const float4 wv = wt[ci * (kE / 4) + k];
          acc[4 * k] = fmaf(v, wv.x, acc[4 * k]);
          acc[4 * k + 1] = fmaf(v, wv.y, acc[4 * k + 1]);
          acc[4 * k + 2] = fmaf(v, wv.z, acc[4 * k + 2]);
          acc[4 * k + 3] = fmaf(v, wv.w, acc[4 * k + 3]);
        }
      }
    }
    float* r = reg + (oy * kRegX + ox) * kE;
#pragma unroll
    for (int c = 0; c < kE; ++c) r[c] = acc[c];
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) esa_b1_kernel(const Args p) {
  extern __shared__ __align__(16) float bsm[];
  float* b2 = bsm;
  float* w2 = b2 + kE;                // fp32: [tap][ci][co]
  float* reg = w2 + 9 * kE * kE;      // [kRegY][kRegX][kE] conv2 outputs, rounded to T
  const T* const* w = reinterpret_cast<const T* const*>(p.wt);
  stage_bias(b2, kE, w[7], kE);
  if constexpr (!std::is_same<T, bf16>::value) stage_taps(w2, w[6]);
  __syncthreads();

  const int tx = blockIdx.x % p.tiles_x;
  const int ty = (blockIdx.x / p.tiles_x) % p.tiles_y;
  const long long n = blockIdx.x / (p.tiles_x * p.tiles_y);
  const int py0 = ty * kPoolY, px0 = tx * kPoolX;
  const int pyn = min(kPoolY, p.h3 - py0), pxn = min(kPoolX, p.w3 - px0);
  const int ryn = 3 * pyn + 4, rxn = 3 * pxn + 4;  // conv2 rows 3 py0 + [0, ryn), cols likewise
  const T* src = static_cast<const T*>(p.c1) + n * p.h * p.w * kE;
  if constexpr (std::is_same<T, bf16>::value)
    conv2_region_mma(p, src, w[6], b2, py0, px0, ryn, rxn, reg);
  else
    conv2_region_fma(p, src, w2, b2, py0, px0, ryn, rxn, reg);
  __syncthreads();

  T* out = static_cast<T*>(p.pool);
  for (int i = threadIdx.x; i < pyn * pxn * kE; i += blockDim.x) {
    const int c = i % kE, q = i / kE, py = q / pxn, px = q - py * pxn;
    float m = -INFINITY;
    for (int dy = 0; dy < 7; ++dy)
#pragma unroll
      for (int dx = 0; dx < 7; ++dx) {
        const float v = reg[((3 * py + dy) * kRegX + 3 * px + dx) * kE + c];
        if (v > m || isnan(v)) m = v;  // max_pool2d's rule: NaN propagates
      }
    out[((n * p.h3 + py0 + py) * p.w3 + px0 + px) * kE + c] = narrow<T>(m);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) esa_b2_kernel(const Args p) {
  __shared__ __align__(16) float w3[9 * kE * kE];
  __shared__ float b3[kE];
  const T* const* w = reinterpret_cast<const T* const*>(p.wt);
  stage_taps(w3, w[8]);
  stage_bias(b3, kE, w[9], kE);
  __syncthreads();
  const long long q = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= (long long)p.n * p.h3 * p.w3) return;
  const int x = (int)(q % p.w3), y = (int)((q / p.w3) % p.h3);
  const long long n = q / ((long long)p.w3 * p.h3);
  const T* src = static_cast<const T*>(p.pool);
  float acc[kE];
#pragma unroll
  for (int c = 0; c < kE; ++c) acc[c] = b3[c];
#pragma unroll
  for (int ky = 0; ky < 3; ++ky) {
    const int iy = y + ky - 1;
    if (iy < 0 || iy >= p.h3) continue;
#pragma unroll
    for (int kx = 0; kx < 3; ++kx) {
      const int ix = x + kx - 1;
      if (ix < 0 || ix >= p.w3) continue;
      float in[kE];
      load16(src + ((n * p.h3 + iy) * p.w3 + ix) * kE, in);
      tap_fma(in, w3 + (ky * 3 + kx) * kE * kE, acc);
    }
  }
#pragma unroll
  for (int c = 0; c < kE; ++c) acc[c] = round_to<T>(acc[c]);
  store16(static_cast<T*>(p.c3) + q * kE, acc);
}

// `want` blocks of `smem` bytes each; a persistent kernel (`persistent`)
// gets no more than fit on the card at once, and walks the rest itself
template <typename K>
cudaError_t launch(K kernel, long long want, int smem, bool persistent, cudaStream_t st,
                   const Args& p) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  if (persistent) {
    int dev = 0, sms = 0, per_sm = 0;
    if ((e = cudaGetDevice(&dev)) != cudaSuccess ||
        (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess ||
        (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem)) !=
            cudaSuccess)
      return e;
    const long long all = (long long)(per_sm > 0 ? per_sm : 1) * sms;
    want = want < all ? want : all;
  }
  if (want > 0x7fffffffLL) return cudaErrorInvalidValue;
  kernel<<<(unsigned)want, kThreads, smem, st>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_b(const Args& p, cudaStream_t st) {
  const long long b1 = (long long)p.n * p.tiles_y * p.tiles_x;
  const long long b2 = ((long long)p.n * p.h3 * p.w3 + kThreads - 1) / kThreads;
  cudaError_t e = launch(esa_b1_kernel<T>, b1, kB1Smem, false, st, p);
  return e != cudaSuccess ? e : launch(esa_b2_kernel<T>, b2, 0, false, st, p);
}

}  // namespace

extern "C" {

// The passes a call launches, in order (kernels/esa.py counts them).
int esa_passes() { return 4; }

// Launch c5 and ESA over n frames of h x w on `stream`; returns the first
// CUDA error (0 = ok).  dtype: 0 = float32, 1 = bfloat16, for x, every
// weight and bias and every map.  x (n, h, w, 52) contiguous; w: c5's
// weight and bias, then conv1's, conv_f's, conv2's, conv3's and conv4's, in
// (Co, Ci, k, k) and (Co,) layouts, contiguous; c1 and cf (n, h, w, 16),
// pool and c3 (n, h3, w3, 16), out (n, h, w, 52), all contiguous and
// 16-byte aligned, with h2 = (h - 3) / 2 + 1, h3 = (h2 - 7) / 3 + 1 (w
// likewise), h and w at least 15.  Does not synchronise or allocate.
int esa_launch(int dtype, const void* x, const void* const* w, void* c1, void* cf, void* pool,
               void* c3, void* out, int n, int h, int wd, void* stream) {
  if (n <= 0) return 0;
  // pixel indices of pass C are 32-bit
  if (dtype < 0 || dtype > 1 || h < 15 || wd < 15 || (long long)n * h * wd > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const void* ptrs[6] = {x, c1, cf, pool, c3, out};
  for (const void* q : ptrs)
    if (reinterpret_cast<uintptr_t>(q) % 16 != 0) return (int)cudaErrorInvalidValue;
  Args p;
  p.x = x;
  for (int i = 0; i < 12; ++i) p.wt[i] = w[i];
  p.c1 = c1; p.cf = cf; p.pool = pool; p.c3 = c3; p.out = out;
  p.n = n; p.h = h; p.w = wd;
  p.m = (long long)n * h * wd;
  p.h2 = (h - 3) / 2 + 1; p.w2 = (wd - 3) / 2 + 1;
  p.h3 = (p.h2 - 7) / 3 + 1; p.w3 = (p.w2 - 7) / 3 + 1;
  p.rh = (float)p.h3 / (float)h;  // upsample_bilinear2d's scale (align_corners=False)
  p.rw = (float)p.w3 / (float)wd;
  p.tiles_x = (p.w3 + kPoolX - 1) / kPoolX;
  p.tiles_y = (p.h3 + kPoolY - 1) / kPoolY;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (dtype == 1) {
    const long long tiles = (p.m + kTile - 1) / kTile;
    if ((e = launch(esa_a_mma_kernel, tiles, kASmem, true, st, p)) != cudaSuccess ||
        (e = launch_b<bf16>(p, st)) != cudaSuccess ||
        (e = launch(esa_c_mma_kernel, tiles, kCSmem, true, st, p)) != cudaSuccess)
      return (int)e;
    return 0;
  }
  const long long groups = (p.m + kThreads - 1) / kThreads;
  if ((e = launch(esa_a_fma_kernel, groups, kAFmaSmem, true, st, p)) != cudaSuccess ||
      (e = launch_b<float>(p, st)) != cudaSuccess ||
      (e = launch(esa_c_fma_kernel, groups, kCFmaSmem, true, st, p)) != cudaSuccess)
    return (int)e;
  return 0;
}

const char* esa_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
