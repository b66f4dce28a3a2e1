// One SAME 3x3 conv layer on Hopper (sm_90a): the layer-by-layer baseline
// datapath.
//
// Replaces: src/repro/kernels/conv3x3.py::_kernel, the Pallas TPU kernel
// launched by conv3x3_call over a grid of column tiles of one whole band.
//
// What it computes, exactly as the TPU kernel does: out = x (*) w + b over an
// (R, W, Ci) NHWC band with HWIO weights (3, 3, Ci, Co), SAME zero padding on
// all four sides; input, weights and bias widened to fp32, fp32 FMAs on the
// CUDA cores (no TF32, no tensor cores), the bias added in fp32, then the
// optional ReLU, then ONE rounding to the storage dtype at the store.
//
// What bounds it on this card: at 28 -> 28 channels an output pixel costs
// 14,112 FLOP against 224 B moved in fp32 (one read of the input map, one
// write of the output map), 63 FLOP/B, above the H100's 20 FLOP/B ridge
// (67 TFLOP/s fp32 on the CUDA cores over 3.35 TB/s): bound by operations,
// 48.5 us per 360x640 map.  The 3 -> 28 first layer (12 FLOP/B) is bound by
// bytes, 8.5 us.
//
// What this first design does about it (simple and right first):
//   * the TPU grid (K column tiles over one whole band) is not copied: it
//     would give a handful of CTAs for 132 SMs.  Here one CTA owns a
//     (kRowBlock rows, C columns) output tile, C = tile_cols; a 360x640 map
//     at C = 8 is 23 x 80 = 1,840 CTAs.
//   * the CTA stages its input window (kRowBlock+2, C+2, Ci), zero outside
//     the image, and the whole (3, 3, Ci, Co) weight tensor, both widened to
//     fp32, in shared memory.  The window is stored channel-planar, so the
//     threads of a warp read neighbouring words.
//   * each thread owns kPix vertically adjacent output pixels x kGroup output
//     channels in fp32 registers; per input channel it reads (kPix+2) x 3
//     window values and 9 x kGroup weights (as float4, the same address for
//     the whole warp) for kPix x 9 x kGroup FMAs.
// Left for later work: tensor cores (wgmma), TMA, weights kept resident
// across tiles in a persistent CTA, vectorised stores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRowBlock = 16;    // output rows per CTA
constexpr int kPix = 4;          // vertically adjacent output pixels per thread
constexpr int kGroup = 8;        // output channels per thread
constexpr int kMaxThreads = 256;
constexpr int kMaxChannels = 32;  // Ci, Co limit (conv3x3.py MAX_CHANNELS)
constexpr int kMaxTileCols = 64;  // C limit (conv3x3.py MAX_TILE_COLS)
static_assert(kRowBlock % kPix == 0, "a thread's pixels stay inside the row block");

struct Params {
  const void* x;     // (R, W, Ci), storage dtype
  const void* w;     // (3, 3, Ci, Co), storage dtype
  const void* bias;  // (Co,), storage dtype
  void* out;         // (R, W, Co), storage dtype
  int R, W, ci, co, C, relu;
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Output channels padded to whole thread groups (zero weights beyond Co).
__host__ __device__ inline int padded_co(int co) { return (co + kGroup - 1) / kGroup * kGroup; }

// Dynamic shared memory of one CTA: the fp32 weights, then the fp32 window.
__host__ __device__ inline int smem_bytes(int ci, int co, int C) {
  return (9 * ci * padded_co(co) + ci * (kRowBlock + 2) * (C + 2)) * (int)sizeof(float);
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
conv3x3_kernel(Params p) {
  extern __shared__ float4 smem4[];
  const int R = p.R, W = p.W, ci_n = p.ci, co_n = p.co, C = p.C;
  const int cop = padded_co(co_n);
  const int SR = kRowBlock + 2, SC = C + 2;  // window rows, columns
  float* wsm = reinterpret_cast<float*>(smem4);  // [tap][ci][cop]
  float* win = wsm + 9 * ci_n * cop;             // [ci][SR][SC]

  const int c0 = blockIdx.x * C;          // first output column of the tile
  const int r0 = blockIdx.y * kRowBlock;  // first output row of the tile
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const T* x = reinterpret_cast<const T*>(p.x);
  const T* wg = reinterpret_cast<const T*>(p.w);
  const T* bias = reinterpret_cast<const T*>(p.bias);
  T* out = reinterpret_cast<T*>(p.out);

  for (int i = tid; i < 9 * ci_n * cop; i += nthreads) {
    const int co = i % cop, tc = i / cop;  // tc = tap * Ci + ci
    wsm[i] = co < co_n ? to_f(wg[(size_t)tc * co_n + co]) : 0.f;
  }
  // Window rows [r0-1, r0+kRowBlock], columns [c0-1, c0+C]; read in NHWC
  // order (coalesced), zero outside the image — never clamped.
  for (int i = tid; i < SR * SC * ci_n; i += nthreads) {
    const int ci = i % ci_n, col = (i / ci_n) % SC, row = i / (ci_n * SC);
    const int gr = r0 - 1 + row, gc = c0 - 1 + col;
    const bool in = gr >= 0 && gr < R && gc >= 0 && gc < W;
    win[(ci * SR + row) * SC + col] = in ? to_f(x[((size_t)gr * W + gc) * ci_n + ci]) : 0.f;
  }
  __syncthreads();

  // Items: (output-channel group g, pixel column j, row group rg); the
  // threads of a warp share g, so their weight reads are one broadcast.
  const int npix = (kRowBlock / kPix) * C;
  const int items = npix * (cop / kGroup);
  for (int it = tid; it < items; it += nthreads) {
    const int g = it / npix, pi = it % npix;
    const int j = pi % C, rr0 = (pi / C) * kPix;  // window row of output row r0 + rr0 is rr0 + 1
    float acc[kPix][kGroup];
#pragma unroll
    for (int q = 0; q < kPix; ++q)
#pragma unroll
      for (int k = 0; k < kGroup; ++k) acc[q][k] = 0.f;

    for (int ci = 0; ci < ci_n; ++ci) {
      const float* plane = win + (ci * SR + rr0) * SC + j;
      float v[kPix + 2][3];
#pragma unroll
      for (int rr = 0; rr < kPix + 2; ++rr)
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) v[rr][dx] = plane[rr * SC + dx];
#pragma unroll
      for (int dy = 0; dy < 3; ++dy)
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const float4* w4 = reinterpret_cast<const float4*>(
              wsm + ((dy * 3 + dx) * ci_n + ci) * cop + g * kGroup);
#pragma unroll
          for (int h = 0; h < kGroup / 4; ++h) {
            const float4 wv = w4[h];
#pragma unroll
            for (int q = 0; q < kPix; ++q) {
              const float a = v[q + dy][dx];
              acc[q][4 * h + 0] = fmaf(a, wv.x, acc[q][4 * h + 0]);
              acc[q][4 * h + 1] = fmaf(a, wv.y, acc[q][4 * h + 1]);
              acc[q][4 * h + 2] = fmaf(a, wv.z, acc[q][4 * h + 2]);
              acc[q][4 * h + 3] = fmaf(a, wv.w, acc[q][4 * h + 3]);
            }
          }
        }
    }

    // Epilogue: fp32 bias, optional ReLU, one rounding; rows, columns and
    // channels beyond the map are not stored.
    const int c = c0 + j;
    if (c >= W) continue;
#pragma unroll
    for (int q = 0; q < kPix; ++q) {
      const int r = r0 + rr0 + q;
      if (r >= R) break;
      T* o = out + ((size_t)r * W + c) * co_n;
#pragma unroll
      for (int k = 0; k < kGroup; ++k) {
        const int co = g * kGroup + k;
        if (co >= co_n) break;
        float y = acc[q][k] + to_f(bias[co]);
        if (p.relu) y = fmaxf(y, 0.f);
        o[co] = from_f<T>(y);
      }
    }
  }
}

template <typename T>
cudaError_t launch_typed(const Params& p, cudaStream_t stream) {
  const int smem = smem_bytes(p.ci, p.co, p.C);
  cudaError_t e = cudaFuncSetAttribute(
      conv3x3_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const int items = (kRowBlock / kPix) * p.C * (padded_co(p.co) / kGroup);
  int threads = (items + 31) / 32 * 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  const dim3 grid((p.W + p.C - 1) / p.C, (p.R + kRowBlock - 1) / kRowBlock);
  conv3x3_kernel<T><<<grid, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch on `stream`; returns cudaGetLastError() after the launch (0 = ok).
// dtype: 0 = float32, 1 = bfloat16.  Does not synchronise or allocate.
int conv3x3_launch(int dtype, const void* x, const void* w, const void* bias, void* out,
                   int R, int W, int ci, int co, int C, int relu, void* stream) {
  if (R <= 0 || W <= 0) return 0;
  if (ci < 1 || co < 1 || ci > kMaxChannels || co > kMaxChannels || C < 1 ||
      C > kMaxTileCols)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.x = x; p.w = w; p.bias = bias; p.out = out;
  p.R = R; p.W = W; p.ci = ci; p.co = co; p.C = C; p.relu = relu;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (dtype == 0) e = launch_typed<float>(p, s);
  else if (dtype == 1) e = launch_typed<__nv_bfloat16>(p, s);
  else e = cudaErrorInvalidValue;
  return (int)e;
}

const char* conv3x3_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
