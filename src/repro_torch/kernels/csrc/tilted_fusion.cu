// Tilted layer fusion on Hopper (sm_90a): the fused L-layer 3x3 conv stack
// swept over a band by tilted column tiles.
//
// Replaces: src/repro/kernels/tilted_fusion.py::tilted_fusion_kernel, the
// Pallas TPU kernel launched by tilted_fusion_call over grid (band, tile k).
//
// What bounds it on this card: arithmetic.  ABPN x3 is 42,840 MAC per LR
// pixel; padded to Chp = 32 channels a 360x640 frame is ~29.7 GFLOP against
// ~30 MB of output, so the FP32 units (67 TFLOP/s on an H100 SXM) are the
// roofline, not the 3.35 TB/s of device memory.  The second limit is
// parallelism: the overlap queue carries state from tile k to tile k+1, so a
// band is one sequential sweep, and a 360-row frame has only 6 bands.
//
// What this design does about it:
//   * column segments: each band's K tiles are cut into S contiguous
//     segments [k0, k1) of near-equal length (k0 = seg*K/S, rounded down),
//     and each (band, segment) pair is one CTA, so B*S CTAs fill the SMs
//     where one CTA per band would fill B of them.  A segment that starts at
//     k0 >= w restarts the sweep at kw = k0 - w with w = ceil((2L-1)/C)
//     warm-up tiles: the F_0 slot of the overlap queue holds the true input
//     columns kw*C-1 and kw*C, the deeper layers' slots start at zero, and
//     tiles kw..k0-1 run layers 0..L-2 and store nothing.  A wrong carried
//     column of F_l reaches at most one more column per layer, so after w
//     tiles (w*C >= 2L-1 columns) every column a layer carries into tile k0
//     is the full sweep's, bit for bit; the output does not depend on S.
//     A segment with k0 < w starts at tile 0 with the band-start state.
//   * the tile loop runs inside the CTA, with __syncthreads() between
//     layers (the TPU's in-order grid axis becomes a loop, since CTAs run in
//     no order).  Bands and segments are independent, so nothing crosses
//     CTAs.
//   * carried state lives in a per-CTA device-memory workspace the wrapper
//     allocates (B*S of them): two ping-pong slabs (Chp, R, C+2) and the
//     overlap queue (L, Chp, R, 2).  Shared memory holds only two stages of
//     one layer's weights (fp32, 2 x 9 x Chp x Chp), so its size does not
//     depend on R and every band height the planner derives (divisors up to
//     60, 74-row halo slabs, a one-band fallback of any height) launches.
//   * every product and sum is an fp32 FMA on the CUDA cores — no TF32, no
//     tensor cores; bf16 plans store inputs, weights and carried feature
//     maps in bf16 and round each layer's masked output to bf16.
//   * each thread owns kPix vertically adjacent output pixels x all Chp
//     output channels in registers; weights are broadcast from shared
//     memory as float4.
// Left for later work: tensor cores (wgmma), TMA and shared-memory slabs.
//
// The anchor (add_anchor) is read straight from the input stream: the ring
// the TPU kernel keeps holds exactly input columns [kC-L+1, kC+C], which are
// still in device memory here.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPix = 2;  // output rows per thread item

struct Params {
  const void* x;       // (B, R, K*C, c0p) fresh input stream, compute dtype
  const void* first;   // (B, R, 1, c0p) first input column of each band
  const void* w;       // (L, 3, 3, Chp, Chp) packed weights, compute dtype
  const void* bias;    // (L, Chp), compute dtype
  const int* bounds;   // (B, 2) valid [lo, hi) rows, or null
  void* out;           // (B, R, K*C, Chp), compute dtype
  void* ws;            // per-CTA workspace (see workspace_elems)
  int R, K, C, c0p, L, W;
  int S, warm;         // segments per band, warm-up tiles of a restarted one
  int relu_mask, add_anchor, in_ch, repeats, replicate;
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Elements of one CTA's workspace: two slabs + the overlap queue (the
// wrapper allocates B*S of these; tilted_fusion.py::workspace_shapes).
__device__ inline size_t workspace_elems(int chp, int R, int C, int L) {
  return 2 * (size_t)chp * R * (C + 2) + (size_t)L * chp * R * 2;
}

// Two resident CTAs per SM: registers capped at 128 a thread (the fp32 Chp 32
// instance otherwise takes 195, which leaves room for one).
template <typename T, int CHP>
__global__ void __launch_bounds__(kThreads, 2)
tilted_fusion_kernel(Params p) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);  // 2 stages x 9*CHP*CHP

  const int cta = blockIdx.x;  // band * S + segment
  const int band = cta / p.S, seg = cta % p.S;
  const int tid = threadIdx.x;
  const int R = p.R, K = p.K, C = p.C, c0p = p.c0p, L = p.L, W = p.W;
  const int SC = C + 2;  // slab columns: 2 carried + C fresh
  const int KC = K * C;
  const size_t slab = (size_t)CHP * R * SC;
  const int wsz = 9 * CHP * CHP;
  // This segment's own tiles [k0, k1) and the tile kw its sweep starts at.
  const int k0 = (int)((long long)seg * K / p.S);
  const int k1 = (int)((long long)(seg + 1) * K / p.S);
  const int kw = k0 >= p.warm ? k0 - p.warm : 0;

  T* ws = reinterpret_cast<T*>(p.ws) + (size_t)cta * workspace_elems(CHP, R, C, L);
  T* ov = ws + 2 * slab;  // overlap queue (L, CHP, R, 2)
  const T* x = reinterpret_cast<const T*>(p.x) + (size_t)band * R * KC * c0p;
  const T* first = reinterpret_cast<const T*>(p.first) + (size_t)band * R * c0p;
  const T* wg = reinterpret_cast<const T*>(p.w);
  const T* bias = reinterpret_cast<const T*>(p.bias);
  T* out = reinterpret_cast<T*>(p.out) + (size_t)band * R * KC * CHP;

  const bool mask_rows = p.bounds != nullptr;
  const int lo = mask_rows ? p.bounds[2 * band] : 0;
  const int hi = mask_rows ? p.bounds[2 * band + 1] : R;

  // Start of the sweep at tile kw: slot 0 of the overlap queue holds input
  // columns kw*C-1 and kw*C (input column a is zero for a < 0, the first
  // column for a = 0 and stream column a-1 after it), every deeper slot
  // zero.  For kw = 0 that is the band-start state: [zero pad, first].
  for (int i = tid; i < L * CHP * R * 2; i += kThreads) {
    const int col = i % 2, r = (i / 2) % R, c = (i / (2 * R)) % CHP, l = i / (2 * R * CHP);
    const int a = kw * C - 1 + col;
    T v = from_f<T>(0.f);
    if (l == 0 && c < c0p && a >= 0)
      v = a == 0 ? first[r * c0p + c] : x[((size_t)r * KC + a - 1) * c0p + c];
    ov[i] = v;
  }
  for (int i = tid; i < wsz; i += kThreads) smem[i] = to_f(wg[i]);
  __syncthreads();

  const int nitems = ((R + kPix - 1) / kPix) * C;
  int step = 0;  // (k, l) counter: layer weights of step s sit in stage s & 1
  for (int k = kw; k < k1; ++k) {
    // A warm-up tile (k < k0) runs layers 0..L-2 only: layer L-1's output
    // is not carried, and a warm-up tile stores nothing.
    const int nl = k < k0 ? L - 1 : L;
    // Layer-0 input slab: 2 carried columns ++ C fresh columns (c0p channels).
    T* in0 = ws;
    for (int i = tid; i < c0p * R * SC; i += kThreads) {
      const int col = i % SC, r = (i / SC) % R, c = i / (SC * R);
      in0[i] = col < 2 ? ov[(c * R + r) * 2 + col]
                       : x[((size_t)r * KC + k * C + col - 2) * c0p + c];
    }
    __syncthreads();
    // F_0's last two columns are tile k+1's carried columns.
    for (int i = tid; i < c0p * R * 2; i += kThreads) {
      const int col = i % 2, r = (i / 2) % R, c = i / (2 * R);
      ov[i] = in0[(c * R + r) * SC + C + col];
    }

    for (int l = 0; l < nl; ++l, ++step) {
      const float* wsm = smem + (step & 1) * wsz;
      if (!(l == nl - 1 && k == k1 - 1)) {  // prefetch the next step's weights
        const T* src = wg + (size_t)(l + 1 < nl ? l + 1 : 0) * wsz;
        float* dst = smem + ((step + 1) & 1) * wsz;
        for (int i = tid; i < wsz; i += kThreads) dst[i] = to_f(src[i]);
      }
      const T* in = ws + (size_t)(l & 1) * slab;
      T* nxt = ws + (size_t)((l + 1) & 1) * slab;
      const bool last = l == L - 1;
      if (!last) {  // F_{l+1}'s carried columns from tile k-1
        const T* q = ov + (size_t)(l + 1) * CHP * R * 2;
        for (int i = tid; i < CHP * R * 2; i += kThreads) {
          const int col = i % 2, r = (i / 2) % R, c = i / (2 * R);
          nxt[(c * R + r) * SC + col] = q[i];
        }
      }
      const int cin = l == 0 ? c0p : CHP;
      const bool relu = (p.relu_mask >> l) & 1;
      const T* bl = bias + l * CHP;

      for (int it = tid; it < nitems; it += kThreads) {
        const int j = it % C;
        const int r0 = (it / C) * kPix;
        float acc[kPix][CHP];
#pragma unroll
        for (int q = 0; q < kPix; ++q)
#pragma unroll
          for (int co = 0; co < CHP; ++co) acc[q][co] = 0.f;

        for (int ci = 0; ci < cin; ++ci) {
          const T* plane = in + (size_t)ci * R * SC;
          float v[kPix + 2][3];
#pragma unroll
          for (int rr = 0; rr < kPix + 2; ++rr) {
            int row = r0 - 1 + rr;
            bool ok = true;
            if (row < 0 || row >= R) {
              if (p.replicate) row = row < 0 ? 0 : R - 1;
              else ok = false;
            }
#pragma unroll
            for (int dx = 0; dx < 3; ++dx)
              v[rr][dx] = ok ? to_f(plane[row * SC + j + dx]) : 0.f;
          }
#pragma unroll
          for (int dy = 0; dy < 3; ++dy)
#pragma unroll
            for (int dx = 0; dx < 3; ++dx) {
              const float4* w4 =
                  reinterpret_cast<const float4*>(wsm + ((dy * 3 + dx) * CHP + ci) * CHP);
#pragma unroll
              for (int g = 0; g < CHP / 4; ++g) {
                const float4 wv = w4[g];
#pragma unroll
                for (int q = 0; q < kPix; ++q) {
                  const float a = v[q + dy][dx];
                  acc[q][4 * g + 0] = fmaf(a, wv.x, acc[q][4 * g + 0]);
                  acc[q][4 * g + 1] = fmaf(a, wv.y, acc[q][4 * g + 1]);
                  acc[q][4 * g + 2] = fmaf(a, wv.z, acc[q][4 * g + 2]);
                  acc[q][4 * g + 3] = fmaf(a, wv.w, acc[q][4 * g + 3]);
                }
              }
            }
        }

        // Epilogue: bias, ReLU, phantom-column and phantom-row masks, round.
        const int acol = k * C - l + j;  // absolute column of this output
        const bool col_ok = acol >= 0 && acol < W;
#pragma unroll
        for (int q = 0; q < kPix; ++q) {
          const int r = r0 + q;
          if (r >= R) continue;
          const bool keep = col_ok && (!mask_rows || (r >= lo && r < hi));
#pragma unroll
          for (int co = 0; co < CHP; ++co) {
            float g = acc[q][co] + to_f(bl[co]);
            if (relu) g = fmaxf(g, 0.f);
            T gt = from_f<T>(keep ? g : 0.f);
            if (!last) {
              nxt[((size_t)co * R + r) * SC + 2 + j] = gt;
            } else {
              if (p.add_anchor && col_ok && co < p.in_ch * p.repeats) {
                const int c = co / p.repeats;
                const T a = acol == 0 ? first[r * c0p + c]
                                      : x[((size_t)r * KC + acol - 1) * c0p + c];
                gt = from_f<T>(to_f(gt) + to_f(a));
              }
              out[((size_t)r * KC + k * C + j) * CHP + co] = gt;
            }
          }
        }
      }
      __syncthreads();
      if (!last) {  // F_{l+1}'s last two columns are tile k+1's carried ones
        T* q = ov + (size_t)(l + 1) * CHP * R * 2;
        for (int i = tid; i < CHP * R * 2; i += kThreads) {
          const int col = i % 2, r = (i / 2) % R, c = i / (2 * R);
          q[i] = nxt[(c * R + r) * SC + C + col];
        }
      }
    }
    // A warm-up tile ends on a queue store that may read slab 0, which the
    // next tile's layer-0 fill overwrites (a full tile ends on a barrier).
    if (nl < L) __syncthreads();
  }
}

using KernelFn = void (*)(Params);

// The <dtype, Chp> instance (dtype 0 = float32, 1 = bfloat16), or null.
// Instances exist for the padded widths something launches: 32 (ABPN x3)
// and 16 (the narrow stack of the card tests).  Add one when a model needs
// it.
KernelFn instance(int dtype, int chp) {
  if (dtype == 0 && chp == 16) return tilted_fusion_kernel<float, 16>;
  if (dtype == 0 && chp == 32) return tilted_fusion_kernel<float, 32>;
  if (dtype == 1 && chp == 16) return tilted_fusion_kernel<__nv_bfloat16, 16>;
  if (dtype == 1 && chp == 32) return tilted_fusion_kernel<__nv_bfloat16, 32>;
  return nullptr;
}

// Dynamic shared memory of a CTA: two fp32 stages of one layer's weights.
int smem_bytes(int chp) { return 2 * 9 * chp * chp * (int)sizeof(float); }

// The <dtype, chp> instance in *k, allowed the shared memory it takes.
cudaError_t prepare(int dtype, int chp, KernelFn* k) {
  *k = instance(dtype, chp);
  if (!*k) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(*k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes(chp));
}

}  // namespace

extern "C" {

// Launch B*S CTAs on `stream` (S segments per band, `warm` warm-up tiles
// for a restarted segment; ws holds B*S workspaces); returns the launch's
// CUDA error code (0 = ok).  dtype: 0 = float32,
// 1 = bfloat16.  Does not synchronise or allocate.
int tilted_fusion_launch(int dtype, const void* x, const void* first, const void* w,
                         const void* bias, const void* bounds, void* out, void* ws,
                         int B, int R, int K, int C, int c0p, int chp, int L, int W,
                         int relu_mask, int add_anchor, int in_ch, int repeats,
                         int replicate, int S, int warm, void* stream) {
  if (B == 0) return 0;
  if (S < 1 || S > K || warm < 0) return (int)cudaErrorInvalidValue;
  Params p;
  p.x = x; p.first = first; p.w = w; p.bias = bias;
  p.bounds = reinterpret_cast<const int*>(bounds);
  p.out = out; p.ws = ws;
  p.R = R; p.K = K; p.C = C; p.c0p = c0p; p.L = L; p.W = W;
  p.S = S; p.warm = warm;
  p.relu_mask = relu_mask; p.add_anchor = add_anchor; p.in_ch = in_ch;
  p.repeats = repeats; p.replicate = replicate;
  KernelFn k;
  cudaError_t e = prepare(dtype, chp, &k);
  if (e != cudaSuccess) return (int)e;
  void* args[] = {&p};
  return (int)cudaLaunchKernel(reinterpret_cast<const void*>(k), dim3(B * S), dim3(kThreads),
                               args, smem_bytes(chp), reinterpret_cast<cudaStream_t>(stream));
}

// Resident CTAs per SM of the <dtype, chp> instance on the current device
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor at 256 threads and its
// shared memory), written to *blocks; returns the CUDA error code.
int tilted_fusion_blocks_per_sm(int dtype, int chp, int* blocks) {
  KernelFn k;
  cudaError_t e = prepare(dtype, chp, &k);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, k, kThreads, smem_bytes(chp));
}

const char* tilted_fusion_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
