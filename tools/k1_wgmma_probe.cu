// The bits of wgmma against mma.sync on the same operands in the same order
// (tools/k1_wgmma_probe.py builds and runs this file on the card).
//
// One warpgroup computes D (64 x 32, fp32) = a chain of S k-steps of A (64 x
// k) B (k x 32) twice: once with mma.sync (each warp its 16 rows, four n8
// blocks: m16n8k8 TF32 or m16n8k16 bf16, as K1's narrow instance runs them)
// and once with wgmma m64n32k8 TF32 / m64n32k16 bf16, A from registers (each
// warp's 16 rows in mma.sync's A fragment layout), B from shared memory
// through a descriptor (the no-swizzle K-major layout of
// src/repro_torch/kernels/csrc/conv3x3.cu's slices).  fp32 is 3xTF32 on both
// sides: A and B split into TF32 hi and lo (cvt.rna.tf32.f32 rounding), each
// k-step summed lo*hi + hi*lo + hi*hi into the accumulator, which starts at
// zero.  Each output element therefore sums the same products in the same
// order (k-step, term); only the units differ.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t tf32_rna(uint32_t bits) { return (bits + 0x1000u) & 0xffffe000u; }
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

// core matrices 128 bytes apart along k, 256 along n; no swizzle
__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3ffff) >> 4) | ((uint64_t)(128 >> 4) << 16) |
         ((uint64_t)(256 >> 4) << 32);
}
__device__ __forceinline__ void wgmma_tf32(float (&d)[16], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b));
}
__device__ __forceinline__ void wgmma_bf16(float (&d)[16], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b));
}
template <int K>
__device__ __forceinline__ void fence_regs(float (&r)[K]) {
#pragma unroll
  for (int i = 0; i < K; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// A (64, S k) and B (S k, 32) as 32-bit words: fp32 bits, or (bf16) pairs of
// bf16 along k.  Shared memory: per k-step and part (fp32: hi, lo; bf16:
// one) a 1 KB block of 4 core matrices x 2 k-halves.
__global__ void __launch_bounds__(128) probe_kernel(const uint32_t* A, const uint32_t* B, float* dw,
                                                    float* dm, int S, int bf16) {
  extern __shared__ uint4 smem_raw[];
  uint32_t* sb = reinterpret_cast<uint32_t*>(smem_raw);
  const int parts = bf16 ? 1 : 2, kw = bf16 ? 8 : 8;  // words of k a row (bf16: pairs)
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, tig = lane & 3;
  // word (s, part, j, h, r, e) = B[k][n], n = 8 j + r; fp32 k = 8 s + 4 h + e,
  // bf16 the pair k = 16 s + 8 h + 2 e
  for (int i = tid; i < S * parts * 256; i += 128) {
    const int e = i & 3, r = (i >> 2) & 7, h = (i >> 5) & 1, j = (i >> 6) & 3;
    const int part = (i >> 8) % parts, s = (i >> 8) / parts;
    const uint32_t v = B[(size_t)(kw * s + 4 * h + e) * 32 + 8 * j + r];
    if (bf16) {
      sb[i] = v;
    } else {
      uint32_t hi, lo;
      tf32_split(v, hi, lo);
      sb[i] = part ? lo : hi;
    }
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  const uint32_t base = (uint32_t)__cvta_generic_to_shared(sb);
  float acc_m[4][4] = {}, acc_w[16] = {};
  const int row = 16 * warp + g, W = S * kw;  // A's words a row
  for (int s = 0; s < S; ++s) {
    uint32_t a[4] = {A[(size_t)row * W + kw * s + tig], A[(size_t)(row + 8) * W + kw * s + tig],
                     A[(size_t)row * W + kw * s + tig + 4],
                     A[(size_t)(row + 8) * W + kw * s + tig + 4]};
    const uint32_t* hb = sb + s * parts * 256;  // B's hi (bf16: only) block of k-step s
    const uint64_t dh = desc(base + 4 * s * parts * 256);
    if (bf16) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        mma_bf16(acc_m[j], a, hb[j * 64 + g * 4 + tig], hb[j * 64 + 32 + g * 4 + tig]);
      fence_regs(acc_w);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
      wgmma_bf16(acc_w, a, dh);
    } else {
      const uint32_t* lb = hb + 256;
      const uint64_t dl = desc(base + 4 * (s * parts * 256 + 256));
      uint32_t ah[4], al[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) tf32_split(a[c], ah[c], al[c]);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int o0 = j * 64 + g * 4 + tig, o1 = o0 + 32;
        mma_tf32(acc_m[j], al, hb[o0], hb[o1]);
        mma_tf32(acc_m[j], ah, lb[o0], lb[o1]);
        mma_tf32(acc_m[j], ah, hb[o0], hb[o1]);
      }
      fence_regs(acc_w);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
      wgmma_tf32(acc_w, al, dh);
      wgmma_tf32(acc_w, ah, dl);
      wgmma_tf32(acc_w, ah, dh);
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_regs(acc_w);
  }
  // accumulator c of n block j: row g + 8 (c >> 1), column 8 j + 2 tig + (c & 1)
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int r = row + 8 * (c >> 1), n = 8 * j + 2 * tig + (c & 1);
      dm[r * 32 + n] = acc_m[j][c];
      dw[r * 32 + n] = acc_w[4 * j + c];
    }
}

}  // namespace

extern "C" int k1_wgmma_probe(const void* A, const void* B, void* dw, void* dm, int S, int bf16) {
  const int smem = S * (bf16 ? 1 : 2) * 1024;
  cudaError_t e = cudaFuncSetAttribute(probe_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       smem);
  if (e != cudaSuccess) return (int)e;
  probe_kernel<<<1, 128, smem>>>(static_cast<const uint32_t*>(A), static_cast<const uint32_t*>(B),
                                 static_cast<float*>(dw), static_cast<float*>(dm), S, bf16);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return (int)cudaDeviceSynchronize();
}
