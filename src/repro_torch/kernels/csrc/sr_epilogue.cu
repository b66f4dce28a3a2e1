// ABPN's residual epilogue on Hopper (sm_90a): anchor add, pixel shuffle,
// clip and cast in one pass over the conv stack's output.
//
// Replaces no TPU kernel.  The JAX package's epilogue
// (src/repro/engine/executor.py::sr_epilogue) is plain jnp, which XLA fuses
// into one pass over the features; eager PyTorch ran the same chain as five
// passes (the anchor's repeat_interleave, the add, the shuffle's layout
// copy, the clamp, the cast), each writing a full-size intermediate and
// reading it back.  This kernel is that chain in one pass.
//
// What it computes, per HR element (the index convention of
// models.abpn.depth_to_space and make_anchor):
//   out[n, y*s + dy, x*s + dx, c] = cast(clip(f[n, y, x, c*s*s + dy*s + dx]
//                                             + lr[n, y, x, c]))
// in the order and precision of the plain chain (kernels/epilogue.py's
// sr_epilogue_plain): the add in fp32 and, in bf16 compute, rounded to bf16
// (round to nearest even), as PyTorch's bf16 add does; then, with clip, a
// clamp to [0, 1] that passes NaN through, as torch.clamp does; then one
// conversion to the output dtype.  The result is bit for bit the chain's.
// Without the anchor (a model that has none, RLFN) the add and the LR
// input go: shuffle, clip and cast alone, a template choice, so that the
// anchored instances keep their code.
//
// What bounds it on this card: bytes.  It does no arithmetic to speak of
// (one add and a clamp an output) against one read of the features, one of
// the LR input and one write of the HR frame: at ABPN x3 in fp32 (features
// at K1's Chp 32, 1080x1920x3 out) 57 MB a frame, 17 us at 3.35 TB/s; at x4
// with bf16 features (Chp 48) and an fp32 frame, 68 MB, 20 us.
//
// The design, for bytes:
//   * a block owns `cols` LR pixels of one LR row of one frame (a chunk;
//     the grid is frames x rows x chunks, 1,800 blocks for one 360x640
//     frame at 128 columns, so one frame already fills the 132 SMs);
//   * the chunk's features are read once, as one contiguous span of 16-byte
//     loads where the channels are contiguous (K1's output: each pixel's
//     record of Chp channels, the last pixel cut at its last channel read),
//     the loads of a thread issued together before any is used; any other
//     layout is read element by element (the same arithmetic);
//   * each value goes, through a per-channel table of offsets, to its place
//     in the chunk's s HR rows staged in shared memory, each row laid out
//     with the same alignment to 16 bytes as its place in the output;
//   * the s rows (s * cols * s * c contiguous elements each) are written
//     with 16-byte stores, only a row's ragged ends element by element.
// The kernel allocates nothing; scale and channels are run-time values.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVecBytes = 16;
constexpr int kLoads = 4;           // 16-byte feature loads a thread keeps in flight
constexpr int kMaxCols = 128;       // LR columns a block at most
constexpr int kSmemLimit = 48 * 1024;  // a block's shared memory, below the opt-in size

struct Params {
  const void* f;          // features (N, H, W, c*s*s) through fs
  const void* x;          // LR input (N, H, W, c) through xs, the compute dtype
  void* out;              // HR (N, H*s, W*s, c), contiguous
  long long fs[4];        // feature strides in elements: frame, row, pixel, channel
  long long xs[4];        // LR strides in elements
  int h, w, c, s, cf;     // LR rows and columns, channels, scale, c*s*s
  int clip;
  int cols, chunks;       // LR columns a block, chunks a row
  int span;               // 1: the features' channels are contiguous, read as a span
  int row_cap;            // elements of one staged HR row (a multiple of 16 bytes)
};

template <typename T> __device__ __forceinline__ float widen(T v);
template <> __device__ __forceinline__ float widen<float>(float v) { return v; }
template <> __device__ __forceinline__ float widen<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// the add's result as the compute dtype holds it
template <typename T> __device__ __forceinline__ float round_to(float v);
template <> __device__ __forceinline__ float round_to<float>(float v) { return v; }
template <> __device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <typename T> __device__ __forceinline__ T narrow(float v);
template <> __device__ __forceinline__ float narrow<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <> __device__ __forceinline__ __half narrow<__half>(float v) { return __float2half_rn(v); }

template <typename TC, typename TO, bool ANCHOR>
__device__ __forceinline__ TO finish(const Params& p, TC f, float lr) {
  float v = ANCHOR ? round_to<TC>(widen<TC>(f) + lr) : widen<TC>(f);
  if (p.clip && !isnan(v)) v = fminf(fmaxf(v, 0.0f), 1.0f);
  return narrow<TO>(v);
}

template <typename TC, typename TO, bool ANCHOR>
__global__ void __launch_bounds__(kThreads) sr_epilogue_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int VO = kVecBytes / sizeof(TO);
  constexpr int VI = kVecBytes / sizeof(TC);
  const int s = p.s, c = p.c, cf = p.cf, sc = s * c;
  TO* hr = reinterpret_cast<TO*>(smem);                              // s rows of row_cap
  float* lr = reinterpret_cast<float*>(smem + (size_t)s * p.row_cap * sizeof(TO));  // cols * c
  int* dst = reinterpret_cast<int*>(lr + p.cols * c);                // cf: a channel's HR place
  int* chan = dst + cf;                                              // cf: its LR channel

  const int chunk = blockIdx.x % p.chunks;
  const int row = blockIdx.x / p.chunks;  // n * h + y
  const int y = row % p.h;
  const long long n = row / p.h;
  const int px0 = chunk * p.cols;
  const int wc = min(p.cols, p.w - px0);
  const long long hr_row = (long long)p.w * sc;  // elements of one HR row
  // the first HR element of this chunk's row dy is g0 + dy * hr_row
  const long long g0 = (n * p.h * s + (long long)y * s) * hr_row + (long long)px0 * sc;

  for (int k = threadIdx.x; k < cf; k += kThreads) {
    const int cc = k / (s * s), r = k - cc * s * s, dy = r / s, dx = r - dy * s;
    const int lead = (int)((g0 + dy * hr_row) % VO);  // the row's offset from 16 bytes
    dst[k] = dy * p.row_cap + lead + dx * c + cc;
    chan[k] = cc;
  }
  if constexpr (ANCHOR) {
    const TC* xg = static_cast<const TC*>(p.x) + n * p.xs[0] + (long long)y * p.xs[1];
    for (int i = threadIdx.x; i < wc * c; i += kThreads) {
      const int px = i / c, cc = i - px * c;
      lr[i] = widen<TC>(xg[(long long)(px0 + px) * p.xs[2] + (long long)cc * p.xs[3]]);
    }
  }
  __syncthreads();

  const TC* fg = static_cast<const TC*>(p.f) + n * p.fs[0] + (long long)y * p.fs[1] +
                 (long long)px0 * p.fs[2];
  if (p.span) {
    // the span [0, len) of elements from fg, pixel stride ps, channel stride 1
    const int ps = (int)p.fs[2];
    const int len = (wc - 1) * ps + cf;
    const int lead = (int)((reinterpret_cast<uintptr_t>(fg) % kVecBytes) / sizeof(TC));
    const TC* base = fg - lead;  // 16-byte aligned
    const int nq = (lead + len + VI - 1) / VI;
    for (int q0 = 0; q0 < nq; q0 += kThreads * kLoads) {
      uint4 v[kLoads];
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int q = q0 + u * kThreads + threadIdx.x;
        const int j0 = q * VI - lead;
        if (q < nq && j0 >= 0 && j0 + VI <= len) {
          v[u] = __ldg(reinterpret_cast<const uint4*>(base) + q);
        } else if (q < nq) {  // a ragged end of the span
          TC* e = reinterpret_cast<TC*>(&v[u]);
#pragma unroll
          for (int i = 0; i < VI; ++i)
            if (j0 + i >= 0 && j0 + i < len) e[i] = base[q * VI + i];
        }
      }
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int q = q0 + u * kThreads + threadIdx.x;
        if (q >= nq) continue;
        const TC* e = reinterpret_cast<const TC*>(&v[u]);
        int j = q * VI - lead;
        int px = j >= 0 ? j / ps : -1;
        int k = j - px * ps;
#pragma unroll
        for (int i = 0; i < VI; ++i, ++j, ++k) {
          if (k == ps) { k = 0; ++px; }
          if (j >= 0 && j < len && k < cf)
            hr[dst[k] + px * sc] =
                finish<TC, TO, ANCHOR>(p, e[i], ANCHOR ? lr[px * c + chan[k]] : 0.f);
        }
      }
    }
  } else {
    for (int i = threadIdx.x; i < wc * cf; i += kThreads) {
      const int px = i / cf, k = i - px * cf;
      const TC f = fg[(long long)px * p.fs[2] + (long long)k * p.fs[3]];
      hr[dst[k] + px * sc] = finish<TC, TO, ANCHOR>(p, f, ANCHOR ? lr[px * c + chan[k]] : 0.f);
    }
  }
  __syncthreads();

  // the s staged rows, 16 bytes a store; a row's vector q covers its
  // elements [q * VO - lead, (q + 1) * VO - lead)
  TO* out = static_cast<TO*>(p.out);
  const int len = wc * sc;
  const int nq = (len + 2 * VO - 2) / VO;  // vectors a row, at any lead
  for (int i = threadIdx.x; i < s * nq; i += kThreads) {
    const int dy = i / nq, q = i - dy * nq;
    const long long g = g0 + dy * hr_row;
    const int lead = (int)(g % VO);
    const int j0 = q * VO - lead;
    const TO* src = hr + dy * p.row_cap + q * VO;
    TO* to = out + (g - lead) + (long long)q * VO;
    if (j0 >= 0 && j0 + VO <= len) {
      *reinterpret_cast<uint4*>(to) = *reinterpret_cast<const uint4*>(src);
    } else {
#pragma unroll
      for (int e = 0; e < VO; ++e)
        if (j0 + e >= 0 && j0 + e < len) to[e] = src[e];
    }
  }
}

// Shared memory of a block of `cols` LR columns: its s HR rows (each with
// room for its lead and rounded up to 16 bytes), the LR values and the two
// channel tables.
long long smem_bytes(int cols, int c, int s, int out_bytes, int* row_cap) {
  const int vo = kVecBytes / out_bytes;
  *row_cap = (cols * s * c + 2 * vo - 2) / vo * vo;
  return (long long)s * *row_cap * out_bytes + 4LL * cols * c + 8LL * c * s * s;
}

template <typename TC, typename TO>
cudaError_t launch(const Params& p, bool anchor, long long blocks, long long smem,
                   cudaStream_t stream) {
  if (anchor)
    sr_epilogue_kernel<TC, TO, true><<<(unsigned)blocks, kThreads, (size_t)smem, stream>>>(p);
  else
    sr_epilogue_kernel<TC, TO, false><<<(unsigned)blocks, kThreads, (size_t)smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch the epilogue on `stream`; returns the launch's CUDA error code
// (0 = ok).  compute: 0 = float32, 1 = bfloat16 (features and LR input);
// out: 0 = float32, 1 = bfloat16, 2 = float16.  strides: the features'
// four then the LR input's four, in elements.  `out` is a contiguous
// (n, h*s, w*s, c) tensor, 16-byte aligned.  anchor 0: x and its strides
// are not read.  Does not synchronise or allocate.
int sr_epilogue_launch(int compute, int out_dtype, const void* f, const void* x, void* out,
                       const long long* strides, int n, int h, int w, int c, int s, int clip,
                       int anchor, void* stream) {
  if (n <= 0 || h <= 0 || w <= 0) return 0;
  if (c < 1 || s < 1 || compute < 0 || compute > 1 || out_dtype < 0 || out_dtype > 2 ||
      reinterpret_cast<uintptr_t>(out) % kVecBytes != 0)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.f = f; p.x = x; p.out = out;
  for (int i = 0; i < 4; ++i) { p.fs[i] = strides[i]; p.xs[i] = strides[4 + i]; }
  p.h = h; p.w = w; p.c = c; p.s = s; p.cf = c * s * s; p.clip = clip;
  const bool a = anchor != 0;
  // the widest block, at most kMaxCols, whose shared memory fits kSmemLimit
  const int out_bytes = out_dtype == 0 ? 4 : 2;
  p.cols = w < kMaxCols ? w : kMaxCols;
  long long smem = smem_bytes(p.cols, c, s, out_bytes, &p.row_cap);
  while (smem > kSmemLimit && p.cols > 1) smem = smem_bytes(--p.cols, c, s, out_bytes, &p.row_cap);
  if (smem > kSmemLimit) return (int)cudaErrorInvalidValue;
  p.chunks = (w + p.cols - 1) / p.cols;
  // a contiguous span: channel stride 1, records that do not overlap and
  // are at most twice the channels read (else the padding costs more
  // bytes than reading element by element)
  p.span = p.fs[3] == 1 && p.fs[2] >= p.cf && p.fs[2] <= 2LL * p.cf;
  const long long blocks = (long long)n * h * p.chunks;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (compute == 0) {
    if (out_dtype == 0) return (int)launch<float, float>(p, a, blocks, smem, st);
    if (out_dtype == 1) return (int)launch<float, __nv_bfloat16>(p, a, blocks, smem, st);
    return (int)launch<float, __half>(p, a, blocks, smem, st);
  }
  if (out_dtype == 0) return (int)launch<__nv_bfloat16, float>(p, a, blocks, smem, st);
  if (out_dtype == 1) return (int)launch<__nv_bfloat16, __nv_bfloat16>(p, a, blocks, smem, st);
  return (int)launch<__nv_bfloat16, __half>(p, a, blocks, smem, st);
}

const char* sr_epilogue_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
