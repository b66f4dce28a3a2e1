// The on-chip route of K1's narrow instances on wgmma: the text that
// tools/k1_ablation.py's `wgmma` variant inserts into
// src/repro_torch/kernels/csrc/tilted_fusion.cu above its wide instances
// (with narrow_instance and launch_pack edited to launch it and pack its
// tap slices).  The same maps and the same arithmetic as the mma.sync
// route, bit for bit (tools/k1_wgmma_probe.py): the m64 blocks of a tile
// split between two warpgroups, A from registers, B's tap slices through a
// ring of bulk copies on mbarriers.  It lost to mma.sync on an H100 (see
// PERF.md), so the kernel does not carry it.  Not a translation unit.

// ---------------------------------------------------------------------------
// The on-chip route on wgmma
// ---------------------------------------------------------------------------
// wgmma m64nNk8 TF32 / m64nNk16 bf16 (N = 16 or 32, a step's outputs) with
// A from registers (a warp's 16 rows, laid out as mma.sync's A fragment) and
// B from shared memory through a descriptor: D = A B + D, or D = A B where
// `accumulate` is 0.  On the same operands in the same order they give
// mma.sync's bits (tools/k1_wgmma_probe.py, 0 of 131,072 elements differ on
// an H100).
template <typename T, int N> struct Wg;
template <> struct Wg<float, 32> {
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
template <> struct Wg<float, 16> {
  static __device__ __forceinline__ void mma(float (&d)[8], const uint32_t (&a)[4], uint64_t b,
                                             int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
  }
};
template <> struct Wg<__nv_bfloat16, 32> {
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
template <> struct Wg<__nv_bfloat16, 16> {
  static __device__ __forceinline__ void mma(float (&d)[8], const uint32_t (&a)[4], uint64_t b,
                                             int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
  }
};

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving reads or writes of r across a wgmma fence
// or wait, and keeps registers an in-flight wgmma reads alive until then
template <int A, int B> __device__ __forceinline__ void fence_regs(float (&r)[A][B]) {
#pragma unroll
  for (int i = 0; i < A; ++i)
#pragma unroll
    for (int j = 0; j < B; ++j) asm volatile("" : "+f"(r[i][j])::"memory");
}
template <int A, int B> __device__ __forceinline__ void keep_regs(uint32_t (&r)[A][B]) {
#pragma unroll
  for (int i = 0; i < A; ++i)
#pragma unroll
    for (int j = 0; j < B; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// A wgmma descriptor of a no-swizzle K-major B at shared address `addr`:
// core matrices of 8 outputs x 16 bytes of k, 128 bytes apart along k (the
// leading offset) and 256 along n (the stride offset).
__device__ __forceinline__ uint64_t core_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3ffff) >> 4) | ((uint64_t)(128 >> 4) << 16) |
         ((uint64_t)(256 >> 4) << 32);
}

// The wgmma route's packed weights: per step i (as the stages: layers
// 0..L-2, then the last layer's output groups of ng = 32, or 16) its bias as
// fp32 (ng words), then 9 tap slices.  A tap's slice holds, for each k-step
// s and part u (fp32: 0 the TF32 hi words, 1 the lo words; bf16: one part),
// ng / 8 core matrices of 8 outputs x 16 bytes of k for each k-half h: the
// core matrix of outputs n0 + 8j .. + 7 at ((s * parts + u) * ng / 8 + j) *
// 256 + 128 h, row r (output n0 + 8j + r) at 16 r, its word e B[8s + 4h +
// e] (fp32) or the pair B[16s + 8h + 2e], B[16s + 8h + 2e + 1] (bf16).
template <typename T>
__host__ __device__ inline int core_slice_bytes(int ng, int ks) {
  return ks * (sizeof(T) == 4 ? 2 : 1) * ng * 32;
}
template <typename T>
__host__ __device__ inline int core_step_bytes(int ng, int ks) {
  return 4 * ng + 9 * core_slice_bytes<T>(ng, ks);
}
// Step i's outputs and k-steps (as step_stage_words), and its first byte.
template <typename T, int CHP>
__host__ __device__ inline void core_step(int i, int L, int ks0, int out_ch, int& ng, int& ks) {
  const int l = i < L - 1 ? i : L - 1;
  ng = i < L - 1 ? CHP : group_width(out_ch, i - l);
  ks = l == 0 ? ks0 : Cfg<T, CHP>::kKS;
}
template <typename T, int CHP>
__host__ __device__ inline size_t core_step_offset(int i, int L, int ks0, int out_ch) {
  size_t off = 0;
  for (int j = 0; j < i; ++j) {
    int ng, ks;
    core_step<T, CHP>(j, L, ks0, out_ch, ng, ks);
    off += core_step_bytes<T>(ng, ks);
  }
  return off;
}
template <typename T, int CHP>
__host__ __device__ inline size_t core_packed_bytes(int L, int ks0, int out_ch) {
  return core_step_offset<T, CHP>(L - 1 + out_groups(out_ch), L, ks0, out_ch);
}

template <typename T, int CHP>
__global__ void pack_core_kernel(const T* __restrict__ w, const T* __restrict__ bias,
                                 uint32_t* __restrict__ packed, int L, int ks0, int out_ch) {
  const int steps = L - 1 + out_groups(out_ch);
  const size_t total = core_packed_bytes<T, CHP>(L, ks0, out_ch) / 4;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    int step = 0;
    while (step + 1 < steps && core_step_offset<T, CHP>(step + 1, L, ks0, out_ch) / 4 <= i)
      ++step;
    int ng, ks;
    core_step<T, CHP>(step, L, ks0, out_ch, ng, ks);
    const int l = step < L - 1 ? step : L - 1, n0 = kGroup * (step - l);
    const int o = (int)(i - core_step_offset<T, CHP>(step, L, ks0, out_ch) / 4);
    uint32_t v;
    if (o < ng) {
      v = __float_as_uint(to_f(bias[l * out_ch + n0 + o]));
    } else {
      const int word = o - ng, slice = core_slice_bytes<T>(ng, ks) / 4;
      const int t = word / slice, u = word % slice;
      const int e = u & 3, r = (u >> 2) & 7, h = (u >> 5) & 1, j = (u >> 6) % (ng / 8);
      const int sp = (u >> 6) / (ng / 8);  // k-step, part
      const T* wt = w + ((size_t)l * 9 + t) * out_ch * out_ch;  // (out_ch, out_ch) of tap t
      const int n = n0 + 8 * j + r;
      if constexpr (sizeof(T) == 4) {
        const int part = sp & 1, s = sp >> 1;
        uint32_t hi, lo;
        tf32_split(__float_as_uint(to_f(wt[(8 * s + 4 * h + e) * out_ch + n])), hi, lo);
        v = part ? lo : hi;
      } else {
        const int k = 16 * sp + 8 * h + 2 * e;
        const uint16_t* wb = reinterpret_cast<const uint16_t*>(wt);
        v = (uint32_t)wb[k * out_ch + n] | ((uint32_t)wb[(k + 1) * out_ch + n] << 16);
      }
    }
    packed[i] = v;
  }
}

constexpr int kWgBlocks = 5;   // m64 blocks a warpgroup holds at once, at most
// The m64 blocks a warpgroup holds for a tile of nmb blocks (a chunk: 2 NB
// a CTA): 2, 4 or 5, the least that covers the tile in one chunk (ABPN's
// 60-row bands at tile 8: 8 blocks, 4; its 74-row slabs: 10, 5), else 5 in
// chunks.  Every wgmma of a chunk is issued by the whole warpgroup, none
// under a branch (ptxas serializes wgmmas on divergent paths), so a block
// past the tile costs its MMAs: a kernel a value of NB.
__host__ __device__ inline int wg_nb(int nmb) {
  const int half = (nmb + 1) / 2;
  return half <= 2 ? 2 : half <= 4 ? 4 : 5;
}
constexpr int kWgSlots = 9;    // tap slices the ring holds, at most
// Slices the producer keeps copied past the last one released: half the
// ring, so that refilling a slot rarely waits for a warp that lags behind.
__host__ __device__ inline int wg_ahead(int slots) { return slots / 2 > 1 ? slots / 2 : 1; }

// The wgmma route's shared memory (tilted_fusion.py::onchip_shared_bytes):
// the two maps, `slots` tap slices of the widest step, 16 zero bytes and a
// full and an empty mbarrier a slot.
template <typename T, int CHP>
__host__ __device__ inline int wg_slice_max() {
  return core_slice_bytes<T>(CHP, Cfg<T, CHP>::kKS);
}
template <typename T, int CHP>
__host__ __device__ inline int wg_smem(int R, int C, int slots) {
  return 2 * onchip_map_bytes<T, CHP>(R, C) + slots * wg_slice_max<T, CHP>() + 16 + 16 * slots;
}
// Slots of the ring for R x C tiles: as many as fit one CTA's shared memory
// (at most kWgSlots), or 0 where fewer than two fit: the device-memory route.
template <typename T, int CHP>
__host__ __device__ inline int wg_slots(int R, int C) {
  if (R < 1 || R > 1024) return 0;
  const int room = 232448 - 2 * onchip_map_bytes<T, CHP>(R, C) - 16;
  const int n = room / (wg_slice_max<T, CHP>() + 16);
  return n < 2 ? 0 : n < kWgSlots ? n : kWgSlots;
}

// The order the slices of a CTA's sweep are used in: per tile, per step,
// per chunk of m64 blocks, 9 taps.  The producer (thread 0) walks it ahead
// of the MMAs and copies each slice into its slot of the ring.
struct SliceWalk {
  int k, i, c, t;  // tile, step, chunk, tap
  int k0, k1, nchunk;
  int issued;      // slices copied
  __device__ __forceinline__ void next(const Params& p, bool mixed) {
    if (++t < 9) return;
    t = 0;
    if (++c < nchunk) return;
    c = 0;
    if (++i < tile_steps(p, k >= k0, mixed)) return;
    i = 0;
    ++k;
  }
  // copy the next slice of the walk into its slot, once the slice that
  // held the slot before it is released; false past the sweep's end
  template <typename T, int CHP, bool MIXED>
  __device__ __forceinline__ bool issue(const Params& p, char* ring, uint32_t bar_full,
                                        uint32_t bar_empty, int slots) {
    if (k >= k1) return false;
    const int s = issued % slots;
    if (issued >= slots) mbar_wait(bar_empty + 8 * s, ((issued - slots) / slots) & 1);
    const int out_ch = MIXED ? p.out_ch : CHP;
    int ng, ks;
    core_step<T, CHP>(i, p.L, p.ks0, out_ch, ng, ks);
    const char* src = static_cast<const char*>(p.ws) +
                      core_step_offset<T, CHP>(i, p.L, p.ks0, out_ch) + 4 * ng +
                      (size_t)t * core_slice_bytes<T>(ng, ks);
    bulk_copy(smem_addr(ring + s * wg_slice_max<T, CHP>()), src, core_slice_bytes<T>(ng, ks),
              bar_full + 8 * s);
    ++issued;
    next(p, MIXED);
    return true;
  }
};

// One chunk of a step on the wgmma route: this warpgroup's m64 blocks
// mb = 2 NB c + wg + 2 b (b < NB; nb of them in the tile) over NG outputs,
// 9 taps of st.ks
// k-steps (walked in pairs, so that the A registers of a k-step's parity
// are known when compiling), each tap's slice from the ring; then the epilogue of each
// warp's fragments.  fp32 sums into the accumulator, 3xTF32 (A split at use,
// B's hi and lo words from the slice), k-step by k-step, so that one group
// of wgmmas is in flight while the next k-step's A fragments load; bf16 sums
// a tap's k-steps into a partial from zero and adds it to the accumulator in
// fp32 once the tap's wgmmas are done, as the plain version adds its nine
// products.  A slice's slot is released (its empty mbarrier) once the
// wgmmas that read it are done, and thread 0 then copies the slice kWgSlots
// - 1 ahead into the slot released before.
template <typename T, int CHP, bool MIXED, int NG, int NB>
__device__ __forceinline__ void wg_chunk(const Params& p, const Step& st, int c, int nb,
                                         const char* src, uint32_t zero, char* ring,
                                         uint32_t bar_full, uint32_t bar_empty, int slots, int& q,
                                         SliceWalk& walk, const float* bsh, char* nxt, T* qout,
                                         T* out, const T* x, const T* first) {
  constexpr bool kF32 = sizeof(T) == 4;
  constexpr int kParts = kF32 ? 2 : 1;
  constexpr int kD = NG / 2;  // accumulator registers of an m64 block
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, wg = warp >> 2, w4 = warp & 3;
  const int C = p.C, SC = C + 2, R = p.R;
  const uint32_t src_addr = smem_addr(src);
  const int khalf = lane >> 4, ks = st.ks;
  // this lane's ldmatrix row per block: the pixel, and per dy the source
  // pixel of tap (dy, 0) (-1: zeros)
  int rowpix[NB][3];
#pragma unroll
  for (int b = 0; b < NB; ++b) {
    int px = 64 * (2 * NB * c + wg + 2 * b) + 16 * w4 + (lane & 7) +
             8 * ((lane >> 3) & 1);
    px = px < st.npix ? px : st.npix - 1;
    const int r = px / C, j = px - r * C;
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
      int rr = r + dy - 1;
      const bool out_of_band = rr < 0 || rr >= R;
      if (p.replicate) rr = rr < 0 ? 0 : rr >= R ? R - 1 : rr;
      rowpix[b][dy] = out_of_band && !p.replicate ? -1 : rr * SC + j;
    }
  }
  float acc[NB][kD];
  float part[kF32 ? 1 : NB][kF32 ? 1 : kD];  // bf16: a tap's partial sums
#pragma unroll
  for (int b = 0; b < NB; ++b)
#pragma unroll
    for (int v = 0; v < kD; ++v) acc[b][v] = 0.f;
  // A by k-step parity within a tap (fp32: TF32 hi and lo; bf16: ah alone):
  // a wgmma reads its registers until the wait that follows the next
  // k-step's commit
  uint32_t ah[2][NB][4], al[kF32 ? 2 : 1][kF32 ? NB : 1][4];
  // release the slot of slice qq (this warp's wgmmas that read it are done)
  // and copy the slices up to wg_ahead(slots) past it (each into the slot of
  // a slice slots back, which the other warps are unlikely still to read)
  auto release = [&](int qq) {
    __syncwarp();
    if (lane == 0) mbar_arrive(bar_empty + 8 * (qq % slots));
    if (tid == 0)
      while (walk.issued <= qq + wg_ahead(slots) &&
             walk.issue<T, CHP, MIXED>(p, ring, bar_full, bar_empty, slots)) {
      }
    __syncwarp();  // warp 0 reconverges before its next wgmma
  };
#pragma unroll 1
  for (int t = 0; t < 9; ++t, ++q) {
    const int slot = q % slots;
    const uint32_t slice = smem_addr(ring + slot * wg_slice_max<T, CHP>());
    const int dy = t / 3, dx = t % 3;
    if (!kF32 && t > 0) {  // bf16: the last tap's partial is done, its slice free
      wgmma_wait<0>();
      keep_regs(ah[0]);
      keep_regs(ah[1]);
      fence_regs(acc);
      fence_regs(part);
#pragma unroll
      for (int b = 0; b < NB; ++b)
#pragma unroll
        for (int v = 0; v < kD; ++v) acc[b][v] += part[b][v];
      release(q - 1);
    }
    if (tid == 0)  // this slice copied (where the ring is short, not yet)
      while (walk.issued <= q && walk.issue<T, CHP, MIXED>(p, ring, bar_full, bar_empty, slots)) {
      }
    __syncwarp();
    mbar_wait(bar_full + 8 * slot, (q / slots) & 1);
    // each block's source pixel of this tap (-1: zeros), selected, not
    // indexed (dy is not known when compiling)
    int tap_pix[NB];
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      const int rp = dy == 0 ? rowpix[b][0] : dy == 1 ? rowpix[b][1] : rowpix[b][2];
      tap_pix[b] = rp < 0 ? -1 : rp + dx;
    }
    // k-step s into the A registers of parity buf (= s & 1)
    auto kstep = [&](int s, auto buf_c) {
      constexpr int buf = decltype(buf_c)::value;
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        const int rp = tap_pix[b];
        uint32_t a[4];
        ldmatrix_x4(a, rp < 0 ? zero : src_addr + win_off<T, CHP>(rp, 2 * s + khalf));
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          if constexpr (kF32) tf32_split(a[v], ah[buf][b][v], al[buf][b][v]);
          else ah[buf][b][v] = a[v];
        }
      }
      // the descriptors before the fence: no register a wgmma reads is
      // written between the fence and the wgmma (ptxas serializes them else)
      const uint32_t bs = slice + s * kParts * NG * 32;
      const uint64_t dh = core_desc(bs), dl = core_desc(bs + NG * 32);
      fence_regs(acc);
      if constexpr (!kF32) fence_regs(part);
      wgmma_fence();
      // term by term over the blocks, so that back-to-back wgmmas write
      // different accumulators; every element still sums lo*hi, hi*lo,
      // hi*hi in that order
      if constexpr (kF32) {
#pragma unroll
        for (int b = 0; b < NB; ++b) Wg<T, NG>::mma(acc[b], al[buf][b], dh, 1);  // lo * hi
#pragma unroll
        for (int b = 0; b < NB; ++b) Wg<T, NG>::mma(acc[b], ah[buf][b], dl, 1);  // hi * lo
#pragma unroll
        for (int b = 0; b < NB; ++b) Wg<T, NG>::mma(acc[b], ah[buf][b], dh, 1);  // hi * hi
      } else {
        const int accumulate = s > 0;
#pragma unroll
        for (int b = 0; b < NB; ++b) Wg<T, NG>::mma(part[b], ah[buf][b], dh, accumulate);
      }
      wgmma_commit();
      wgmma_wait<1>();  // k-step s - 1's wgmmas are done: its A registers are free
      keep_regs(ah[buf ^ 1]);
      if constexpr (kF32) {
        keep_regs(al[buf ^ 1]);
        // fp32: the last tap's wgmmas are done once this tap's first group
        // is the only one in flight: its slice is free
        if (s == 0 && t > 0) release(q - 1);
      }
    };
#pragma unroll 1
    for (int s = 0; s < ks; s += 2) {
      kstep(s, std::integral_constant<int, 0>());
      if (s + 1 < ks) kstep(s + 1, std::integral_constant<int, 1>());
    }
  }
  wgmma_wait<0>();
  keep_regs(ah[0]);
  keep_regs(ah[1]);
  if constexpr (kF32) {
    keep_regs(al[0]);
    keep_regs(al[1]);
  }
  fence_regs(acc);
  if constexpr (!kF32) {
    fence_regs(part);
#pragma unroll
    for (int b = 0; b < NB; ++b)
#pragma unroll
      for (int v = 0; v < kD; ++v) acc[b][v] += part[b][v];
  }
  release(q - 1);
  // the epilogue: block b's accumulator d[4 jb + c] is mma.sync's acc[jb][c]
  // of fragment 4 mb + w4
#pragma unroll
  for (int b = 0; b < NB; ++b) {
    if (b >= nb) break;
    float f[NG / 8][4];
#pragma unroll
    for (int jb = 0; jb < NG / 8; ++jb)
#pragma unroll
      for (int v = 0; v < 4; ++v) f[jb][v] = acc[b][4 * jb + v];
    store_fragment<T, CHP, MIXED, true, NG>(p, st, f,
                                             64 * (2 * NB * c + wg + 2 * b) + 16 * w4,
                                             bsh, nxt, qout, out, x, first);
  }
}

// The on-chip route on wgmma: the maps of tilted_fusion_kernel_onchip, the
// tap slices of a step through a ring of `slots` (wg_slots) in shared
// memory, each filled by one bulk copy on its full mbarrier and freed on its
// empty one (8 arrivals, a warp each) once the wgmmas that read it are done;
// thread 0 keeps slots - 1 slices in flight.  Two warpgroups each take m64
// blocks of 64 pixels (4 fragments, a warp's rows as mma.sync's), in chunks
// of NB a warpgroup (wg_nb); a step with more blocks walks its taps again
// (R > 80 rows at tile 8: bf16 only).  A step ends
// with a CTA barrier, as on the mma.sync route; F_0 and the carried columns
// move as there.
template <typename T, int CHP, bool MIXED, int NB>
__global__ void __launch_bounds__(kThreads, 1) tilted_fusion_wgmma_kernel(Params p) {
  using G = Cfg<T, CHP>;
  extern __shared__ uint4 smem[];
  char* sm = reinterpret_cast<char*>(smem);
  const int mapb = onchip_map_bytes<T, CHP>(p.R, p.C);
  const int slots = wg_slots<T, CHP>(p.R, p.C);
  char* maps[2] = {sm, sm + mapb};
  char* ring = sm + 2 * mapb;  // slots x wg_slice_max
  char* tail = ring + slots * wg_slice_max<T, CHP>();
  const uint32_t zero = smem_addr(tail);    // 16 zero bytes
  const uint32_t bar_full = smem_addr(tail + 16);
  const uint32_t bar_empty = bar_full + 8 * slots;

  const int cta = blockIdx.x;  // band * S + segment
  const int band = cta / p.S, seg = cta % p.S;
  const int tid = threadIdx.x;
  const int R = p.R, K = p.K, C = p.C, L = p.L;
  const int KC = K * C;
  const int k0 = (int)((long long)seg * K / p.S);
  const int k1 = (int)((long long)(seg + 1) * K / p.S);
  const int kw = k0 >= p.warm ? k0 - p.warm : 0;
  const int out_ch = MIXED ? p.out_ch : CHP;

  T* queue = reinterpret_cast<T*>(static_cast<char*>(p.ws) +
                                  core_packed_bytes<T, CHP>(L, p.ks0, out_ch)) +
             (size_t)cta * onchip_workspace_elems(CHP, R, L);  // (2, L-1, R, 2, CHP)
  const size_t qslot = (size_t)R * 2 * CHP, qpar = queue_slot_elems(CHP, R, L);
  const T* x = static_cast<const T*>(p.x) + (size_t)band * R * KC * p.c0p;
  const T* first = static_cast<const T*>(p.first) + (size_t)band * R * p.c0p;
  T* out = static_cast<T*>(p.out) + (size_t)band * R * KC * out_ch;
  const char* xc = reinterpret_cast<const char*>(x);
  const char* fc = reinterpret_cast<const char*>(first);

  Step st;
  st.mask_rows = p.bounds != nullptr;
  st.lo = st.mask_rows ? p.bounds[2 * band] : 0;
  st.hi = st.mask_rows ? p.bounds[2 * band + 1] : R;
  st.n0 = 0;
  st.r0 = 0;
  st.p0 = 0;
  st.npix = R * C;
  const int wg = (tid >> 5) >> 2;

  if (tid == 0) {
    *reinterpret_cast<uint4*>(tail) = make_uint4(0, 0, 0, 0);
    for (int s = 0; s < slots; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, kWarps);
    }
    mbar_init_fence();
  }
  __syncthreads();
  // the producer's walk over the sweep's slices (thread 0), and the first
  // slots - 1 of them
  const int nmb = (R * C + 63) / 64;  // m64 blocks of a tile
  const int nchunk = (nmb + 2 * NB - 1) / (2 * NB);
  SliceWalk walk{kw, 0, 0, 0, k0, k1, nchunk, 0};
  if (tid == 0)
    while (walk.issued <= wg_ahead(slots) &&
           walk.issue<T, CHP, MIXED>(p, ring, bar_full, bar_empty, slots)) {
    }

  const FastDiv sc(C + 2);
  bool f0_ready = false;  // F_0 of tile k was copied during tile k - 1
  int base = 0;           // the sweep's layer steps before tile k
  int q = 0;              // slices used
  for (int k = kw; k < k1; ++k) {
    const bool own = k >= k0;
    const int nl = own ? L : L - 1;  // layers this tile runs
    const int ns = tile_steps(p, own, MIXED);
    for (int i = 0; i < ns; ++i) {
      const int l = MIXED && i > L - 1 ? L - 1 : i;
      // the last step's maps and queue columns, and the copies it waited
      // for, are visible
      __syncthreads();
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
      const float* bsh = reinterpret_cast<const float*>(
          static_cast<const char*>(p.ws) + core_step_offset<T, CHP>(i, L, p.ks0, out_ch));
      for (int c = 0; c < nchunk; ++c) {
        // this warpgroup's blocks in the tile in chunk c: 2 NB c + wg + 2 b < nmb
        const int left = nmb - 2 * NB * c - wg;
        const int nb = left <= 0 ? 0 : (left + 1) / 2 < NB ? (left + 1) / 2 : NB;
        if constexpr (MIXED) {  // a last group of 16 outputs
          if (st.last && group_width(p.out_ch, i - l) < CHP) {
            wg_chunk<T, CHP, MIXED, 16, NB>(p, st, c, nb, src, zero, ring, bar_full, bar_empty, slots,
                                        q, walk, bsh, nxt, qout, out, x, first);
            continue;
          }
        }
        wg_chunk<T, CHP, MIXED, CHP, NB>(p, st, c, nb, src, zero, ring, bar_full, bar_empty, slots, q,
                                     walk, bsh, nxt, qout, out, x, first);
      }
      cp_async_wait<0>();  // this step's copies landed (the next barrier publishes them)
    }
    base += nl;
  }
}

