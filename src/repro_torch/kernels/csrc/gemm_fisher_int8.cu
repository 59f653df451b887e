// INT8 backward GEMM with the Fisher epilogue for Hopper (sm_90a):
//
//   acc[m, k]  = sum_n a_q[n, m] * g_q[n, k]        exact, int32
//   dw[m, k]   = f32(acc[m, k]) * (sa[m] * sg[k])   scale product first
//   fish[m, k] = dw[m, k] * dw[m, k]
//
// a_q [N, M] and g_q [N, K] are int8 codes of a layer's input and output
// cotangent, sa [M] and sg [K] their per-channel f32 scales.
//
// Replaces the JAX package's Pallas kernel
// kernels/gemm_fisher_int8.py::gemm_fisher_int8 (_gemm_fisher_int8_kernel,
// :50), whose sequential grid over N keeps an int32 accumulator tile in
// VMEM and rescales it in the epilogue.
//
// What bounds it: device memory. The two f32 outputs are 8 bytes per dw
// entry against 2 N int8 operations per entry at the card's 1,979 dense
// int8 TOPS, and the operands one byte per code. In this design, the load
// latency of a short slice and the stores of a 64 x 64 tile.
//
// The design:
//
// - Split over N, as in gemm_fisher.cu: each block owns one 64 x 64 tile of
//   dw and one slice of the reduction (blockIdx.z), the slices picked by the
//   wrapper from the shape alone. With S > 1 the blocks write int32
//   partials to a workspace [S, M, K] and a second kernel adds them (in
//   int32, so exactly, in slice order) and applies the epilogue.
// - Tensor cores by mma.sync.m16n8k32 s8 x s8 -> s32, exact, four warps per
//   block, each a 32 x 32 sub-tile. The fragments want four consecutive n
//   of one column in a 32-bit word, and the codes lie with m (or k)
//   contiguous. Slabs of 64 rows reach shared memory as they lie, by 16-byte
//   cp.async through a ring of kStages stages; each thread then reads a
//   4 x 4 byte block (4 rows, 4 consecutive columns) with four 32-bit loads
//   and transposes it with __byte_perm into four packed words, one per
//   column. Those four columns are four rows of the thread's fragments: the
//   mma's row g of m-fragment i is column 4 g + 2 i of the warp's 32 (row
//   g + 8: 4 g + 2 i + 1), and its column g of n-fragment j is column
//   4 g + j. Rows are 80 bytes apart and the 16-byte chunks of rows with
//   bit 3 set are swapped in pairs, so the four 32-bit loads of a warp hit
//   32 different banks. Six blocks fit an SM (85 registers a thread), so a
//   576-tile shape runs in one wave.
// - Where rows are not 16-byte aligned (M or K not a multiple of 16, or a
//   pointer off the grid) the block loads the codes byte by byte instead.
// - Epilogue: the int32 tile goes through shared memory (the ring, free by
//   then) and leaves in whole rows, 16 bytes a thread, so every store fills
//   its 32-byte sectors (16-byte stores straight from the fragments fill
//   half a sector each, and cost more than the rest of the kernel's work).
//
// Exactness: integer sums are exact in any order as long as they fit in
// int32. |code| <= 128 bounds |acc| and every partial sum by 128^2 N, so
// N <= 131,071 (the wrapper refuses larger N). The epilogue is three
// correctly rounded f32 operations, __fmul_rn(sa, sg), the
// round-to-nearest-even conversion __int2float_rn and __fmul_rn, in the
// reference's order (ref.py:106-107): the result is BIT-exact.
//
// C interface (bound with ctypes): a_q, g_q, sa, sg, dw, fish, ws are void*
// to row-major arrays (ws [S, M, K] int32, unused when S == 1); N, M, K are
// element counts, rows the length of every slice but the last, S the number
// of slices. Each entry point launches on the given stream, does not
// synchronise, allocates nothing, and returns the first CUDA error.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;       // dw tile: kTile x kTile
constexpr int kDepth = 64;      // rows of N per slab: two mma k-steps
constexpr int kStages = 3;      // slabs in the shared-memory ring
constexpr int kThreads = 128;   // four warps, 32 x 32 of dw each
constexpr int kBlocksPerSM = 6; // register budget: at most 85 a thread
constexpr int kPitch = 20;      // 32-bit words per shared row (64 codes + 16)
constexpr int kOutPitch = kTile + 4;  // words per row of the staged tile
constexpr int kReduceThreads = 128;
constexpr int kBatch = 8;       // partials in flight per reduce step

struct Stage {
  uint32_t a[kDepth][kPitch];
  uint32_t g[kDepth][kPitch];
};
constexpr int kSmem = int(sizeof(Stage)) * kStages;
static_assert(kSmem <= 48 * 1024, "static shared memory");
static_assert(kTile * kOutPitch * 4 <= kSmem, "the staged tile fits the ring");

// the word of row r that holds logical word w (16-byte chunks of rows with
// bit 3 set are swapped in pairs)
__device__ __forceinline__ int swz(int r, int w) { return w ^ (r & 8); }

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned s = unsigned(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One slab of x [*, cols] int8 (rows n0 .. n0 + kDepth cut at n_end,
// columns c0 .. c0 + kTile cut at cols) into dst as it lies, zero past the
// edges. kVec: 16-byte cp.async (rows 16-byte aligned); else byte loads.
template <bool kVec>
__device__ __forceinline__ void load_slab(uint32_t (*dst)[kPitch],
                                          const int8_t* __restrict__ x,
                                          int64_t n0, int64_t n_end,
                                          int64_t c0, int64_t cols) {
  if (kVec) {
#pragma unroll
    for (int j = 0; j < kDepth * 4 / kThreads; ++j) {
      const int i = threadIdx.x + j * kThreads;
      const int r = i / 4, c = i % 4;               // row, 16-byte chunk
      const int64_t n = n0 + r, col = c0 + 16 * c;
      const bool valid = n < n_end && col < cols;
      cp_async16(&dst[r][swz(r, 4 * c)], valid ? x + n * cols + col : x,
                 valid);
    }
  } else {
#pragma unroll 2
    for (int j = 0; j < kDepth * 16 / kThreads; ++j) {
      const int i = threadIdx.x + j * kThreads;
      const int r = i / 16, w = i % 16;             // row, 32-bit word
      const int64_t n = n0 + r;
      uint32_t v = 0;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int64_t col = c0 + 4 * w + q;
        if (n < n_end && col < cols) {
          v |= uint32_t(uint8_t(x[n * cols + col])) << (8 * q);
        }
      }
      dst[r][swz(r, w)] = v;
    }
  }
}

// Rows r .. r + 3 of word w (four consecutive columns), transposed: out[j]
// holds the four codes of column 4 w + j, row r first, as the mma reads them.
__device__ __forceinline__ void packed4(const uint32_t (*src)[kPitch], int r,
                                        int w, uint32_t (&out)[4]) {
  const uint32_t r0 = src[r][swz(r, w)], r1 = src[r + 1][swz(r + 1, w)];
  const uint32_t r2 = src[r + 2][swz(r + 2, w)];
  const uint32_t r3 = src[r + 3][swz(r + 3, w)];
  const uint32_t t0 = __byte_perm(r0, r1, 0x5140);  // r0.0 r1.0 r0.1 r1.1
  const uint32_t t1 = __byte_perm(r0, r1, 0x7362);  // r0.2 r1.2 r0.3 r1.3
  const uint32_t t2 = __byte_perm(r2, r3, 0x5140);
  const uint32_t t3 = __byte_perm(r2, r3, 0x7362);
  out[0] = __byte_perm(t0, t2, 0x5410);             // r0.0 r1.0 r2.0 r3.0
  out[1] = __byte_perm(t0, t2, 0x7632);
  out[2] = __byte_perm(t1, t3, 0x5410);
  out[3] = __byte_perm(t1, t3, 0x7632);
}

__device__ __forceinline__ void epilogue4(float* __restrict__ dw,
                                          float* __restrict__ fish,
                                          const float* __restrict__ sa,
                                          const float* __restrict__ sg,
                                          int64_t m, int64_t k, int64_t K,
                                          const int (&v)[4]) {
  float d[4];
  const float s = sa[m];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    d[q] = k + q < K ? __fmul_rn(__int2float_rn(v[q]), __fmul_rn(s, sg[k + q]))
                     : 0.f;
  }
  if ((K & 3) == 0 && k + 3 < K) {
    *reinterpret_cast<float4*>(dw + m * K + k) =
        make_float4(d[0], d[1], d[2], d[3]);
    *reinterpret_cast<float4*>(fish + m * K + k) =
        make_float4(__fmul_rn(d[0], d[0]), __fmul_rn(d[1], d[1]),
                    __fmul_rn(d[2], d[2]), __fmul_rn(d[3], d[3]));
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (k + q < K) {
        dw[m * K + k + q] = d[q];
        fish[m * K + k + q] = __fmul_rn(d[q], d[q]);
      }
    }
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
    gemm_fisher_int8_kernel(const int8_t* __restrict__ a,
                            const int8_t* __restrict__ g,
                            const float* __restrict__ sa,
                            const float* __restrict__ sg,
                            float* __restrict__ dw, float* __restrict__ fish,
                            int* __restrict__ ws, int64_t N, int64_t M,
                            int64_t K, int64_t rows) {
  __shared__ __align__(16) unsigned char smem_raw[kSmem];
  Stage* st = reinterpret_cast<Stage*>(smem_raw);

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int gq = lane / 4, tq = lane % 4;
  const int wm = (warp / 2) * 32, wk = (warp % 2) * 32;
  const int64_t m0 = int64_t(blockIdx.y) * kTile;
  const int64_t k0 = int64_t(blockIdx.x) * kTile;
  const int64_t n_begin = int64_t(blockIdx.z) * rows;
  const int64_t n_end = n_begin + rows < N ? n_begin + rows : N;
  const int slabs = n_end > n_begin
                        ? int((n_end - n_begin + kDepth - 1) / kDepth) : 0;

  int acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < slabs) {
      const int64_t n0 = n_begin + int64_t(s) * kDepth;
      load_slab<kVec>(st[s].a, a, n0, n_end, m0, M);
      load_slab<kVec>(st[s].g, g, n0, n_end, k0, K);
    }
    cp_async_commit();
  }

  for (int it = 0; it < slabs; ++it) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // slab `it` landed; stage (it - 1) % kStages is free
    {
      const int nxt = it + kStages - 1;
      if (nxt < slabs) {
        const int s = nxt % kStages;
        const int64_t n0 = n_begin + int64_t(nxt) * kDepth;
        load_slab<kVec>(st[s].a, a, n0, n_end, m0, M);
        load_slab<kVec>(st[s].g, g, n0, n_end, k0, K);
      }
      cp_async_commit();
    }
    const Stage& cur = st[it % kStages];

#pragma unroll
    for (int ks = 0; ks < kDepth; ks += 32) {
      // words of rows ks + 4t .. + 3 (h = 0) and ks + 16 + 4t .. (h = 1)
      uint32_t pa[2][4], pg[2][4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        packed4(cur.a, ks + 16 * h + 4 * tq, wm / 4 + gq, pa[h]);
        packed4(cur.g, ks + 16 * h + 4 * tq, wk / 4 + gq, pg[h]);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        // row g: column 4g + 2i, row g + 8: column 4g + 2i + 1
        const uint32_t fa[4] = {pa[0][2 * i], pa[0][2 * i + 1], pa[1][2 * i],
                                pa[1][2 * i + 1]};
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_s8(acc[i][j], fa, pg[0][j], pg[1][j]);
      }
    }
  }
  cp_async_wait<0>();
  // the reduce pass (if any) may launch now; it waits for this grid's end
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  __syncthreads();  // the ring is free: stage the tile there

  // acc[i][j]: c0 (row g, col 2t) is (m, k) = (4g + 2i, 8t + j), c1 (row g,
  // col 2t + 1) is (4g + 2i, 8t + 4 + j), c2 and c3 the same at m + 1
  int (*cs)[kOutPitch] = reinterpret_cast<int (*)[kOutPitch]>(smem_raw);
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        *reinterpret_cast<int4*>(
            &cs[wm + 4 * gq + 2 * i + r][wk + 8 * tq + 4 * half]) =
            make_int4(acc[i][0][2 * r + half], acc[i][1][2 * r + half],
                      acc[i][2][2 * r + half], acc[i][3][2 * r + half]);
      }
  __syncthreads();

  // whole rows of the tile, 16 bytes a thread: dw and fish (S == 1) or
  // the slice's int32 partial
#pragma unroll
  for (int j = 0; j < kTile * kTile / 4 / kThreads; ++j) {
    const int e = threadIdx.x + j * kThreads;
    const int r = e / (kTile / 4), c = 4 * (e % (kTile / 4));
    const int64_t m = m0 + r, k = k0 + c;
    if (m >= M || k >= K) continue;
    const int4 v4 = *reinterpret_cast<const int4*>(&cs[r][c]);
    const int v[4] = {v4.x, v4.y, v4.z, v4.w};
    if (ws == nullptr) {
      epilogue4(dw, fish, sa, sg, m, k, K, v);
    } else {
      int* p = ws + int64_t(blockIdx.z) * M * K + m * K + k;
      if ((K & 3) == 0 && k + 3 < K) {
        *reinterpret_cast<int4*>(p) = v4;
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if (k + q < K) p[q] = v[q];
        }
      }
    }
  }
}

// acc = ws[0] + ... + ws[S - 1] in int32 (exact), then the epilogue
__global__ void __launch_bounds__(kReduceThreads)
    reduce_kernel(const int* __restrict__ ws, const float* __restrict__ sa,
                  const float* __restrict__ sg, float* __restrict__ dw,
                  float* __restrict__ fish, int64_t M, int64_t K, int S) {
  // launched early (programmatic dependent launch): wait until the GEMM
  // grid has ended and its partials are visible
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const int64_t MK = M * K;
  const int64_t stride = int64_t(gridDim.x) * kReduceThreads;
  const int64_t first = int64_t(blockIdx.x) * kReduceThreads + threadIdx.x;
  if ((K & 3) == 0) {
    const int4* w4 = reinterpret_cast<const int4*>(ws);
    const int64_t n4 = MK / 4;
    for (int64_t e = first; e < n4; e += stride) {
      int4 s = w4[e];
      for (int z0 = 1; z0 < S; z0 += kBatch) {
        int4 p[kBatch];
#pragma unroll
        for (int q = 0; q < kBatch; ++q) {
          if (z0 + q < S) p[q] = w4[int64_t(z0 + q) * n4 + e];
        }
#pragma unroll
        for (int q = 0; q < kBatch; ++q) {
          if (z0 + q < S) {
            s.x += p[q].x;
            s.y += p[q].y;
            s.z += p[q].z;
            s.w += p[q].w;
          }
        }
      }
      const int v[4] = {s.x, s.y, s.z, s.w};
      epilogue4(dw, fish, sa, sg, (4 * e) / K, (4 * e) % K, K, v);
    }
  } else {
    for (int64_t e = first; e < MK; e += stride) {
      int s = ws[e];
      for (int z0 = 1; z0 < S; z0 += kBatch) {
        int p[kBatch];
#pragma unroll
        for (int q = 0; q < kBatch; ++q) {
          if (z0 + q < S) p[q] = ws[int64_t(z0 + q) * MK + e];
        }
#pragma unroll
        for (int q = 0; q < kBatch; ++q) {
          if (z0 + q < S) s += p[q];
        }
      }
      const int64_t m = e / K, k = e % K;
      const float d =
          __fmul_rn(__int2float_rn(s), __fmul_rn(sa[m], sg[k]));
      dw[e] = d;
      fish[e] = __fmul_rn(d, d);
    }
  }
}

}  // namespace

extern "C" int ficabu_gemm_fisher_int8(const void* a_q, const void* g_q,
                                       const void* sa_, const void* sg_,
                                       void* dw_, void* fish_, void* ws_,
                                       long long N, long long M, long long K,
                                       long long rows, long long S,
                                       void* stream_) {
  if (M <= 0 || K <= 0) return int(cudaSuccess);
  if (S < 1 || (S > 1 && ws_ == nullptr)) return int(cudaErrorInvalidValue);
  const int8_t* a = static_cast<const int8_t*>(a_q);
  const int8_t* g = static_cast<const int8_t*>(g_q);
  const float* sa = static_cast<const float*>(sa_);
  const float* sg = static_cast<const float*>(sg_);
  float* dw = static_cast<float*>(dw_);
  float* fish = static_cast<float*>(fish_);
  int* ws = S > 1 ? static_cast<int*>(ws_) : nullptr;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  const bool vec = (reinterpret_cast<uintptr_t>(a) % 16 == 0) &&
                   (reinterpret_cast<uintptr_t>(g) % 16 == 0) &&
                   M % 16 == 0 && K % 16 == 0;
  const dim3 grid(unsigned((K + kTile - 1) / kTile),
                  unsigned((M + kTile - 1) / kTile), unsigned(S));
  if (vec) {
    gemm_fisher_int8_kernel<true><<<grid, kThreads, 0, stream>>>(
        a, g, sa, sg, dw, fish, ws, N, M, K, rows);
  } else {
    gemm_fisher_int8_kernel<false><<<grid, kThreads, 0, stream>>>(
        a, g, sa, sg, dw, fish, ws, N, M, K, rows);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || S == 1) return int(err);
  const int64_t work = (K & 3) == 0 ? M * K / 4 : M * K;
  const int64_t blocks = (work + kReduceThreads - 1) / kReduceThreads;
  // a programmatic dependent launch: the reduce grid may start while the
  // GEMM grid finishes (hiding the launch gap) and waits for its end
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(unsigned(blocks < 65535 ? blocks : 65535));
  cfg.blockDim = dim3(kReduceThreads);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return int(cudaLaunchKernelEx(&cfg, reduce_kernel,
                                static_cast<const int*>(ws), sa, sg, dw, fish,
                                int64_t(M), int64_t(K), int(S)));
}
