// Backward GEMM with the Fisher epilogue for Hopper (sm_90a):
//
//   dw[m, k]   = sum_n a[n, m] * g[n, k]     (dW = A^T G, f32 accumulate)
//   fish[m, k] = dw[m, k] * dw[m, k]
//
// a [N, M] is a layer's input (im2col'd for a conv), g [N, K] its output
// cotangent, both f32 or bf16.
//
// Replaces the JAX package's Pallas kernel kernels/gemm_fisher.py::gemm_fisher
// (_gemm_fisher_kernel, :38), whose sequential grid over N keeps an f32
// accumulator tile in VMEM and squares it in the epilogue.
//
// What bounds it: at the shapes of a ResNet-18 chunk (N = 128..8192,
// M = 576..4608, K = 64..512) device memory on paper: the two f32 outputs
// alone are 8 bytes per dw entry, and the arithmetic, 3 x 2 N M K TF32
// operations (below), takes about half as long at the card's dense TF32
// rate. In this design, the chain of shared-memory loads, TF32 splits and
// mma.sync of each k-step, and the load latency of a short slice.
//
// The design:
//
// - Split over N. Each block owns one 64 x 64 tile of dw and one slice of
//   the reduction (blockIdx.z). The wrapper picks the slices from the shape
//   alone (gemm_fisher.py::split_plan), so a shape with few dw tiles (M K =
//   576 x 64: 9 tiles) still fills the card, and the result does not depend
//   on the card. With one slice the block writes dw and fish itself; with
//   S > 1 it writes its f32 partial to a workspace [S, M, K] and a second
//   kernel adds the partials in slice order 0..S-1 (no float atomics), so
//   the result is the same bits on every run.
// - Tensor cores by mma.sync.m16n8k8 TF32, four warps per block, each a
//   32 x 32 sub-tile (2 x 4 fragments). One TF32 pass keeps 11 bits of each
//   operand and misses the rtol 1e-4 contract, so f32 operands run 3xTF32:
//   x = big + small with big = tf32(x) and small = tf32(x - big) (rounded to
//   nearest by two integer operations), and a b ~ a_small b_big + a_big
//   b_small + a_big b_big keeps about 22 bits per product. A bf16 value is
//   exact in TF32: one pass, exact products.
// - Both operands are reduction-major and stay so: no transpose. A thread
//   reads columns 4g .. 4g + 3 (g = lane / 4) of rows t and t + 4 (t =
//   lane % 4) of the k-step with one 16-byte load each, and those four
//   columns are four rows of its fragments: the mma's row g of m-fragment i
//   is column 4g + 2i of the warp's 32 (row g + 8: 4g + 2i + 1), its column
//   g of n-fragment j is column 4g + j. Rows of 64 + 8 f32 (64 + 16 bf16)
//   keep those loads free of bank conflicts. Slabs of 32 rows of A and G
//   reach shared memory by cp.async (16 bytes, zero-filled past the edges)
//   through a ring of kStages stages, two slabs in flight behind the
//   arithmetic. Where a row is not 16-byte aligned (M or K not a multiple
//   of 16 bytes, or a pointer off the grid) the block loads element by
//   element instead.
// - Accuracy: each 32-row slab is summed apart in fresh accumulators (12
//   mma steps) and then added to the running sum with a correctly rounded
//   f32 add, so a long reduction rounds over N / 32 additions, as an f32
//   loop over slabs would, whatever the tensor cores' internal rounding.
// - Epilogue: the tile goes through shared memory (the ring, free by then)
//   and leaves in whole rows, 16 bytes a thread, so every store fills its
//   32-byte sectors: dw and fish, the correctly rounded square of the
//   stored dw (__fmul_rn), bit for bit, or the slice's partial.
//
// C interface (bound with ctypes): a, g, dw, fish, ws are void* to row-major
// arrays (ws [S, M, K] f32, unused when S == 1); N, M, K are element counts,
// rows the length of every slice but the last, S the number of slices.
// Each entry point launches on the given stream, does not synchronise,
// allocates nothing, and returns the first CUDA error.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kTile = 64;             // dw tile: kTile x kTile
constexpr int kDepth = 32;            // rows of N per slab
constexpr int kStages = 3;            // slabs in the shared-memory ring
constexpr int kThreads = 128;         // four warps, 32 x 32 of dw each
constexpr int kOutPitch = kTile + 4;  // words per row of the staged dw tile
constexpr int kReduceThreads = 128;
constexpr int kBatch = 8;             // partials in flight per reduce step

// elements per shared row: 288 bytes for f32, 160 for bf16 (8 banks apart)
template <typename T>
constexpr int pitch() {
  return kTile + 32 / int(sizeof(T));
}

template <typename T>
struct Stage {
  T a[kDepth][pitch<T>()];
  T g[kDepth][pitch<T>()];
};

template <typename T>
constexpr int smem_bytes() {
  return int(sizeof(Stage<T>)) * kStages > kTile * kOutPitch * 4
             ? int(sizeof(Stage<T>)) * kStages
             : kTile * kOutPitch * 4;
}

__device__ __forceinline__ float zero(float) { return 0.f; }
__device__ __forceinline__ __nv_bfloat16 zero(__nv_bfloat16) {
  return __float2bfloat16(0.f);
}

// four consecutive elements of a shared row, as f32
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(v.x << 16),
                     __uint_as_float(v.x & 0xffff0000u),
                     __uint_as_float(v.y << 16),
                     __uint_as_float(v.y & 0xffff0000u));
}

// x rounded to TF32 (10 mantissa bits), to nearest with ties away from zero,
// as cvt.rna.tf32.f32 rounds a finite value, in two integer operations
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = big + small in TF32; a bf16 x is exact in TF32 and small is not used
template <bool kSplit>
__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  if (kSplit) {
    big = tf32(x);
    small = tf32(x - __uint_as_float(big));   // x - big is exact
  } else {
    big = __float_as_uint(x);
    small = 0u;
  }
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

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

// One slab of x [*, cols] (rows n0 .. n0 + kDepth, cut at n_end, columns
// c0 .. c0 + kTile, cut at cols) into dst, zero past the edges. kVec:
// 16-byte cp.async (rows 16-byte aligned); else element loads.
template <typename T, bool kVec>
__device__ __forceinline__ void load_slab(T (*dst)[pitch<T>()],
                                          const T* __restrict__ x,
                                          int64_t n0, int64_t n_end,
                                          int64_t c0, int64_t cols) {
  if (kVec) {
    constexpr int kPer = 16 / int(sizeof(T));     // elements per copy
    constexpr int kRow = kTile / kPer;            // copies per row
#pragma unroll
    for (int j = 0; j < kDepth * kRow / kThreads; ++j) {
      const int i = threadIdx.x + j * kThreads;
      const int r = i / kRow, c = (i % kRow) * kPer;
      const int64_t n = n0 + r, col = c0 + c;
      const bool valid = n < n_end && col < cols;
      cp_async16(&dst[r][c], valid ? x + n * cols + col : x, valid);
    }
  } else {
#pragma unroll 4
    for (int j = 0; j < kDepth * kTile / kThreads; ++j) {
      const int i = threadIdx.x + j * kThreads;
      const int r = i / kTile, c = i % kTile;
      const int64_t n = n0 + r, col = c0 + c;
      dst[r][c] = (n < n_end && col < cols) ? x[n * cols + col] : zero(T());
    }
  }
}

// v = out[m, k .. k + 3] (cut at K); fish (if given) its square
__device__ __forceinline__ void store4(float* __restrict__ out,
                                       float* __restrict__ fish, int64_t m,
                                       int64_t k, int64_t K, float4 v) {
  const float d[4] = {v.x, v.y, v.z, v.w};
  if ((K & 3) == 0 && k + 3 < K) {
    *reinterpret_cast<float4*>(out + m * K + k) = v;
    if (fish) {
      *reinterpret_cast<float4*>(fish + m * K + k) =
          make_float4(__fmul_rn(d[0], d[0]), __fmul_rn(d[1], d[1]),
                      __fmul_rn(d[2], d[2]), __fmul_rn(d[3], d[3]));
    }
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (k + q < K) {
        out[m * K + k + q] = d[q];
        if (fish) fish[m * K + k + q] = __fmul_rn(d[q], d[q]);
      }
    }
  }
}

template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
    gemm_fisher_kernel(const T* __restrict__ a, const T* __restrict__ g,
                       float* __restrict__ out, float* __restrict__ fish,
                       int64_t N, int64_t M, int64_t K, int64_t rows) {
  constexpr bool kSplit = std::is_same<T, float>::value;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Stage<T>* st = reinterpret_cast<Stage<T>*>(smem_raw);

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int gq = lane / 4, tq = lane % 4;
  const int wm = (warp / 2) * 32, wk = (warp % 2) * 32;
  const int64_t m0 = int64_t(blockIdx.y) * kTile;
  const int64_t k0 = int64_t(blockIdx.x) * kTile;
  const int64_t n_begin = int64_t(blockIdx.z) * rows;
  const int64_t n_end = n_begin + rows < N ? n_begin + rows : N;
  const int slabs = n_end > n_begin
                        ? int((n_end - n_begin + kDepth - 1) / kDepth) : 0;

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < slabs) {
      const int64_t n0 = n_begin + int64_t(s) * kDepth;
      load_slab<T, kVec>(st[s].a, a, n0, n_end, m0, M);
      load_slab<T, kVec>(st[s].g, g, n0, n_end, k0, K);
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
        load_slab<T, kVec>(st[s].a, a, n0, n_end, m0, M);
        load_slab<T, kVec>(st[s].g, g, n0, n_end, k0, K);
      }
      cp_async_commit();
    }
    const Stage<T>& cur = st[it % kStages];

    float part[2][4][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[i][j][e] = 0.f;

#pragma unroll
    for (int ks = 0; ks < kDepth; ks += 8) {
      // Columns 4g .. 4g + 3 of the warp's 32, rows t and t + 4 of the
      // k-step. A: row g of m-fragment i is column 4g + 2i, row g + 8 is
      // 4g + 2i + 1; B: column g of n-fragment j is column 4g + j.
      const float4 xa[2] = {load4(&cur.a[ks + tq][wm + 4 * gq]),
                            load4(&cur.a[ks + tq + 4][wm + 4 * gq])};
      const float4 xg[2] = {load4(&cur.g[ks + tq][wk + 4 * gq]),
                            load4(&cur.g[ks + tq + 4][wk + 4 * gq])};
      uint32_t ab[2][4], as[2][4], bb[4][2], bs[4][2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float va[4] = {xa[h].x, xa[h].y, xa[h].z, xa[h].w};
        const float vg[4] = {xg[h].x, xg[h].y, xg[h].z, xg[h].w};
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          split<kSplit>(va[2 * i], ab[i][2 * h], as[i][2 * h]);
          split<kSplit>(va[2 * i + 1], ab[i][2 * h + 1], as[i][2 * h + 1]);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) split<kSplit>(vg[j], bb[j][h], bs[j][h]);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (kSplit) {
            mma_tf32(part[i][j], as[i], bb[j][0], bb[j][1]);
            mma_tf32(part[i][j], ab[i], bs[j][0], bs[j][1]);
          }
          mma_tf32(part[i][j], ab[i], bb[j][0], bb[j][1]);
        }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[i][j][e] = __fadd_rn(acc[i][j][e], part[i][j][e]);
  }
  cp_async_wait<0>();
  // the reduce pass (if any) may launch now; it waits for this grid's end
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  __syncthreads();  // the ring is free: stage the tile there

  // acc[i][j]: c0 (row g, col 2t) is (m, k) = (4g + 2i, 8t + j), c1 (row
  // g, col 2t + 1) is (4g + 2i, 8t + 4 + j), c2 and c3 the same at m + 1
  float (*cs)[kOutPitch] = reinterpret_cast<float (*)[kOutPitch]>(smem_raw);
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        *reinterpret_cast<float4*>(
            &cs[wm + 4 * gq + 2 * i + r][wk + 8 * tq + 4 * half]) =
            make_float4(acc[i][0][2 * r + half], acc[i][1][2 * r + half],
                        acc[i][2][2 * r + half], acc[i][3][2 * r + half]);
      }
  __syncthreads();

  // whole rows of the tile, 16 bytes a thread: dw and fish (S == 1) or
  // the slice's partial
  float* dst = out + int64_t(blockIdx.z) * M * K;
#pragma unroll
  for (int j = 0; j < kTile * kTile / 4 / kThreads; ++j) {
    const int e = threadIdx.x + j * kThreads;
    const int r = e / (kTile / 4), c = 4 * (e % (kTile / 4));
    const int64_t m = m0 + r, k = k0 + c;
    if (m < M && k < K) {
      store4(dst, fish, m, k, K, *reinterpret_cast<const float4*>(&cs[r][c]));
    }
  }
}

// dw = ws[0] + ws[1] + ... + ws[S - 1], in that order; fish = dw * dw.
// Loads go out kBatch partials at a time, the adds stay in slice order.
__global__ void __launch_bounds__(kReduceThreads)
    reduce_kernel(const float* __restrict__ ws, float* __restrict__ dw,
                  float* __restrict__ fish, int64_t MK, int S) {
  // launched early (programmatic dependent launch): wait until the GEMM
  // grid has ended and its partials are visible
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const int64_t stride = int64_t(gridDim.x) * kReduceThreads;
  const int64_t first = int64_t(blockIdx.x) * kReduceThreads + threadIdx.x;
  if ((MK & 3) == 0) {
    const float4* w4 = reinterpret_cast<const float4*>(ws);
    const int64_t n4 = MK / 4;
    for (int64_t e = first; e < n4; e += stride) {
      float4 s = w4[e];
      for (int z0 = 1; z0 < S; z0 += kBatch) {
        float4 p[kBatch];
#pragma unroll
        for (int q = 0; q < kBatch; ++q) {
          if (z0 + q < S) p[q] = w4[int64_t(z0 + q) * n4 + e];
        }
#pragma unroll
        for (int q = 0; q < kBatch; ++q) {
          if (z0 + q < S) {
            s.x = __fadd_rn(s.x, p[q].x);
            s.y = __fadd_rn(s.y, p[q].y);
            s.z = __fadd_rn(s.z, p[q].z);
            s.w = __fadd_rn(s.w, p[q].w);
          }
        }
      }
      store4(dw, fish, 0, 4 * e, MK, s);
    }
  } else {
    for (int64_t e = first; e < MK; e += stride) {
      float s = ws[e];
      for (int z0 = 1; z0 < S; z0 += kBatch) {
        float p[kBatch];
#pragma unroll
        for (int q = 0; q < kBatch; ++q) {
          if (z0 + q < S) p[q] = ws[int64_t(z0 + q) * MK + e];
        }
#pragma unroll
        for (int q = 0; q < kBatch; ++q) {
          if (z0 + q < S) s = __fadd_rn(s, p[q]);
        }
      }
      dw[e] = s;
      fish[e] = __fmul_rn(s, s);
    }
  }
}

template <typename T, bool kVec>
cudaError_t launch_gemm(const T* a, const T* g, float* out, float* fish,
                        int64_t N, int64_t M, int64_t K, int64_t rows, int S,
                        cudaStream_t stream) {
  auto kernel = gemm_fisher_kernel<T, kVec>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes<T>());
  if (err != cudaSuccess) return err;
  const dim3 grid(unsigned((K + kTile - 1) / kTile),
                  unsigned((M + kTile - 1) / kTile), unsigned(S));
  kernel<<<grid, kThreads, smem_bytes<T>(), stream>>>(a, g, out, fish, N, M,
                                                      K, rows);
  return cudaGetLastError();
}

template <typename T>
int launch(const void* a_, const void* g_, void* dw_, void* fish_, void* ws_,
           long long N, long long M, long long K, long long rows, long long S,
           void* stream_) {
  if (M <= 0 || K <= 0) return int(cudaSuccess);
  if (S < 1 || (S > 1 && ws_ == nullptr)) return int(cudaErrorInvalidValue);
  const T* a = static_cast<const T*>(a_);
  const T* g = static_cast<const T*>(g_);
  float* dw = static_cast<float*>(dw_);
  float* fish = static_cast<float*>(fish_);
  float* ws = static_cast<float*>(ws_);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  constexpr int kPer = 16 / int(sizeof(T));
  const bool vec = (reinterpret_cast<uintptr_t>(a) % 16 == 0) &&
                   (reinterpret_cast<uintptr_t>(g) % 16 == 0) &&
                   M % kPer == 0 && K % kPer == 0;
  float* out = S == 1 ? dw : ws;
  float* f = S == 1 ? fish : nullptr;
  cudaError_t err =
      vec ? launch_gemm<T, true>(a, g, out, f, N, M, K, rows, int(S), stream)
          : launch_gemm<T, false>(a, g, out, f, N, M, K, rows, int(S),
                                  stream);
  if (err != cudaSuccess || S == 1) return int(err);
  const int64_t MK = int64_t(M) * K;
  const int64_t work = (MK & 3) == 0 ? MK / 4 : MK;
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
                                static_cast<const float*>(ws), dw, fish, MK,
                                int(S)));
}

}  // namespace

extern "C" int ficabu_gemm_fisher_f32(const void* a, const void* g, void* dw,
                                      void* fish, void* ws, long long N,
                                      long long M, long long K,
                                      long long rows, long long S,
                                      void* stream) {
  return launch<float>(a, g, dw, fish, ws, N, M, K, rows, S, stream);
}

extern "C" int ficabu_gemm_fisher_bf16(const void* a, const void* g, void* dw,
                                       void* fish, void* ws, long long N,
                                       long long M, long long K,
                                       long long rows, long long S,
                                       void* stream) {
  return launch<__nv_bfloat16>(a, g, dw, fish, ws, N, M, K, rows, S, stream);
}
