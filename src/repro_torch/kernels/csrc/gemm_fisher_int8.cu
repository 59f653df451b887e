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
// VMEM. Here each block owns one 64 x 64 tile of dw and walks the whole
// reduction itself; the epilogue rescales and squares the tile from the
// same registers.
//
// What bounds it: at the shapes of a ResNet-18 chunk, device memory on
// paper (the two f32 outputs, 8 bytes per dw entry, against 2 N int8
// operations per entry at the card's 1,979 dense int8 TOPS); in this simple
// design, the integer instruction rate of the SIMT cores. The block stages a
// 32-deep slab of A^T and of G through shared memory, packing four
// consecutive n of one column into one 32-bit word as it stores them; each
// of 256 threads keeps a 4 x 4 register tile of int32 sums and adds four
// products per __dp4a (signed 8-bit dot product with 32-bit accumulate).
// Edges are masked with zero codes, so any shape runs.
//
// Exactness: integer sums are exact in any order as long as they fit in
// int32. |code| <= 127 bounds |acc| by 127^2 N, so N <= 133,144 (a -128 code
// lowers it to 131,071; the wrapper refuses larger N). The epilogue is
// three correctly rounded f32 operations, __fmul_rn(sa, sg), the
// round-to-nearest-even conversion __int2float_rn and __fmul_rn, in the
// reference's order (ref.py:106-107): the result is BIT-exact.
//
// C interface (bound with ctypes): a_q, g_q, sa, sg, dw, fish are void* to
// row-major arrays; N, M, K are element counts. Each entry point launches on
// the given stream, does not synchronise, allocates nothing, and returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;      // dw tile: kTile x kTile
constexpr int kWords = 8;      // reduction slab: 8 words of 4 codes = 32 n
constexpr int kThreads = 256;  // 16 x 16 threads, 4 x 4 outputs each
constexpr int kMicro = 4;

// Four codes of column c at rows n .. n + 3 (zero past N or past the
// column count), packed little-end first as __dp4a reads them.
__device__ __forceinline__ int pack4(const int8_t* __restrict__ x, int64_t n,
                                     int64_t N, int64_t c, int64_t cols) {
  unsigned w = 0;
  if (c < cols) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (n + q < N) {
        w |= unsigned(uint8_t(x[(n + q) * cols + c])) << (8 * q);
      }
    }
  }
  return int(w);
}

__global__ void __launch_bounds__(kThreads)
    gemm_fisher_int8_kernel(const int8_t* __restrict__ a,
                            const int8_t* __restrict__ g,
                            const float* __restrict__ sa,
                            const float* __restrict__ sg,
                            float* __restrict__ dw, float* __restrict__ fish,
                            int64_t N, int64_t M, int64_t K) {
  __shared__ int As[kWords][kTile];
  __shared__ int Gs[kWords][kTile];
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int64_t m0 = int64_t(blockIdx.y) * kTile;
  const int64_t k0 = int64_t(blockIdx.x) * kTile;

  int acc[kMicro][kMicro];
#pragma unroll
  for (int i = 0; i < kMicro; ++i)
#pragma unroll
    for (int j = 0; j < kMicro; ++j) acc[i][j] = 0;

  for (int64_t n0 = 0; n0 < N; n0 += 4 * kWords) {
#pragma unroll
    for (int r = 0; r < kWords * kTile / kThreads; ++r) {
      const int e = threadIdx.x + kThreads * r;
      const int w = e / kTile, dc = e % kTile;
      const int64_t n = n0 + 4 * w;
      As[w][dc] = pack4(a, n, N, m0 + dc, M);
      Gs[w][dc] = pack4(g, n, N, k0 + dc, K);
    }
    __syncthreads();
#pragma unroll
    for (int w = 0; w < kWords; ++w) {
      int av[kMicro], gv[kMicro];
#pragma unroll
      for (int i = 0; i < kMicro; ++i) av[i] = As[w][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < kMicro; ++j) gv[j] = Gs[w][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < kMicro; ++i)
#pragma unroll
        for (int j = 0; j < kMicro; ++j)
          acc[i][j] = __dp4a(av[i], gv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kMicro; ++i) {
    const int64_t m = m0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < kMicro; ++j) {
      const int64_t k = k0 + tx + 16 * j;
      if (m < M && k < K) {
        const float sc = __fmul_rn(sa[m], sg[k]);
        const float d = __fmul_rn(__int2float_rn(acc[i][j]), sc);
        dw[m * K + k] = d;
        fish[m * K + k] = __fmul_rn(d, d);
      }
    }
  }
}

}  // namespace

extern "C" int ficabu_gemm_fisher_int8(const void* a_q, const void* g_q,
                                       const void* sa, const void* sg,
                                       void* dw, void* fish, long long N,
                                       long long M, long long K,
                                       void* stream) {
  if (M <= 0 || K <= 0) return int(cudaSuccess);
  const dim3 grid(unsigned((K + kTile - 1) / kTile),
                  unsigned((M + kTile - 1) / kTile));
  gemm_fisher_int8_kernel<<<grid, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(a_q), static_cast<const int8_t*>(g_q),
      static_cast<const float*>(sa), static_cast<const float*>(sg),
      static_cast<float*>(dw), static_cast<float*>(fish), int64_t(N),
      int64_t(M), int64_t(K));
  return int(cudaGetLastError());
}
