// Backward GEMM with the Fisher epilogue for Hopper (sm_90a):
//
//   dw[m, k]   = sum_n a[n, m] * g[n, k]     (dW = A^T G, f32 accumulate)
//   fish[m, k] = dw[m, k] * dw[m, k]
//
// a [N, M] is a layer's input (im2col'd for a conv), g [N, K] its output
// cotangent, both f32 or bf16 (bf16 is widened to f32 on load; a bf16 x bf16
// product is exact in f32).
//
// Replaces the JAX package's Pallas kernel kernels/gemm_fisher.py::gemm_fisher
// (_gemm_fisher_kernel, :38), whose sequential grid over N keeps an f32
// accumulator tile in VMEM and squares it in the epilogue. Here each block
// owns one 64 x 64 tile of dw and walks the whole reduction over N itself,
// so nothing carries over between blocks and dw never makes a round trip
// through device memory before it is squared: the epilogue writes dw and
// dw * dw from the same registers.
//
// What bounds it: at the shapes of a ResNet-18 chunk (N = 128..8192,
// M = 576..4608, K = 64..512) the 2 N M K floating-point operations, at the
// FP32 rate of the SIMT cores. Not TF32: the contract is rtol 1e-4 for f32
// operands and one TF32 pass keeps about three decimal digits. The design
// is a plain tiled SGEMM, right before fast: the block stages a 16-deep slab
// of A^T (16 x 64) and of G (16 x 64) through shared memory, coalesced
// along m and k (the operands' contiguous axis, so neither needs a
// transpose); each of 256 threads keeps a 4 x 4 register tile of dw (rows
// ty + 16 i, columns tx + 16 j, so a warp's shared-memory reads are
// broadcasts or 16 consecutive words) and adds the slab's outer products
// with f32 FMAs. The edges of M, K and N are masked with zeros, so any
// shape runs. There is no split over N: a shape with few dw tiles (small
// M * K, long N) leaves most SMs idle.
//
// Accuracy: each 16-deep slab is summed apart (one FMA per term) and then
// added to the running sum, so a long reduction (N = 8192) accumulates
// rounding over N / 16 additions instead of N. The order is fixed, so the
// result does not change between runs; fish is the correctly rounded square
// of the stored dw (__fmul_rn), bit for bit.
//
// C interface (bound with ctypes): a, g, dw, fish are void* to row-major
// arrays; N, M, K are element counts. Each entry point launches on the given
// stream, does not synchronise, allocates nothing, and returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;     // dw tile: kTile x kTile
constexpr int kDepth = 16;    // reduction slab over N
constexpr int kThreads = 256; // 16 x 16 threads, 4 x 4 outputs each
constexpr int kMicro = 4;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    gemm_fisher_kernel(const T* __restrict__ a, const T* __restrict__ g,
                       float* __restrict__ dw, float* __restrict__ fish,
                       int64_t N, int64_t M, int64_t K) {
  __shared__ float As[kDepth][kTile];
  __shared__ float Gs[kDepth][kTile];
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int64_t m0 = int64_t(blockIdx.y) * kTile;
  const int64_t k0 = int64_t(blockIdx.x) * kTile;

  float acc[kMicro][kMicro];
#pragma unroll
  for (int i = 0; i < kMicro; ++i)
#pragma unroll
    for (int j = 0; j < kMicro; ++j) acc[i][j] = 0.f;

  for (int64_t n0 = 0; n0 < N; n0 += kDepth) {
#pragma unroll
    for (int r = 0; r < kDepth * kTile / kThreads; ++r) {
      const int e = threadIdx.x + kThreads * r;
      const int dn = e / kTile, dc = e % kTile;
      const int64_t n = n0 + dn, m = m0 + dc, k = k0 + dc;
      As[dn][dc] = (n < N && m < M) ? to_f32(a[n * M + m]) : 0.f;
      Gs[dn][dc] = (n < N && k < K) ? to_f32(g[n * K + k]) : 0.f;
    }
    __syncthreads();
    float part[kMicro][kMicro];
#pragma unroll
    for (int i = 0; i < kMicro; ++i)
#pragma unroll
      for (int j = 0; j < kMicro; ++j) part[i][j] = 0.f;
#pragma unroll
    for (int dn = 0; dn < kDepth; ++dn) {
      float av[kMicro], gv[kMicro];
#pragma unroll
      for (int i = 0; i < kMicro; ++i) av[i] = As[dn][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < kMicro; ++j) gv[j] = Gs[dn][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < kMicro; ++i)
#pragma unroll
        for (int j = 0; j < kMicro; ++j)
          part[i][j] = __fmaf_rn(av[i], gv[j], part[i][j]);
    }
#pragma unroll
    for (int i = 0; i < kMicro; ++i)
#pragma unroll
      for (int j = 0; j < kMicro; ++j)
        acc[i][j] = __fadd_rn(acc[i][j], part[i][j]);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kMicro; ++i) {
    const int64_t m = m0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < kMicro; ++j) {
      const int64_t k = k0 + tx + 16 * j;
      if (m < M && k < K) {
        const float d = acc[i][j];
        dw[m * K + k] = d;
        fish[m * K + k] = __fmul_rn(d, d);
      }
    }
  }
}

template <typename T>
int launch(const void* a, const void* g, void* dw, void* fish, long long N,
           long long M, long long K, void* stream) {
  if (M <= 0 || K <= 0) return int(cudaSuccess);
  const dim3 grid(unsigned((K + kTile - 1) / kTile),
                  unsigned((M + kTile - 1) / kTile));
  gemm_fisher_kernel<T><<<grid, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(a), static_cast<const T*>(g),
      static_cast<float*>(dw), static_cast<float*>(fish), int64_t(N),
      int64_t(M), int64_t(K));
  return int(cudaGetLastError());
}

}  // namespace

extern "C" int ficabu_gemm_fisher_f32(const void* a, const void* g, void* dw,
                                      void* fish, long long N, long long M,
                                      long long K, void* stream) {
  return launch<float>(a, g, dw, fish, N, M, K, stream);
}

extern "C" int ficabu_gemm_fisher_bf16(const void* a, const void* g, void* dw,
                                       void* fish, long long N, long long M,
                                       long long K, void* stream) {
  return launch<__nv_bfloat16>(a, g, dw, fish, N, M, K, stream);
}
