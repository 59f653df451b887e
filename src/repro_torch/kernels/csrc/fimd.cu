// FIMD IP for Hopper (sm_90a): the diagonal of the Fisher information as a
// column reduction of squared gradients, out[p] = sum_b g[b, p]^2, in f32.
//
// Replaces the JAX package's Pallas kernel kernels/fimd.py::fimd
// (_fimd_kernel, :27). There the sequential grid over B keeps an
// accumulator tile resident in VMEM; here one thread owns its columns for
// the whole reduction and keeps the accumulator in registers, so blocks
// never need to meet and one launch covers the array.
//
// What bounds it: device memory. It reads g once (B * P * sizeof(T) bytes)
// and writes out once (4 * P bytes) against two floating-point operations
// per element read. So the design only moves each byte once, in wide
// transactions: a thread handles four neighbouring columns with one 16-byte
// load (f32) or 8-byte load (bf16) per row whenever P % 4 == 0 and both
// pointers are aligned for it; neighbouring threads take neighbouring
// columns, so a warp reads 512 contiguous bytes of a row at a time. One
// grid-stride loop covers any P; otherwise (P % 4 != 0, or a misaligned
// pointer) a scalar loop gives each thread one column.
//
// Arithmetic: bf16 is widened to f32 before squaring (as fimd.py:29), each
// square and each sum is one correctly rounded f32 operation (__fmul_rn,
// __fadd_rn: never contracted into an FMA), summed in row order b = 0..B-1
// from 0. Build without --use_fast_math.
//
// C interface (bound with ctypes): g [B, P] row-major and out [P] f32 are
// void*, B and P are element counts. Each entry point launches on the given
// stream, does not synchronise, allocates nothing, and returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = int64_t(1) << 20;

template <typename T>
struct alignas(4 * sizeof(T)) Vec4 {
  T v[4];
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ float add_square(float acc, float x) {
  return __fadd_rn(acc, __fmul_rn(x, x));
}

template <typename T>
__global__ void fimd_kernel(const T* __restrict__ g, float* __restrict__ out,
                            int64_t B, int64_t P, bool vec) {
  const int64_t stride = int64_t(gridDim.x) * blockDim.x;
  const int64_t tid = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (vec) {
    const int64_t pv = P / 4;
    const Vec4<T>* g4 = reinterpret_cast<const Vec4<T>*>(g);
    float4* o4 = reinterpret_cast<float4*>(out);
    for (int64_t k = tid; k < pv; k += stride) {
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
      for (int64_t b = 0; b < B; ++b) {
        const Vec4<T> x = g4[b * pv + k];
        acc.x = add_square(acc.x, to_f32(x.v[0]));
        acc.y = add_square(acc.y, to_f32(x.v[1]));
        acc.z = add_square(acc.z, to_f32(x.v[2]));
        acc.w = add_square(acc.w, to_f32(x.v[3]));
      }
      o4[k] = acc;
    }
    return;
  }
  for (int64_t p = tid; p < P; p += stride) {
    float acc = 0.f;
#pragma unroll 8
    for (int64_t b = 0; b < B; ++b) acc = add_square(acc, to_f32(g[b * P + p]));
    out[p] = acc;
  }
}

inline bool aligned(const void* p, uintptr_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

template <typename T>
int launch(const void* g, void* out, long long B, long long P, void* stream) {
  if (P <= 0) return int(cudaSuccess);
  const bool vec = P % 4 == 0 && aligned(g, 4 * sizeof(T)) && aligned(out, 16);
  const int64_t work = vec ? P / 4 : P;
  int64_t blocks = (work + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  fimd_kernel<T><<<unsigned(blocks), kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(g), static_cast<float*>(out), int64_t(B),
      int64_t(P), vec);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" int ficabu_fimd_f32(const void* g, void* out, long long B,
                               long long P, void* stream) {
  return launch<float>(g, out, B, P, stream);
}

extern "C" int ficabu_fimd_bf16(const void* g, void* out, long long B,
                                long long P, void* stream) {
  return launch<__nv_bfloat16>(g, out, B, P, stream);
}
