// Dampening IP for Hopper (sm_90a): SSD select / beta / multiply in one pass,
// on float weights and on int8 weight codes.
//
// Replaces three of the JAX package's Pallas kernels, kernels/dampen.py::dampen
// (_dampen_kernel, :28), kernels/dampen.py::dampen_int8
// (_dampen_int8_kernel, :39) and kernels/dampen.py::dampen_int8_rowscale
// (_dampen_int8_rowscale_kernel, :51). Per element, in f32:
//
//   sel    = i_f > alpha * i_g
//   beta   = min(lam * i_g / max(i_f, 1e-30), 1)       NaN propagates
//   theta' = sel ? theta * beta : theta                 in theta's dtype
//
// and for int8 codes theta_q (the precision="int8" path, dequant-free: the
// per-channel scale table stays valid because beta <= 1)
//
//   theta_q' = int8(clip(sel ? round(theta_q * beta) : theta_q, -127, 127))
//
// with round half to even and NaN -> code 0 (XLA's float -> int8 convert).
// Both write the selection mask, one byte per element, from the same pass
// (the JAX wrappers recompute the mask outside their kernels, a second read
// of i_f and i_g). The rowscale variant takes the forget Fisher in the quant
// domain, i_fq [R, C] (as f32) with a per-row f32 scale table fs [R], and
// dequantises it in-register with one correctly rounded product,
//
//   i_f = i_fq[r, c] * fs[r]
//
// before the int8 rule above; like the reference's wrapper it returns the
// codes only and writes no mask.
//
// What bounds it: device memory. Per element it reads theta, i_f and i_g
// once and writes theta' and the mask once (17 bytes for f32 theta, 13 for
// bf16, 11 for int8 codes; 10 for rowscale, which reads i_fq as f32 and
// writes no mask) against five floating-point operations. So the design
// only moves each byte once, in wide transactions: a thread handles four
// neighbouring elements with 16-byte loads of i_f and i_g (and a 16-byte
// f32 / 8-byte bf16 / 4-byte int8 load of theta) whenever every pointer of
// the leaf is aligned for it, and a scalar loop takes the last n % 4
// elements (or the whole leaf, when one of its pointers is misaligned).
//
// What bounds a forget request's sweep is not the bytes but the launches:
// a ResNet-18 layer holds 2 to 7 leaves, most of them GroupNorm scales and
// biases of 64 to 512 elements, and one launch per leaf leaves the card
// waiting on the host. So the float and int8 kernels take a TABLE of leaves
// per launch (one layer, or a whole tree of up to 64 leaves) and count the
// selected elements in the same pass: a block reduces its count in shared
// memory and adds it to the caller's zeroed total with one atomic add, so
// the caller needs no reduction over the masks. The rowscale kernel finds an
// element's row by one division per thread and then steps it along with its
// grid-stride loop (no division per element), so rows of any length C, odd
// or not, share the 16-byte path.
//
// Exactness: the kernel must agree with the plain PyTorch version bit for
// bit. Build it WITHOUT --use_fast_math. The multiplies and the divide use
// the correctly rounded __fmul_rn / __fdiv_rn intrinsics, which nvcc never
// contracts into an FMA or replaces by an approximate reciprocal. max and
// min are written out so that NaN propagates as in torch.maximum /
// jnp.maximum (fmaxf / fminf would drop it). The result is always formed in
// f32 and converted with round-to-nearest-even, as PyTorch's own conversion
// does on the card; int8 codes round with rintf (half to even, as
// torch.round / jnp.round), never floorf(x + 0.5f).
//
// C interface (bound with ctypes): every pointer and the stream are void*,
// alpha and lam are f32 (the caller has rounded them once). Each entry point launches on the given stream, does not
// synchronise, allocates nothing, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = int64_t(1) << 20;
// the elements one block of the grouped kernel takes from its leaf: four per
// thread, one 16-byte step (kernels/dampen.py::ELEMS_PER_BLOCK)
constexpr int kElemsPerBlock = 4 * kThreads;
static_assert(kElemsPerBlock % (4 * kThreads) == 0,
              "a block takes whole 4-element steps of every thread");

template <typename T>
struct alignas(4 * sizeof(T)) Vec4 {
  T v[4];
};

__device__ __forceinline__ float nan_max(float x, float c) {
  return (x > c || x != x) ? x : c;
}

__device__ __forceinline__ float nan_min(float x, float c) {
  return (x < c || x != x) ? x : c;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ float to_f32(int8_t x) { return float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
// int8 codes: round half to even, saturate to +-127, NaN -> 0. An
// unselected code is already an integer, so rounding it changes nothing and
// the select needs no int8 special case.
template <>
__device__ __forceinline__ int8_t from_f32<int8_t>(float x) {
  if (x != x) return 0;
  const float r = fminf(fmaxf(rintf(x), -127.0f), 127.0f);
  return static_cast<int8_t>(__float2int_rn(r));
}

template <typename T>
__device__ __forceinline__ T dampen_one(T t, float f, float g, float alpha,
                                        float lam, unsigned char* sel) {
  const bool s = f > __fmul_rn(alpha, g);
  const float beta =
      nan_min(__fdiv_rn(__fmul_rn(lam, g), nan_max(f, 1e-30f)), 1.0f);
  const float tf = to_f32(t);
  *sel = s ? 1 : 0;
  return from_f32<T>(s ? __fmul_rn(tf, beta) : tf);
}

// One launch dampens a whole table of leaves (a layer's tensors, or a tree
// of them). The table goes in by value as a kernel parameter, the way
// PyTorch's multi_tensor_apply passes its tensor lists: no host-to-device
// copy, and 64 leaves of 56 bytes fit in the 4 KB parameter block. Leaf i
// owns the blocks [first_block, first_block + ceil(n / kElemsPerBlock)); a
// block finds its leaf by a binary search over that column and takes
// kElemsPerBlock elements of it.
struct Leaf {
  const void* theta;
  const float* i_f;
  const float* i_g;
  void* out;
  unsigned char* mask;
  long long n;
  int first_block;
  int vec;  // every pointer aligned for the 4-element path
};
static_assert(sizeof(Leaf) == 56, "a leaf row is 56 bytes");

constexpr int kMaxLeaves = 64;

struct Table {
  Leaf leaf[kMaxLeaves];
  int n_leaves;
};

// theta and out may be the same buffer (an in-place edit): each element is
// read and written by the same thread, so they are not marked __restrict__.
// The table is __grid_constant__: its rows are read where the parameter
// lies, never copied per thread. count (when not null) is an int64 that the
// caller has zeroed: each block adds its selected elements to it with one
// atomic add whose result nobody waits for, so no block waits on the count
// and no launch is needed to reset it.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    dampen_group_kernel(const __grid_constant__ Table table, float alpha,
                        float lam, unsigned long long* count) {
  const int b = blockIdx.x;
  int lo = 0, hi = table.n_leaves - 1;  // the last leaf with first_block <= b
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (table.leaf[mid].first_block <= b) {
      lo = mid;
    } else {
      hi = mid - 1;
    }
  }
  const Leaf& leaf = table.leaf[lo];
  const T* theta = static_cast<const T*>(leaf.theta);
  const float* __restrict__ i_f = leaf.i_f;
  const float* __restrict__ i_g = leaf.i_g;
  T* out = static_cast<T*>(leaf.out);
  unsigned char* __restrict__ mask = leaf.mask;
  const int64_t start = int64_t(b - leaf.first_block) * kElemsPerBlock;
  const int64_t stop = start + kElemsPerBlock;
  const int64_t end = stop < leaf.n ? stop : int64_t(leaf.n);
  unsigned int sel = 0;
  int64_t head = start;
  if (leaf.vec) {
    // start is a multiple of 4; only the leaf's last block has a tail
    const Vec4<T>* th4 = reinterpret_cast<const Vec4<T>*>(theta);
    const float4* f4 = reinterpret_cast<const float4*>(i_f);
    const float4* g4 = reinterpret_cast<const float4*>(i_g);
    Vec4<T>* o4 = reinterpret_cast<Vec4<T>*>(out);
    uchar4* m4 = reinterpret_cast<uchar4*>(mask);
    for (int64_t k = start / 4 + threadIdx.x; k < end / 4; k += kThreads) {
      const Vec4<T> t = th4[k];
      const float4 f = f4[k];
      const float4 g = g4[k];
      Vec4<T> o;
      uchar4 m;
      o.v[0] = dampen_one(t.v[0], f.x, g.x, alpha, lam, &m.x);
      o.v[1] = dampen_one(t.v[1], f.y, g.y, alpha, lam, &m.y);
      o.v[2] = dampen_one(t.v[2], f.z, g.z, alpha, lam, &m.z);
      o.v[3] = dampen_one(t.v[3], f.w, g.w, alpha, lam, &m.w);
      o4[k] = o;
      m4[k] = m;
      sel += m.x + m.y + m.z + m.w;
    }
    head = end / 4 * 4 > start ? end / 4 * 4 : start;
  }
  for (int64_t k = head + threadIdx.x; k < end; k += kThreads) {
    unsigned char m;
    out[k] = dampen_one(theta[k], i_f[k], i_g[k], alpha, lam, &m);
    mask[k] = m;
    sel += m;
  }
  if (count == nullptr) return;

  __shared__ unsigned int warp_sel[kThreads / 32];
  sel = __reduce_add_sync(0xffffffffu, sel);
  if (threadIdx.x % 32 == 0) warp_sel[threadIdx.x / 32] = sel;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long block_sel = 0;
    for (int w = 0; w < kThreads / 32; ++w) block_sel += warp_sel[w];
    if (block_sel) atomicAdd(count, block_sel);
  }
}

inline bool aligned(const void* p, uintptr_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// rows: n_leaves x 8 int64 (theta, i_f, i_g, out, mask, n, first_block,
// vec), as kernels/dampen.py::table_plan lays them out.
template <typename T>
int launch_group(const long long* rows, int n_leaves, long long blocks,
                 float alpha, float lam, void* count, void* stream) {
  if (n_leaves < 1 || n_leaves > kMaxLeaves || blocks < 0 ||
      blocks >= (1ll << 31)) {
    return int(cudaErrorInvalidValue);
  }
  if (blocks == 0) return int(cudaSuccess);  // only empty leaves
  Table table{};
  for (int i = 0; i < n_leaves; ++i) {
    const long long* r = rows + 8 * i;
    Leaf& leaf = table.leaf[i];
    leaf.theta = reinterpret_cast<const void*>(r[0]);
    leaf.i_f = reinterpret_cast<const float*>(r[1]);
    leaf.i_g = reinterpret_cast<const float*>(r[2]);
    leaf.out = reinterpret_cast<void*>(r[3]);
    leaf.mask = reinterpret_cast<unsigned char*>(r[4]);
    leaf.n = r[5];
    leaf.first_block = int(r[6]);
    leaf.vec = int(r[7]);
  }
  table.n_leaves = n_leaves;
  dampen_group_kernel<T><<<unsigned(blocks), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      table, alpha, lam, static_cast<unsigned long long*>(count));
  return int(cudaGetLastError());
}

// Rowscale: element k lies in row k / C. A thread computes its first row
// once and advances (row, column) by the grid stride after each step.
__device__ __forceinline__ void advance(int64_t& row, int64_t& col,
                                        int64_t rows, int64_t cols,
                                        int64_t C) {
  row += rows;
  col += cols;
  if (col >= C) {
    col -= C;
    row += 1;
  }
}

__device__ __forceinline__ int8_t rowscale_one(int8_t t, float fq, float fs,
                                               float g, float alpha,
                                               float lam) {
  unsigned char unused;
  return dampen_one(t, __fmul_rn(fq, fs), g, alpha, lam, &unused);
}

__global__ void dampen_int8_rowscale_kernel(
    const int8_t* __restrict__ theta, const float* __restrict__ i_fq,
    const float* __restrict__ fs, const float* __restrict__ i_g,
    int8_t* __restrict__ out,
    int64_t n, int64_t C, float alpha, float lam, bool vec) {
  const int64_t stride = int64_t(gridDim.x) * blockDim.x;
  const int64_t tid = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  int64_t head = 0;
  if (vec) {
    const int64_t nv = n / 4;
    const Vec4<int8_t>* th4 = reinterpret_cast<const Vec4<int8_t>*>(theta);
    const float4* f4 = reinterpret_cast<const float4*>(i_fq);
    const float4* g4 = reinterpret_cast<const float4*>(i_g);
    Vec4<int8_t>* o4 = reinterpret_cast<Vec4<int8_t>*>(out);
    // (row, col) of element 4 * k, and the grid stride 4 * stride in rows
    int64_t row = (4 * tid) / C, col = 4 * tid - row * C;
    const int64_t srows = (4 * stride) / C, scols = 4 * stride - srows * C;
    for (int64_t k = tid; k < nv; k += stride) {
      const Vec4<int8_t> t = th4[k];
      const float4 f = f4[k];
      const float4 g = g4[k];
      const float fv[4] = {f.x, f.y, f.z, f.w};
      const float gv[4] = {g.x, g.y, g.z, g.w};
      Vec4<int8_t> o;
      int64_t r = row, c = col;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        o.v[i] = rowscale_one(t.v[i], fv[i], fs[r], gv[i], alpha, lam);
        if (++c == C) {
          c = 0;
          ++r;
        }
      }
      o4[k] = o;
      advance(row, col, srows, scols, C);
    }
    head = nv * 4;
  }
  for (int64_t k = head + tid; k < n; k += stride) {
    out[k] = rowscale_one(theta[k], i_fq[k], fs[k / C], i_g[k], alpha, lam);
  }
}

}  // namespace

// One launch over a table of 1..64 leaves (none when every leaf is empty).
// count: an int64 on the device to which the launch adds the number of
// selected elements (the caller zeroes it once; the launches of a split
// table add to the same one), or null to count nothing.
#define FICABU_DAMPEN_GROUP(name, T)                                        \
  extern "C" int name(const long long* rows, int n_leaves, long long blocks, \
                      float alpha, float lam, void* count, void* stream) {  \
    return launch_group<T>(rows, n_leaves, blocks, alpha, lam, count,       \
                           stream);                                         \
  }

FICABU_DAMPEN_GROUP(ficabu_dampen_group_f32, float)
FICABU_DAMPEN_GROUP(ficabu_dampen_group_bf16, __nv_bfloat16)
FICABU_DAMPEN_GROUP(ficabu_dampen_group_int8, int8_t)

// theta_q, i_fq, i_g, out: [R, C] row-major (n = R * C elements); fs: [R].
extern "C" int ficabu_dampen_int8_rowscale(const void* theta_q,
                                           const void* i_fq, const void* fs,
                                           const void* i_g, void* out,
                                           long long n, long long C,
                                           float alpha, float lam,
                                           void* stream) {
  if (n <= 0 || C <= 0) return int(cudaSuccess);
  const bool vec = aligned(theta_q, 4) && aligned(out, 4) &&
                   aligned(i_fq, 16) && aligned(i_g, 16);
  int64_t work = vec ? n / 4 : n;
  if (work < 1) work = 1;
  int64_t blocks = (work + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  dampen_int8_rowscale_kernel<<<unsigned(blocks), kThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(theta_q), static_cast<const float*>(i_fq),
      static_cast<const float*>(fs), static_cast<const float*>(i_g),
      static_cast<int8_t*>(out), int64_t(n), int64_t(C), alpha, lam, vec);
  return int(cudaGetLastError());
}
