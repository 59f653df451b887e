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
// the caller needs no reduction over the masks.
//
// Rowscale is the same kernel body over a table of its own (RowLeaf): a
// block takes kElemsPerBlock contiguous elements of its part from a
// multiple of 4, flat over the leaf whatever C is, so rows of any length
// share the 16-byte path. The host cuts a leaf into parts of fewer than
// 2^31 elements (whole rows, or pieces of a row longer than that), so that
// a quad's row comes from 32-bit math: one multiply-high by a constant the
// host computed for C (e / C = umulhi(2e, mul) >> shr, exact for
// e < 2^31), no divide on the card. Its elements take their rows' scales
// from there, one row on wherever the quad crosses a row end. A leaf of
// fewer than 2^31 elements is one part, launched as a table of one whose
// row the kernel reads at fixed offsets. (One scale load per quad that
// lies in one row, the hardware's 32-bit divide, 2048 elements per block,
// 16 per thread and a kernel of its own measured no faster at the largest
// ResNet-18 leaf: tools/rowscale_variants.py.)
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

#include <type_traits>

namespace {

constexpr int kThreads = 256;
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

// A part of a rowscale leaf [R, C]: fewer than 2^31 elements from a row
// start (whole rows), or a piece of one row (then C is the piece's length),
// its i_f the quant-domain i_fq and fs the scale of its first row. No mask.
struct RowLeaf {
  const void* theta;
  const float* i_f;
  const float* i_g;
  void* out;
  const float* fs;
  long long n;
  int first_block;
  int vec;
  unsigned int C;    // row length
  unsigned int mul;  // row of element e: umulhi(2e, mul) >> shr
  unsigned int shr;
};
static_assert(sizeof(RowLeaf) == 72, "a rowscale row is 72 bytes");

constexpr int kMaxLeaves = 64;
constexpr int kMaxRowLeaves = 16;

template <typename L, int kMax>
struct TableOf {
  L leaf[kMax];
  int n_leaves;
};

// What a block needs of a part's rows, read from the table once: the scale
// table from the part's first row, the row length and its divisor.
struct RowMap {
  const float* fs;
  unsigned int C, mul, shr;
};

__device__ __forceinline__ RowMap row_map(const RowLeaf& leaf) {
  return {leaf.fs, leaf.C, leaf.mul, leaf.shr};
}
__device__ __forceinline__ RowMap row_map(const Leaf&) { return {}; }

__device__ __forceinline__ unsigned char* mask_of(const Leaf& leaf) {
  return leaf.mask;
}
__device__ __forceinline__ unsigned char* mask_of(const RowLeaf&) {
  return nullptr;
}

// The row of element e (< 2^31) of a part: e / C as a multiply-high by the
// host's constant (kernels/dampen.py::fast_divisor), no divide.
__device__ __forceinline__ unsigned row_of(const RowMap& m, unsigned e) {
  return __umulhi(e << 1, m.mul) >> m.shr;
}

// i_fq[e .. e + 3] * fs[row], each a correctly rounded product: the row of
// e from the multiplier, then a step to the next row wherever the quad
// crosses a row end (C % 4 != 0 or C < 4). The scale table stays in L1.
__device__ __forceinline__ float4 dequantise(const RowMap& m, unsigned e,
                                             float4 f) {
  const unsigned r = row_of(m, e);
  unsigned c = e - r * m.C;
  const float* fs = m.fs + r;
  float v[4] = {f.x, f.y, f.z, f.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[i] = __fmul_rn(v[i], *fs);
    if (++c == m.C) {
      c = 0;
      ++fs;
    }
  }
  return make_float4(v[0], v[1], v[2], v[3]);
}

// theta and out may be the same buffer (an in-place edit): each element is
// read and written by the same thread, so they are not marked __restrict__.
// The table is __grid_constant__: its rows are read where the parameter
// lies, never copied per thread. count (when not null) is an int64 that the
// caller has zeroed: each block adds its selected elements to it with one
// atomic add whose result nobody waits for, so no block waits on the count
// and no launch is needed to reset it. Over a table of RowLeaf parts
// (T = int8_t) the same body dequantises i_f first and writes no mask and
// no count.
template <typename T, typename L, int kMax>
__global__ void __launch_bounds__(kThreads)
    dampen_group_kernel(const __grid_constant__ TableOf<L, kMax> table,
                        float alpha, float lam, unsigned long long* count) {
  constexpr bool kRows = std::is_same<L, RowLeaf>::value;
  const int b = blockIdx.x;
  int lo = 0;  // the last leaf with first_block <= b
  if constexpr (kMax > 1) {
    int hi = table.n_leaves - 1;
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (table.leaf[mid].first_block <= b) {
        lo = mid;
      } else {
        hi = mid - 1;
      }
    }
  }
  const L& leaf = table.leaf[lo];
  const T* theta = static_cast<const T*>(leaf.theta);
  const float* __restrict__ i_f = leaf.i_f;
  const float* __restrict__ i_g = leaf.i_g;
  T* out = static_cast<T*>(leaf.out);
  unsigned char* __restrict__ mask = mask_of(leaf);
  const RowMap rows = row_map(leaf);
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
      float4 f = f4[k];
      const float4 g = g4[k];
      if constexpr (kRows) f = dequantise(rows, unsigned(4 * k), f);
      Vec4<T> o;
      uchar4 m;
      o.v[0] = dampen_one(t.v[0], f.x, g.x, alpha, lam, &m.x);
      o.v[1] = dampen_one(t.v[1], f.y, g.y, alpha, lam, &m.y);
      o.v[2] = dampen_one(t.v[2], f.z, g.z, alpha, lam, &m.z);
      o.v[3] = dampen_one(t.v[3], f.w, g.w, alpha, lam, &m.w);
      o4[k] = o;
      if constexpr (!kRows) {
        m4[k] = m;
        sel += m.x + m.y + m.z + m.w;
      }
    }
    head = end / 4 * 4 > start ? end / 4 * 4 : start;
  }
  for (int64_t k = head + threadIdx.x; k < end; k += kThreads) {
    float f = i_f[k];
    if constexpr (kRows) f = __fmul_rn(f, rows.fs[row_of(rows, unsigned(k))]);
    unsigned char m;
    out[k] = dampen_one(theta[k], f, i_g[k], alpha, lam, &m);
    if constexpr (!kRows) {
      mask[k] = m;
      sel += m;
    }
  }
  if (kRows || count == nullptr) return;

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

inline void fill(Leaf& leaf, const long long* r) {
  leaf.theta = reinterpret_cast<const void*>(r[0]);
  leaf.i_f = reinterpret_cast<const float*>(r[1]);
  leaf.i_g = reinterpret_cast<const float*>(r[2]);
  leaf.out = reinterpret_cast<void*>(r[3]);
  leaf.mask = reinterpret_cast<unsigned char*>(r[4]);
  leaf.n = r[5];
  leaf.first_block = int(r[6]);
  leaf.vec = int(r[7]);
}

inline void fill(RowLeaf& leaf, const long long* r) {
  leaf.theta = reinterpret_cast<const void*>(r[0]);
  leaf.i_f = reinterpret_cast<const float*>(r[1]);
  leaf.fs = reinterpret_cast<const float*>(r[2]);
  leaf.i_g = reinterpret_cast<const float*>(r[3]);
  leaf.out = reinterpret_cast<void*>(r[4]);
  leaf.n = r[5];
  leaf.first_block = int(r[6]);
  leaf.vec = int(r[7]);
  leaf.C = unsigned(r[8]);
  leaf.mul = unsigned(r[9]);
  leaf.shr = unsigned(r[10]);
}

// rows: n_leaves rows of kCols int64, as kernels/dampen.py lays them out:
// for Leaf (theta, i_f, i_g, out, mask, n, first_block, vec) by
// table_plan, for RowLeaf (theta, i_fq, fs, i_g, out, n, first_block, vec,
// C, mul, shr) by rowscale_plan. A RowLeaf must hold fewer than 2^31
// elements (its index math is 32-bit).
template <typename T, typename L, int kMax, int kCols>
int launch_table(const long long* rows, int n_leaves, long long blocks,
                 float alpha, float lam, void* count, void* stream) {
  if (n_leaves < 1 || n_leaves > kMax || blocks < 0 ||
      blocks >= (1ll << 31)) {
    return int(cudaErrorInvalidValue);
  }
  if (blocks == 0) return int(cudaSuccess);  // only empty leaves
  TableOf<L, kMax> table{};
  for (int i = 0; i < n_leaves; ++i) {
    const long long* r = rows + kCols * i;
    if constexpr (std::is_same<L, RowLeaf>::value) {
      if (r[5] >= (1ll << 31) || r[8] < 1 || r[8] >= (1ll << 31)) {
        return int(cudaErrorInvalidValue);
      }
    }
    fill(table.leaf[i], r);
  }
  table.n_leaves = n_leaves;
  dampen_group_kernel<T, L, kMax><<<unsigned(blocks), kThreads, 0,
                                    static_cast<cudaStream_t>(stream)>>>(
      table, alpha, lam, static_cast<unsigned long long*>(count));
  return int(cudaGetLastError());
}

}  // namespace

// One launch over a table of 1..64 leaves (none when every leaf is empty).
// count: an int64 on the device to which the launch adds the number of
// selected elements (the caller zeroes it once; the launches of a split
// table add to the same one), or null to count nothing.
#define FICABU_DAMPEN_GROUP(name, T)                                        \
  extern "C" int name(const long long* rows, int n_leaves, long long blocks, \
                      float alpha, float lam, void* count, void* stream) {  \
    return launch_table<T, Leaf, kMaxLeaves, 8>(rows, n_leaves, blocks,     \
                                                alpha, lam, count, stream); \
  }

FICABU_DAMPEN_GROUP(ficabu_dampen_group_f32, float)
FICABU_DAMPEN_GROUP(ficabu_dampen_group_bf16, __nv_bfloat16)
FICABU_DAMPEN_GROUP(ficabu_dampen_group_int8, int8_t)

// One launch over the 1..16 parts of a rowscale leaf (theta_q, i_fq, i_g,
// out [R, C] row-major int8 / f32 / f32 / int8, fs [R] f32), rows as
// kernels/dampen.py::rowscale_plan lays them out. A leaf of fewer than 2^31
// elements is one part: a table of one, whose row the kernel reads at fixed
// offsets, with no search.
extern "C" int ficabu_dampen_int8_rowscale(const long long* rows,
                                           int n_parts, long long blocks,
                                           float alpha, float lam,
                                           void* stream) {
  if (n_parts == 1) {
    return launch_table<int8_t, RowLeaf, 1, 11>(rows, n_parts, blocks, alpha,
                                                lam, nullptr, stream);
  }
  return launch_table<int8_t, RowLeaf, kMaxRowLeaves, 11>(
      rows, n_parts, blocks, alpha, lam, nullptr, stream);
}
