// The row geometry of the port's elementwise kernels (mont_mul.cu,
// mod_add.cu).  Each operand is described by its element strides along
// at most kRowDims merged row dims (a stride of 0 is a broadcast row dim)
// and one block computes one tile of one row: the row comes from
// blockIdx.y/z without a division, and thread 0 turns it into the
// operands' offsets (32-bit divisions, one per row dim beyond the first)
// and hands them over in shared memory.  core/rowgeom.py is the wrapper's
// side: it merges the dims and chooses the access width and the grid.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace optconv {

constexpr int kRowDims = 4;

// The merged row dims of K operands, as a kernel argument.
template <int K>
struct RowIndex {
  int nd;
  unsigned size[kRowDims];
  long long stride[K][kRowDims];
};

// Each operand's element offset at row r: for thread 0 of a block.
template <int K>
__device__ __forceinline__ void row_offsets(const RowIndex<K>& ix, unsigned r,
                                            long long* s_off) {
  long long off[K];
#pragma unroll
  for (int k = 0; k < K; ++k) off[k] = 0;
#pragma unroll
  for (int d = kRowDims - 1; d > 0; --d) {
    if (d < ix.nd) {
      const unsigned hi = r / ix.size[d];
      const unsigned lo = r - hi * ix.size[d];
#pragma unroll
      for (int k = 0; k < K; ++k) off[k] += (long long)lo * ix.stride[k][d];
      r = hi;
    }
  }
#pragma unroll
  for (int k = 0; k < K; ++k) s_off[k] = off[k] + (long long)r * ix.stride[k][0];
}

__device__ __forceinline__ uint64_t load(const uint64_t* p) {
  return __ldg(reinterpret_cast<const unsigned long long*>(p));
}
__device__ __forceinline__ ulonglong2 load(const ulonglong2* p) {
  return __ldg(p);
}

__device__ __forceinline__ void splat(uint64_t& d, uint64_t v) { d = v; }
__device__ __forceinline__ void splat(ulonglong2& d, uint64_t v) {
  d.x = v;
  d.y = v;
}

// A thread's unit of access: a 16-byte vector of two elements if VEC,
// else one element.
template <bool VEC> struct Unit { using type = uint64_t; };
template <> struct Unit<true> { using type = ulonglong2; };

// The host's check of a launch description L (its n, rows, size, stride,
// nd, vec, threads, gx, gy, gz) against what the kernels index, for
// tiles of L.threads x per_thread units and at most max_threads threads;
// fills ix.  False for a description the kernels do not take.
template <int K, class L>
bool row_index(const L& l, int max_threads, int per_thread, RowIndex<K>* ix) {
  const long long lim = 1ll << 31;
  if (l.nd < 0 || l.nd > kRowDims || l.n < 1 || l.n >= lim || l.rows < 1 ||
      l.rows >= lim || (l.vec && (l.n & 1)) || l.threads < 32 ||
      l.threads > max_threads || (l.threads & 31) || l.gx < 1 || l.gy < 1 ||
      l.gy > 65535 || l.gz < 1 || l.gz > 65535 ||
      (long long)l.gy * l.gz < l.rows)
    return false;
  ix->nd = l.nd;
  long long rows = 1;
  for (int d = 0; d < kRowDims; ++d) {
    const long long size = d < l.nd ? l.size[d] : 1;
    if (size < 1 || size >= lim || rows * size >= lim) return false;
    rows *= size;
    ix->size[d] = (unsigned)size;
    for (int k = 0; k < K; ++k) ix->stride[k][d] = d < l.nd ? l.stride[k][d] : 0;
  }
  const long long units = l.vec ? l.n / 2 : l.n;
  return rows == l.rows && (long long)l.gx * l.threads * per_thread >= units;
}

}  // namespace optconv
