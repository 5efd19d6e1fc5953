// K1 on Hopper: elementwise Montgomery product a*b*2^-64 mod q, and the
// chained product (a*b*2^-64)*c*2^-64 mod q with c constant along a row.
//
// Replaces optimal_conv_tpu/core/pallas_mod.py: mont_mul_pallas (the
// Pallas kernel _make_mont_kernel -> mont_mul_u32pair).  The TPU kernel
// carried each residue as a (lo32, hi32) pair with comparison-free
// carries because Mosaic had no uint64 and no vector compares; here the
// residues are native uint64 and the two high products are __umul64hi.
//
// What bounds it on the card: device-memory bytes.  One product reads
// a and b and writes the result, 24 B per element, against 33 integer
// instructions, far below the H100's compute-to-bandwidth ratio.  So
// the design keeps the bytes at that minimum and everything else off
// the per-element path:
//   * broadcast operands are read in place through row strides (a
//     Montgomery constant or a ciphertext shared by many plaintexts is
//     never expanded in memory), and the chained product never writes
//     its intermediate;
//   * one block owns one tile of one row (row_index.cuh, which
//     mod_add.cu shares); q, qinv, c and a column-scalar operand are
//     loaded once per thread per tile;
//   * a thread handles two independent 16-byte vectors (ulonglong2)
//     per operand, neighbouring threads on neighbouring addresses, all
//     loads issued before the arithmetic.  On the H100 small tiles won
//     (128 threads x 2 vectors beat 256 x 4 by 10% and 256 x 8 by 30%
//     at [1,2,N] x [256,2,N]; one vector a thread loses 5% on the
//     chained product).  An operand that is not 16-byte aligned takes
//     the same kernel with 8-byte accesses;
//   * loads are read-only (__ldg) and stores are plain: the evict-first
//     hints gained 3% at one shape and lost 2% at another, and a
//     broadcast operand of a few MB stays in the 50 MB L2 without them.
// The wrapper's plan (core/mont_kernel.py) chooses vector or scalar
// access, the block size and the grid, and passes them as integers.

#include <cstdint>
#include <cuda_runtime.h>

#include "modarith.cuh"
#include "row_index.cuh"

constexpr int kMaxDims = optconv::kRowDims;
constexpr int kOps = 5;            // a, b, q, qinv, c
constexpr int kMaxThreads = 256;
constexpr int kPerThread = 2;      // units a thread; mont_kernel.PER_THREAD

// The launch description; core/mont_kernel.py: Launch mirrors it.
struct OptconvMontLaunch {
  long long n;                          // row length
  long long rows;                       // product of size[0..nd)
  long long size[kMaxDims];             // merged row dims, outermost first
  long long stride[kOps][kMaxDims];     // element strides, 0 = broadcast
  int nd, a_col, b_col, chained, vec, threads;
  int gx, gy, gz;
};

namespace {

using Launch = OptconvMontLaunch;
using RowIndex = optconv::RowIndex<kOps>;
using optconv::load;
using optconv::splat;

// mont(x, y), or mont(mont(x, y), c): the first product stays lazily
// reduced (below 2q, inside mont_mul's 4q input range), the last one is
// canonical, so the result is the residue two canonical products give.
template <bool CHAINED>
__device__ __forceinline__ uint64_t product(uint64_t x, uint64_t y, uint64_t c,
                                            uint64_t q, uint64_t qinv) {
  if (CHAINED)
    return optconv::mont_mul(optconv::mont_mul_lazy(x, y, q, qinv), c, q, qinv);
  return optconv::mont_mul(x, y, q, qinv);
}
template <bool CHAINED>
__device__ __forceinline__ ulonglong2 product(ulonglong2 x, ulonglong2 y,
                                              uint64_t c, uint64_t q,
                                              uint64_t qinv) {
  ulonglong2 r;
  r.x = product<CHAINED>((uint64_t)x.x, (uint64_t)y.x, c, q, qinv);
  r.y = product<CHAINED>((uint64_t)x.y, (uint64_t)y.y, c, q, qinv);
  return r;
}

// One block: one tile of blockDim.x * kPerThread units (vectors of two
// elements if VEC, else elements) of one row.
template <bool VEC, bool CHAINED>
__global__ void __launch_bounds__(kMaxThreads)
mont_mul_kernel(uint64_t* __restrict__ out, const uint64_t* __restrict__ a,
                const uint64_t* __restrict__ b, const uint64_t* __restrict__ q,
                const uint64_t* __restrict__ qinv,
                const uint64_t* __restrict__ c, unsigned rows, unsigned n,
                int a_col, int b_col, RowIndex ix) {
  constexpr int V = kPerThread;
  using T = typename optconv::Unit<VEC>::type;
  __shared__ long long s_off[kOps];
  const unsigned row = blockIdx.z * gridDim.y + blockIdx.y;
  if (row >= rows) return;               // the whole block, before the barrier
  if (threadIdx.x == 0) optconv::row_offsets(ix, row, s_off);
  __syncthreads();
  const uint64_t* arow = a + s_off[0];
  const uint64_t* brow = b + s_off[1];
  const uint64_t qq = q[s_off[2]];
  const uint64_t qi = qinv[s_off[3]];
  const uint64_t cc = CHAINED ? c[s_off[4]] : 0;
  T xs, ys;                              // a column scalar, once per tile
  splat(xs, a_col ? 0 : arow[0]);
  splat(ys, b_col ? 0 : brow[0]);
  const T* ap = reinterpret_cast<const T*>(arow);
  const T* bp = reinterpret_cast<const T*>(brow);
  T* op = reinterpret_cast<T*>(out + (unsigned long long)row * n);
  const unsigned units = VEC ? n >> 1 : n;
  const unsigned u0 = blockIdx.x * (blockDim.x * V) + threadIdx.x;
  T x[V], y[V];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const unsigned u = u0 + i * blockDim.x;
    if (u < units) {
      x[i] = a_col ? load(ap + u) : xs;
      y[i] = b_col ? load(bp + u) : ys;
    }
  }
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const unsigned u = u0 + i * blockDim.x;
    if (u < units) op[u] = product<CHAINED>(x[i], y[i], cc, qq, qi);
  }
}

template <bool VEC, bool CHAINED>
int launch_v(const Launch& L, dim3 grid, cudaStream_t s, uint64_t* out,
             const uint64_t* a, const uint64_t* b, const uint64_t* q,
             const uint64_t* qinv, const uint64_t* c, const RowIndex& ix) {
  mont_mul_kernel<VEC, CHAINED><<<grid, L.threads, 0, s>>>(
      out, a, b, q, qinv, c, (unsigned)L.rows, (unsigned)L.n, L.a_col, L.b_col,
      ix);
  return (int)cudaGetLastError();
}

}  // namespace

// out = mont(a, b) or, with L->chained, mont(mont(a, b), c).  Returns
// cudaErrorInvalidValue for a description the kernel does not take.
extern "C" int optconv_mont_mul(void* out, const void* a, const void* b,
                                const void* q, const void* qinv, const void* c,
                                const Launch* L, void* stream) {
  RowIndex ix;
  if (!optconv::row_index(*L, kMaxThreads, kPerThread, &ix))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)L->gx, (unsigned)L->gy, (unsigned)L->gz);
  const cudaStream_t s = (cudaStream_t)stream;
  uint64_t* o = (uint64_t*)out;
  const uint64_t *pa = (const uint64_t*)a, *pb = (const uint64_t*)b,
                 *pq = (const uint64_t*)q, *pi = (const uint64_t*)qinv,
                 *pc = (const uint64_t*)c;
  if (L->vec)
    return L->chained ? launch_v<true, true>(*L, grid, s, o, pa, pb, pq, pi, pc, ix)
                      : launch_v<true, false>(*L, grid, s, o, pa, pb, pq, pi, pc, ix);
  return L->chained ? launch_v<false, true>(*L, grid, s, o, pa, pb, pq, pi, pc, ix)
                    : launch_v<false, false>(*L, grid, s, o, pa, pb, pq, pi, pc, ix);
}
