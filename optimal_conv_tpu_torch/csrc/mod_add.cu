// The port's additive modular arithmetic on Hopper, each operation one pass:
//   add      a + b mod q
//   sub      a - b mod q
//   neg      -a mod q
//   sum      sum_{i<k} a[i*step] mod q, reduced after every addition
//   centred  a - c mod q where b > half, else a: the correction a rescale
//            and ModRaise apply to a top limb's residues where its
//            coefficient b is above q_top / 2.
// q and c are constant along a row; a and b may be rows or per-row
// scalars.  Every residue is canonical, in [0, q), and q < 2^62, so a sum
// of two never wraps and each result is the unique canonical residue the
// plain versions (optimal_conv_tpu_torch/core/modmath.py: add_mod_plain,
// sub_mod_plain, neg_mod_plain, sum_mod_plain, centred_sub_plain) give.
//
// Replaces no TPU kernel: on the TPU, XLA fuses
// optimal_conv_tpu/core/modmath.py's jnp.where chains into one pass; under
// PyTorch each step of a chain (add, compare, subtract, where) is a launch
// of its own that reads and writes whole int64 tensors, 50-106 B an
// element where one pass needs 16-24 B, and the compares against a [L, 1]
// column of moduli take PyTorch's non-vectorised broadcast path.
//
// What bounds it on the card: device-memory bytes.  A few integer
// instructions an element against 16-24 B (a sum of k terms: (k + 1) * 8
// B).  The design is mont_mul.cu's (K1's), and the row geometry its
// (row_index.cuh): every operand described by row strides (a stride of 0
// is a broadcast row dim, so a column of moduli or a top limb shared by
// every row is read in place), one block one tile of one row, thread 0
// turning the row into the operands' offsets, 16-byte vector accesses
// (two elements) where the operands are aligned, 8-byte accesses
// otherwise.  A sum reads its k terms in the
// same pass and writes once; its loads do not depend on the running sum,
// so the loop is unrolled to keep several terms in flight.  The wrapper's
// plan (core/mod_add_kernel.py) chooses the access width, the block size
// and the grid and passes them as integers.

#include <cstdint>
#include <cuda_runtime.h>

#include "modarith.cuh"
#include "row_index.cuh"

constexpr int kMaxDims = optconv::kRowDims;
constexpr int kOps = 4;            // a, b, q, c
constexpr int kMaxThreads = 256;
constexpr int kPerThread = 2;      // units a thread; mod_add_kernel.PER_THREAD

// The operation codes; core/mod_add_kernel.py: OPS lists them in order.
enum Op : int { kAdd = 0, kSub = 1, kNeg = 2, kSum = 3, kCentred = 4 };

// The launch description; core/mod_add_kernel.py: Launch mirrors it.
struct OptconvModAddLaunch {
  long long n;                          // row length
  long long rows;                       // product of size[0..nd)
  long long size[kMaxDims];             // merged row dims, outermost first
  long long stride[kOps][kMaxDims];     // element strides, 0 = broadcast
  long long step;                       // sum: element stride between terms
  unsigned long long half;              // centred: the threshold on b
  int nd, op, k, a_col, b_col, vec, threads;
  int gx, gy, gz;
};

namespace {

using Launch = OptconvModAddLaunch;
using RowIndex = optconv::RowIndex<kOps>;
using optconv::load;
using optconv::splat;

// x - y mod q for x, y in [0, q): the wrapped difference, q added back
// where it went below 0.
__device__ __forceinline__ uint64_t sub_mod(uint64_t x, uint64_t y,
                                            uint64_t q) {
  const uint64_t d = x - y;
  return x >= y ? d : d + q;
}

// One element of the elementwise forms (not kSum).
template <int OP>
__device__ __forceinline__ uint64_t apply(uint64_t x, uint64_t y, uint64_t q,
                                          uint64_t c, uint64_t half) {
  if (OP == kAdd) return optconv::cond_sub(x + y, q);
  if (OP == kSub) return sub_mod(x, y, q);
  if (OP == kNeg) return x == 0 ? 0 : q - x;
  return y > half ? sub_mod(x, c, q) : x;          // kCentred
}
template <int OP>
__device__ __forceinline__ ulonglong2 apply(ulonglong2 x, ulonglong2 y,
                                            uint64_t q, uint64_t c,
                                            uint64_t half) {
  ulonglong2 r;
  r.x = apply<OP>((uint64_t)x.x, (uint64_t)y.x, q, c, half);
  r.y = apply<OP>((uint64_t)x.y, (uint64_t)y.y, q, c, half);
  return r;
}

__device__ __forceinline__ uint64_t add_mod(uint64_t x, uint64_t y,
                                            uint64_t q) {
  return optconv::cond_sub(x + y, q);
}
__device__ __forceinline__ ulonglong2 add_mod(ulonglong2 x, ulonglong2 y,
                                              uint64_t q) {
  ulonglong2 r;
  r.x = add_mod((uint64_t)x.x, (uint64_t)y.x, q);
  r.y = add_mod((uint64_t)x.y, (uint64_t)y.y, q);
  return r;
}

// One block: one tile of blockDim.x * kPerThread units (vectors of two
// elements if VEC, else elements) of one row.
template <int OP, bool VEC>
__global__ void __launch_bounds__(kMaxThreads)
mod_add_kernel(uint64_t* __restrict__ out, const uint64_t* __restrict__ a,
               const uint64_t* __restrict__ b, const uint64_t* __restrict__ q,
               const uint64_t* __restrict__ c, unsigned rows, unsigned n,
               int a_col, int b_col, int k, long long step, uint64_t half,
               RowIndex ix) {
  constexpr int V = kPerThread;
  constexpr bool kHasB = OP == kAdd || OP == kSub || OP == kCentred;
  using T = typename optconv::Unit<VEC>::type;
  __shared__ long long s_off[kOps];
  const unsigned row = blockIdx.z * gridDim.y + blockIdx.y;
  if (row >= rows) return;               // the whole block, before the barrier
  if (threadIdx.x == 0) optconv::row_offsets(ix, row, s_off);
  __syncthreads();
  const uint64_t* arow = a + s_off[0];
  const uint64_t* brow = b + s_off[1];
  const uint64_t qq = q[s_off[2]];
  const uint64_t cc = OP == kCentred ? c[s_off[3]] : 0;
  T* op = reinterpret_cast<T*>(out + (unsigned long long)row * n);
  const unsigned units = VEC ? n >> 1 : n;
  const unsigned u0 = blockIdx.x * (blockDim.x * V) + threadIdx.x;
  T x[V];
  T xs;                                  // a column scalar, once per tile
  splat(xs, a_col ? 0 : arow[0]);
  const T* ap = reinterpret_cast<const T*>(arow);
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const unsigned u = u0 + i * blockDim.x;
    if (u < units) x[i] = a_col ? load(ap + u) : xs;
  }
  if (OP == kSum) {
    // term t of the sum starts t * step elements after term 0
#pragma unroll 4
    for (int t = 1; t < k; ++t) {
      const uint64_t* trow = arow + (long long)t * step;
      const T* tp = reinterpret_cast<const T*>(trow);
      T ts;
      splat(ts, a_col ? 0 : trow[0]);
      T y[V];
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const unsigned u = u0 + i * blockDim.x;
        if (u < units) y[i] = a_col ? load(tp + u) : ts;
      }
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const unsigned u = u0 + i * blockDim.x;
        if (u < units) x[i] = add_mod(x[i], y[i], qq);
      }
    }
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const unsigned u = u0 + i * blockDim.x;
      if (u < units) op[u] = x[i];
    }
    return;
  }
  T y[V];
  if (kHasB) {
    T ys;
    splat(ys, b_col ? 0 : brow[0]);
    const T* bp = reinterpret_cast<const T*>(brow);
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const unsigned u = u0 + i * blockDim.x;
      if (u < units) y[i] = b_col ? load(bp + u) : ys;
    }
  }
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const unsigned u = u0 + i * blockDim.x;
    if (u < units) op[u] = apply<OP>(x[i], kHasB ? y[i] : x[i], qq, cc, half);
  }
}

template <int OP, bool VEC>
int launch_v(const Launch& L, dim3 grid, cudaStream_t s, uint64_t* out,
             const uint64_t* a, const uint64_t* b, const uint64_t* q,
             const uint64_t* c, const RowIndex& ix) {
  mod_add_kernel<OP, VEC><<<grid, L.threads, 0, s>>>(
      out, a, b, q, c, (unsigned)L.rows, (unsigned)L.n, L.a_col, L.b_col, L.k,
      L.step, (uint64_t)L.half, ix);
  return (int)cudaGetLastError();
}

template <bool VEC>
int launch_op(const Launch& L, dim3 grid, cudaStream_t s, uint64_t* out,
              const uint64_t* a, const uint64_t* b, const uint64_t* q,
              const uint64_t* c, const RowIndex& ix) {
  switch (L.op) {
    case kAdd: return launch_v<kAdd, VEC>(L, grid, s, out, a, b, q, c, ix);
    case kSub: return launch_v<kSub, VEC>(L, grid, s, out, a, b, q, c, ix);
    case kNeg: return launch_v<kNeg, VEC>(L, grid, s, out, a, b, q, c, ix);
    case kSum: return launch_v<kSum, VEC>(L, grid, s, out, a, b, q, c, ix);
    default: return launch_v<kCentred, VEC>(L, grid, s, out, a, b, q, c, ix);
  }
}

}  // namespace

// out = the operation L->op of a, b, q, c.  Returns cudaErrorInvalidValue
// for a description the kernel does not take.
extern "C" int optconv_mod_add(void* out, const void* a, const void* b,
                               const void* q, const void* c, const Launch* L,
                               void* stream) {
  RowIndex ix;
  if (L->op < kAdd || L->op > kCentred || (L->op == kSum && L->k < 1) ||
      (L->vec && L->op == kSum && (L->step & 1)) ||
      !optconv::row_index(*L, kMaxThreads, kPerThread, &ix))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)L->gx, (unsigned)L->gy, (unsigned)L->gz);
  const cudaStream_t s = (cudaStream_t)stream;
  uint64_t* o = (uint64_t*)out;
  const uint64_t *pa = (const uint64_t*)a, *pb = (const uint64_t*)b,
                 *pq = (const uint64_t*)q, *pc = (const uint64_t*)c;
  return L->vec ? launch_op<true>(*L, grid, s, o, pa, pb, pq, pc, ix)
                : launch_op<false>(*L, grid, s, o, pa, pb, pq, pc, ix);
}
