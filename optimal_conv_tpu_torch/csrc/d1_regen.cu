// The public half d1 of a seed-compressed switching key, regenerated on
// the card: [beta, |qp|, N] uniform residues from a 32-bit seed, read as
// the Montgomery form of the key's uniform half, optionally gathered by
// the NTT-domain permutation of a pre-permuted hoisting key.
//
// Replaces optimal_conv_tpu/ckks/context.py: _d1_regen_builder (and
// _uniform_mont_jax).  On the TPU that is not a Pallas kernel but an XLA
// composite of jax.random.bits (threefry), two Montgomery products, an
// add and, for a "galh" key, a gather.  Here it is one pass: each thread
// owns one coefficient i, reads perm[i] once, and for each of its rows
// runs Threefry-2x32 at the four counters of element perm[i] (the gather
// costs nothing: a permuted element is simply drawn at another counter),
// folds the four words into one residue and stores it.
//
// What bounds it on the card: integer operations.  A residue is four
// Threefry-2x32 evaluations (20 rounds of add, rotate, xor and five key
// injections each) and two Montgomery products, some 400 integer
// instructions, against one 8-byte store; the H100 does about 5000
// integer instructions per byte of device memory it writes.  So the
// design spends nothing on memory: no input but eight bytes of table a
// row and perm[i] once a thread, each store coalesced (neighbouring
// threads, neighbouring coefficients).  A block covers `rows_per_block`
// rows of blockDim.x coefficients; the wrapper (core/d1_kernel.py) takes
// fewer rows a block for a small key, so that even the one-digit keys of
// level 0 ([1, 6, N]) fill the card with blocks.
//
// A rank of a limb-sharded context holds only some limbs of each key: it
// draws the rows `row_ids` (global limb rows of a key with nqp_g limbs a
// digit) at their counters in the whole key, so that its rows equal the
// whole draw's bit for bit and no rank draws another's.

#include <cstdint>
#include <cuda_runtime.h>

#include "modarith.cuh"
#include "threefry.cuh"

namespace {

constexpr int kMaxThreads = 256;

__device__ __forceinline__ uint64_t ld(const uint64_t* p) {
  return __ldg(reinterpret_cast<const unsigned long long*>(p));
}

__global__ void __launch_bounds__(kMaxThreads)
d1_regen_kernel(uint64_t* __restrict__ out, const uint64_t* __restrict__ q,
                const uint64_t* __restrict__ qinv,
                const uint64_t* __restrict__ r2,
                const uint64_t* __restrict__ r1,
                const long long* __restrict__ perm,
                const long long* __restrict__ row_ids, uint32_t key,
                unsigned nqp, unsigned nqp_g, unsigned rows, unsigned n,
                unsigned rows_per_block) {
  const unsigned i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const uint64_t col = perm ? (uint64_t)__ldg(perm + i) : (uint64_t)i;
  // the four words of a residue lie a plane apart in the whole key
  const uint64_t plane = (uint64_t)(rows / nqp) * nqp_g * n;
  const unsigned r0 = blockIdx.y * rows_per_block;
  const unsigned r_end = min(rows, r0 + rows_per_block);
  unsigned j = r0 % nqp, d = r0 / nqp;
  for (unsigned r = r0; r < r_end; ++r) {
    const uint64_t g =
        (uint64_t)d * nqp_g + (row_ids ? (uint64_t)__ldg(row_ids + j) : j);
    out[(uint64_t)r * n + i] = optconv::uniform_residue(
        key, g * n + col, plane, ld(q + j), ld(qinv + j), ld(r2 + j),
        ld(r1 + j));
    if (++j == nqp) {
      j = 0;
      ++d;
    }
  }
}

}  // namespace

// out [beta, nqp, n] = the uniform residues of `key` (the low word of the
// seed); q, qinv, r2, r1 hold nqp limbs each; perm is null or n int64
// indices in [0, n); row_ids is null (the whole key, nqp_g == nqp) or nqp
// int64 rows in [0, nqp_g) of a key of nqp_g limbs a digit.  Returns
// cudaErrorInvalidValue for a shape the kernel does not take, else
// cudaGetLastError() after the launch.
extern "C" int optconv_d1_regen(void* out, const void* q, const void* qinv,
                                const void* r2, const void* r1,
                                const void* perm, const void* row_ids,
                                unsigned key, int beta, int nqp, int nqp_g,
                                long long n, int threads, int rows_per_block,
                                void* stream) {
  const long long rows = (long long)beta * nqp;
  if (beta < 1 || nqp < 1 || nqp_g < nqp || (!row_ids && nqp_g != nqp) ||
      n < 1 || n >= (1ll << 31) || (long long)beta * nqp_g >= (1ll << 31) ||
      threads < 32 || threads > kMaxThreads || (threads & 31) ||
      rows_per_block < 1)
    return (int)cudaErrorInvalidValue;
  const long long gx = (n + threads - 1) / threads;
  const long long gy = (rows + rows_per_block - 1) / rows_per_block;
  if (gx >= (1ll << 31) || gy > 65535) return (int)cudaErrorInvalidValue;
  d1_regen_kernel<<<dim3((unsigned)gx, (unsigned)gy), threads, 0,
                    (cudaStream_t)stream>>>(
      (uint64_t*)out, (const uint64_t*)q, (const uint64_t*)qinv,
      (const uint64_t*)r2, (const uint64_t*)r1, (const long long*)perm,
      (const long long*)row_ids, (uint32_t)key, (unsigned)nqp,
      (unsigned)nqp_g, (unsigned)rows, (unsigned)n, (unsigned)rows_per_block);
  return (int)cudaGetLastError();
}
