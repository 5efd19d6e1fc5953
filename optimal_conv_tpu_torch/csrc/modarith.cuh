// Modular arithmetic on uint64 residues (q < 2^62), shared by the port's
// kernels.  mont_mul is the operation of
// optimal_conv_tpu_torch/core/modmath.py and returns the unique canonical
// residue, so results agree bit for bit.  The butterflies keep their
// values lazily reduced (below 4q or 2q) between stages; a transform
// canonicalises once at its end, and every canonical result is the same
// residue the canonical arithmetic gives.
#pragma once

#include <cstdint>

namespace optconv {

// a*b*2^-64 mod q without the last conditional subtraction: congruent
// to the product and in [0, 2q) for a < 4q, b < q.  b is in Montgomery
// form, qinv = -q^-1 mod 2^64.
__device__ __forceinline__ uint64_t mont_mul_lazy(uint64_t a, uint64_t b,
                                                  uint64_t q, uint64_t qinv) {
  const uint64_t lo = a * b;
  const uint64_t hi = __umul64hi(a, b);
  const uint64_t m = lo * qinv;
  return hi + __umul64hi(m, q) + (lo != 0 ? 1ull : 0ull);
}

// x - m if x >= m: one step of a lazy reduction.
__device__ __forceinline__ uint64_t cond_sub(uint64_t x, uint64_t m) {
  return x >= m ? x - m : x;
}

// a*b*2^-64 mod q in [0, q), for a < 4q, b < q.
__device__ __forceinline__ uint64_t mont_mul(uint64_t a, uint64_t b,
                                             uint64_t q, uint64_t qinv) {
  return cond_sub(mont_mul_lazy(a, b, q, qinv), q);
}

// Forward (Cooley-Tukey) butterfly, Harvey's lazy form: x0, x1 in
// [0, 4q) in and out; (x0, x1) <- (x0 + w*x1, x0 - w*x1).  q2 = 2q.
__device__ __forceinline__ void ct_butterfly(uint64_t& x0, uint64_t& x1,
                                             uint64_t w, uint64_t q,
                                             uint64_t q2, uint64_t qinv) {
  const uint64_t a = cond_sub(x0, q2);
  const uint64_t b = mont_mul_lazy(x1, w, q, qinv);
  x0 = a + b;
  x1 = a - b + q2;
}

// Inverse (Gentleman-Sande) butterfly: x0, x1 in [0, 2q) in and out;
// (x0, x1) <- (x0 + x1, w*(x0 - x1)).
__device__ __forceinline__ void gs_butterfly(uint64_t& x0, uint64_t& x1,
                                             uint64_t w, uint64_t q,
                                             uint64_t q2, uint64_t qinv) {
  const uint64_t a = x0, b = x1;
  x0 = cond_sub(a + b, q2);
  x1 = mont_mul_lazy(a - b + q2, w, q, qinv);
}

}  // namespace optconv
