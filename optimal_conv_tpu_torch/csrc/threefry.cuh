// Threefry-2x32 and the seed-expanded uniform residue of a switching key,
// shared by csrc/d1_regen.cu and the instruction probe of
// optimal_conv_tpu_torch/utils/kernel_info.py.  The bits are JAX's
// (jax.random.bits with jax_threefry_partitionable): word f of the
// flattened shape is x0 ^ x1 of threefry2x32((k0, k1), (f >> 32, f)).
// optimal_conv_tpu_torch/core/threefry.py is the plain version.
#pragma once

#include <cstdint>

#include "modarith.cuh"

namespace optconv {

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

// Four rounds of Threefry-2x32 with rotations a, b, c, d.
__device__ __forceinline__ void threefry_rounds(uint32_t& x0, uint32_t& x1,
                                                int a, int b, int c, int d) {
  x0 += x1; x1 = rotl32(x1, a) ^ x0;
  x0 += x1; x1 = rotl32(x1, b) ^ x0;
  x0 += x1; x1 = rotl32(x1, c) ^ x0;
  x0 += x1; x1 = rotl32(x1, d) ^ x0;
}

// The 32-bit word at flat counter f under the key (k0, k1): twenty
// rounds, five key injections, as jax._src.prng._threefry2x32_lowering.
__device__ __forceinline__ uint32_t threefry_word(uint32_t k0, uint32_t k1,
                                                  uint64_t f) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  uint32_t x0 = (uint32_t)(f >> 32) + k0;
  uint32_t x1 = (uint32_t)f + k1;
  threefry_rounds(x0, x1, 13, 15, 26, 6);
  x0 += k1; x1 += k2 + 1u;
  threefry_rounds(x0, x1, 17, 29, 16, 24);
  x0 += k2; x1 += k0 + 2u;
  threefry_rounds(x0, x1, 13, 15, 26, 6);
  x0 += k0; x1 += k1 + 3u;
  threefry_rounds(x0, x1, 17, 29, 16, 24);
  x0 += k1; x1 += k2 + 4u;
  threefry_rounds(x0, x1, 13, 15, 26, 6);
  x0 += k2; x1 += k0 + 5u;
  return x0 ^ x1;
}

// One residue of the key's uniform half: the words at counters f,
// f + plane, f + 2 plane, f + 3 plane (the four planes of the JAX draw)
// make hi = w0:w1 and lo = w2:w3, and (hi 2^64 + lo) mod q is
// mont(hi, r2) + mont(lo, r1) mod q.  mont_mul is exact for any 64-bit
// first operand when the second is below q.
__device__ __forceinline__ uint64_t uniform_residue(uint32_t k1, uint64_t f,
                                                    uint64_t plane, uint64_t q,
                                                    uint64_t qinv, uint64_t r2,
                                                    uint64_t r1) {
  uint32_t w[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) w[k] = threefry_word(0u, k1, f + k * plane);
  const uint64_t hi = ((uint64_t)w[0] << 32) | w[1];
  const uint64_t lo = ((uint64_t)w[2] << 32) | w[3];
  return cond_sub(mont_mul(hi, r2, q, qinv) + mont_mul(lo, r1, q, qinv), q);
}

}  // namespace optconv
