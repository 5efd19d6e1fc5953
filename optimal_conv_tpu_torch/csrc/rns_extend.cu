// The RNS basis extension of the key switch on Hopper: every digit of a
// ModUp (core/rns.py DigitExtender.extend_digits) or the mod-down's
// conversion of P to Q (BasisExtender.extend) in one launch.
//
// Replaces no Pallas kernel: in the JAX package optimal_conv_tpu/core/
// rns.py is a chain of jnp operations that XLA fuses into one or two
// kernels on the TPU.  Run eagerly in PyTorch the same chain is a gather,
// alpha + 1 Montgomery products, the float32 count's casts and adds, the
// add_mod and sub_mod chains and a table gather: about 52 launches, with
// [beta, alpha, N] and [beta, R, N] intermediates in device memory.
//
// For each output column, one thread, for one (lead index, digit,
// coefficient):
//   x_j      = in[gather_j]                        j < alpha, read in place
//   y_j      = x_j * qhat_j^-1 mod q_j             (Montgomery, as K1)
//   v        = floor(sum_j f32(y_j) * f32(1/q_j))  float32, clamped to [0, alpha]
//   out_r    = sum_j y_j * qhat_{j,r} - v*Q  mod r for every destination row r
// y and v stay in registers; no [beta, R, N] intermediate is written.
//
// v must equal core/rns._f32_count bit for bit: the sum runs j = 0, 1, ...
// with one rounding to float32 a step, each step
//   v = (float)((double)f32(y_j) * (double)f32(1/q_j) + (double)v)
// written with the _rn intrinsics, which are never contracted into a
// fused multiply-add; the int64 -> float32 conversion rounds to nearest.
//
// The residues are exact whatever the method, so they equal the plain
// chain's: each destination row sums its alpha products y_j * qhat_{j,r}
// (qhat in Montgomery form) as one 128-bit integer and reduces it with a
// single Montgomery REDC.  With q_j < 2^62 and alpha <= kMaxAlpha = 8 the
// sum is below 2^65 * r, so the REDC's result is below 3r: two
// conditional subtractions make it canonical.
//
// What bounds it on the card: its operations.  At the main shape, six
// digits into 33 rows at N = 2^16, a coefficient takes about 1020 modular
// products (alpha a digit for y, alpha * R for the rows) against 15 MB
// read and 104 MB written; at 0.984e12 products a second that is ~68 us
// against ~35 us for the bytes.  The 128-bit sum takes two 64-bit
// multiplies a product and one REDC a row, in place of a Montgomery
// product (four multiplies) and an add_mod for each.  The block's digit
// constants (q-hat as [alpha, R], v*Q as [R, alpha + 1], the destination
// q and q^-1, ~3.6 KB at R = 33, alpha = 5) sit in shared memory, read as
// broadcasts; the input rows are read once, the output written once,
// both coalesced along N.

#include <cstdint>
#include <cuda_runtime.h>

#include "modarith.cuh"

constexpr int kMaxAlpha = 8;       // core/rns_kernel.MAX_ALPHA
constexpr int kMaxRows = 64;       // core/rns_kernel.MAX_ROWS
constexpr int kThreads = 128;      // core/rns_kernel.THREADS

// The launch description; core/rns_kernel.py: Launch mirrors it.
struct OptconvRnsLaunch {
  long long n;             // columns
  long long lead;          // leading index count (the merged leading dims)
  long long lead_stride;   // input elements between leading indices
  long long row_stride;    // input elements between rows
  int alpha, beta, r;      // source limbs a digit, digits, destination rows
  int width;               // table words a digit
  int threads, gx, gy, gz;
};

namespace {

using Launch = OptconvRnsLaunch;

// One digit's table (core/rns_kernel.layout), int64 words:
//   [0, A)            gather: the input row of source limb j
//   [A, 2A)           q_j
//   [2A, 3A)          -q_j^-1 mod 2^64
//   [3A, 4A)          (Q/q_j)^-1 * 2^64 mod q_j
//   [4A, 5A)          the bits of f32(1/q_j)
//   [5A, 5A + A*R)    (Q/q_j) * 2^64 mod r_i, j-major
//   then R*(A+1)      v*Q mod r_i, row-major
//   then R, R         r_i and -r_i^-1 mod 2^64
// Padded limbs of a ragged digit hold q = 1 and zero constants: their
// y is 0 and they add exactly nothing.
struct Params {
  const uint64_t* in;
  uint64_t* out;
  const uint64_t* table;
  long long lead_stride, row_stride;
  unsigned n, items, beta, r, width;
};

template <int A>
__global__ void __launch_bounds__(kThreads)
rns_extend_kernel(Params p) {
  extern __shared__ uint64_t s[];
  const unsigned item = blockIdx.z * gridDim.y + blockIdx.y;  // lead*beta + digit
  if (item >= p.items) return;           // the whole block, before the barrier
  const unsigned lead = item / p.beta;
  const unsigned digit = item - lead * p.beta;
  const uint64_t* tab = p.table + (unsigned long long)digit * p.width;
  for (unsigned i = threadIdx.x; i < p.width; i += blockDim.x) s[i] = tab[i];
  __syncthreads();
  const unsigned col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= p.n) return;
  const unsigned R = p.r;
  const uint64_t* s_qhat = s + 5 * A;
  const uint64_t* s_vq = s_qhat + A * R;
  const uint64_t* s_rq = s_vq + R * (A + 1);
  const uint64_t* s_rqinv = s_rq + R;
  const uint64_t* src = p.in + (long long)lead * p.lead_stride + col;

  uint64_t x[A];
#pragma unroll
  for (int j = 0; j < A; ++j)
    x[j] = __ldg(reinterpret_cast<const unsigned long long*>(
        src + (long long)s[j] * p.row_stride));
  uint64_t y[A];
  float v = 0.0f;
#pragma unroll
  for (int j = 0; j < A; ++j) {
    y[j] = optconv::mont_mul(x[j], s[3 * A + j], s[A + j], s[2 * A + j]);
    const double yf = (double)__ll2float_rn((long long)y[j]);
    const double inv = (double)__uint_as_float((unsigned)s[4 * A + j]);
    v = __double2float_rn(__dadd_rn(__dmul_rn(yf, inv), (double)v));
  }
  int vi = (int)floorf(v);
  vi = vi < 0 ? 0 : (vi > A ? A : vi);

  uint64_t* dst = p.out + (unsigned long long)item * R * p.n + col;
#pragma unroll 2
  for (unsigned i = 0; i < R; ++i) {
    uint64_t lo = 0, hi = 0;
#pragma unroll
    for (int j = 0; j < A; ++j) {
      const uint64_t b = s_qhat[j * R + i];
      const uint64_t pl = y[j] * b;
      lo += pl;
      hi += __umul64hi(y[j], b) + (lo < pl ? 1ull : 0ull);
    }
    const uint64_t q = s_rq[i];
    const uint64_t m = lo * s_rqinv[i];
    uint64_t acc = hi + __umul64hi(m, q) + (lo != 0 ? 1ull : 0ull);  // < 3q
    acc = optconv::cond_sub(optconv::cond_sub(acc, q + q), q);
    const uint64_t vq = s_vq[i * (A + 1) + vi];
    dst[(unsigned long long)i * p.n] = acc >= vq ? acc - vq : acc + q - vq;
  }
}

template <int A>
int launch_a(const Launch& L, const Params& p, cudaStream_t s) {
  const dim3 grid((unsigned)L.gx, (unsigned)L.gy, (unsigned)L.gz);
  rns_extend_kernel<A><<<grid, L.threads, L.width * sizeof(uint64_t), s>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// out[lead, digit, r, :] = the extension of digit `digit` of in[lead] to
// row r.  Returns cudaErrorInvalidValue for a description the kernel
// does not take.
extern "C" int optconv_rns_extend(void* out, const void* in, const void* table,
                                  const Launch* L, void* stream) {
  const long long lim = 1ll << 31;
  const long long items = L->lead * L->beta;
  if (L->alpha < 1 || L->alpha > kMaxAlpha || L->r < 1 || L->r > kMaxRows ||
      L->beta < 1 || L->lead < 1 || L->lead >= lim || L->n < 1 ||
      L->n >= lim || items >= lim || items * L->r > (1ll << 62) / L->n ||
      L->width != 5 * L->alpha + L->r * (2 * L->alpha + 3) ||
      L->threads != kThreads || L->gx < 1 || L->gy < 1 || L->gy > 65535 ||
      L->gz < 1 || L->gz > 65535 || (long long)L->gy * L->gz < items ||
      (long long)L->gx * L->threads < L->n)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.in = (const uint64_t*)in;
  p.out = (uint64_t*)out;
  p.table = (const uint64_t*)table;
  p.lead_stride = L->lead_stride;
  p.row_stride = L->row_stride;
  p.n = (unsigned)L->n;
  p.items = (unsigned)items;
  p.beta = (unsigned)L->beta;
  p.r = (unsigned)L->r;
  p.width = (unsigned)L->width;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (L->alpha) {
    case 1: return launch_a<1>(*L, p, s);
    case 2: return launch_a<2>(*L, p, s);
    case 3: return launch_a<3>(*L, p, s);
    case 4: return launch_a<4>(*L, p, s);
    case 5: return launch_a<5>(*L, p, s);
    case 6: return launch_a<6>(*L, p, s);
    case 7: return launch_a<7>(*L, p, s);
    default: return launch_a<8>(*L, p, s);
  }
}
