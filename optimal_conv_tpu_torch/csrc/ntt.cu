// K2/K3 on Hopper: negacyclic NTT (forward) and its inverse over rows.
//
// Replaces optimal_conv_tpu/core/pallas_ntt.py: _fwd_kernel (K2) and
// _inv_kernel (K3), built by _pallas_transform and driven by transform.
// The same butterfly network as the JAX package's in-place transforms
// (core/ntt.py _ntt_fwd/_ntt_inv): forward Cooley-Tukey with the psi
// twist merged into the twiddles, natural order in, bit-reversed out;
// inverse Gentleman-Sande, bit-reversed in, natural out, times n^-1.
// Every butterfly is exact modular arithmetic and reads the twiddle
// psi_br[m + blk] of the in-place network, so the output is bit for bit
// that network's whatever the schedule.
//
// Layout: in is [rows, n] uint64 read through (batch, limb) strides, out
// is [rows, n] contiguous.  Each row carries its global limb index
// (row_limb, int32), which selects q, qinv, the row of the [L, n]
// Montgomery twiddle table and n^-1.
//
// What bounds it on the card: the integer pipe.  A transform is log n
// stages of n/2 butterflies; one butterfly compiles to 39 (forward) or
// 35 (inverse) 32-bit integer instructions, most of them the multiply-
// adds of a 64-bit Montgomery product.  At [128,1,6,N], N = 2^16, that
// is about 0.9 ms at 64 lanes per SM per clock on an H100, against
// 0.24 ms for the bytes (each element read once and written once).  The
// design first removes the device-memory traffic that a 512 KB ring does
// not force (the earlier kernel made seven passes and was memory bound),
// then trims the arithmetic:
//
//   * One transform is at most two launches, each one pass.  A pass
//     runs a group of consecutive stages on a tile held in shared
//     memory.  Write the index as i = hi * 2^b + lo.  The stages with
//     span >= 2^b pair elements that differ only in hi: for a fixed lo
//     they are a 2^a-point transform down a column of stride 2^b, with
//     the twiddles psi_br[1 .. 2^a).  A block of the column pass takes W
//     neighbouring columns (W * 8 B contiguous per tile row).  The stages
//     with span < 2^b stay inside contiguous 2^b-element chunks; chunk c
//     is a 2^b-point transform whose stage s' reads
//     psi_br[((2^a + c) << s') + block].  Both are the same
//     sub-transform with a different "root" index (1 for columns,
//     2^a + c for chunks), so one kernel serves both.
//   * Rings up to 2^14 (128 KB) fit one block: one launch, a = 0.
//     Above, b = 8: forward = column pass (in -> out) then chunk pass
//     (in place); inverse = chunk pass (in -> out) then column pass.
//   * Inside a pass a thread holds 2^R elements in registers (R = 3,
//     the first round R = k mod 3 when that is not 0) and does R stages
//     between two exchanges through shared memory: 8 stages are three
//     rounds and two __syncthreads().  The first round loads straight
//     from device memory and the last stores straight to it wherever
//     those accesses coalesce.  Twiddles are read where they are used,
//     through the read-only cache: a column pass reads the same 2^a - 1
//     in every block, and the short spans of a chunk use each only once.
//   * The tile is stored swizzled, phys = L ^ ((L >> 3) & 15), which
//     puts the 16 64-bit accesses of a half-warp on distinct bank pairs
//     for every radix-8 round, at every span down to 1.
//   * Lazy reduction (Harvey): forward values stay in [0, 4q), inverse
//     values in [0, 2q) between stages, across both passes; q < 2^62
//     leaves the room.  The last round of the last pass stores canonical
//     residues, the same ones the canonical arithmetic gives.
//   * n^-1 is folded into the last inverse stage: s*ninv and
//     d*(w*ninv), two products per butterfly instead of three.
//
// The pass split, tile width, threads, shared-memory bytes and grid are
// worked out by core/ntt_kernel.plan and arrive here as plain integers;
// this file validates them and launches.

#include <cstdint>
#include <cuda_runtime.h>

#include "modarith.cuh"

namespace {

constexpr int kMaxLogN = 17;
constexpr int kMaxThreads = 512;
constexpr int kMaxSmem = 232448;  // 227 KB, the most a block can have

using optconv::cond_sub;
using optconv::ct_butterfly;
using optconv::gs_butterfly;
using optconv::mont_mul;

// Geometry of one pass, the same for every block.
struct Tile {
  int k;           // log2 points of a sub-transform
  int tile_log;    // log2 elements of the tile
  int p0;          // bit of the tile index L where the point index starts
  int gw;          // L's low gw bits are contiguous in device memory
  int log_stride;  // log2 element stride of L >> gw in device memory
  int root0;       // root index of the tile's first sub-transform
};

__device__ __forceinline__ int swz(int L) { return L ^ ((L >> 3) & 15); }

__device__ __forceinline__ long long goff(const Tile& t, int L) {
  return ((long long)(L >> t.gw) << t.log_stride) + (L & ((1 << t.gw) - 1));
}

// R consecutive stages (local stages s0 .. s0+R-1 of the k-stage
// sub-transform) on every group of 2^R elements of the tile.  Group g
// holds the tile indices that differ in bits P .. P+R-1, P = p0 + p,
// p = k - s0 - R.  Stage s0+u of the group reads the twiddles
// tw[(Rr << u) + jh], jh < 2^u, where Rr = (root << s0) + (e >> (p + R))
// and e is the point index: that is psi_br[m + blk] of the whole ring.
template <int R, bool INV>
__device__ __forceinline__ void radix_round(
    const Tile& t, const uint64_t* src, uint64_t* dst, uint64_t* sm,
    bool from_g, bool to_g, const uint64_t* __restrict__ tw, uint64_t q,
    uint64_t qi, uint64_t ni, bool fold, bool canon, int s0) {
  const uint64_t q2 = q + q;
  const int p = t.k - s0 - R;
  const int P = t.p0 + p;
  const int groups = 1 << (t.tile_log - R);
  for (int g = threadIdx.x; g < groups; g += blockDim.x) {
    const int Lb = (g & ((1 << P) - 1)) | ((g >> P) << (P + R));
    const int e = (Lb >> t.p0) & ((1 << t.k) - 1);
    const int root = t.root0 + (t.p0 == 0 ? (Lb >> t.k) : 0);
    const int Rr = (root << s0) + (e >> (p + R));
    uint64_t x[1 << R];
#pragma unroll
    for (int j = 0; j < (1 << R); ++j) {
      const int L = Lb | (j << P);
      x[j] = from_g ? src[goff(t, L)] : sm[swz(L)];
    }
#pragma unroll
    for (int uu = 0; uu < R; ++uu) {
      const int u = INV ? R - 1 - uu : uu;
      const int span = 1 << (R - 1 - u);
#pragma unroll
      for (int jh = 0; jh < (1 << u); ++jh) {
        uint64_t w = __ldg(tw + ((Rr << u) + jh));
        const bool scale = INV && fold && u == 0;
        if (scale) w = mont_mul(w, ni, q, qi);
#pragma unroll
        for (int jl = 0; jl < span; ++jl) {
          const int j0 = jh * 2 * span + jl;
          if (!INV) {
            ct_butterfly(x[j0], x[j0 + span], w, q, q2, qi);
          } else if (scale) {            // the last stage: canonical out
            const uint64_t a = x[j0], b = x[j0 + span];
            x[j0] = mont_mul(a + b, ni, q, qi);
            x[j0 + span] = mont_mul(a - b + q2, w, q, qi);
          } else {
            gs_butterfly(x[j0], x[j0 + span], w, q, q2, qi);
          }
        }
      }
    }
    if (!INV && canon) {
#pragma unroll
      for (int j = 0; j < (1 << R); ++j) x[j] = cond_sub(cond_sub(x[j], q2), q);
    }
#pragma unroll
    for (int j = 0; j < (1 << R); ++j) {
      const int L = Lb | (j << P);
      if (to_g) dst[goff(t, L)] = x[j];
      else sm[swz(L)] = x[j];
    }
  }
}

// One pass: blockIdx.x = row * tiles_per_row + tile.  log_stride > 0 is
// a column pass (k + log_stride == log_n, 2^log_w columns a tile),
// log_stride == 0 a chunk pass (2^log_w chunks of 2^k a tile).
template <bool INV>
__global__ void __launch_bounds__(kMaxThreads)
ntt_pass(const uint64_t* in, uint64_t* out, const int* __restrict__ row_limb,
         const uint64_t* __restrict__ q_, const uint64_t* __restrict__ qinv_,
         const uint64_t* __restrict__ tw_, const uint64_t* __restrict__ ninv_,
         long long l, long long in_bs, long long in_ls, int log_n, int k,
         int log_stride, int log_w, int final_pass) {
  extern __shared__ uint64_t sm[];
  const bool col = log_stride > 0;
  Tile t;
  t.k = k;
  t.tile_log = k + log_w;
  t.p0 = col ? log_w : 0;
  t.gw = col ? log_w : t.tile_log;
  t.log_stride = log_stride;
  const int log_tpr = log_n - t.tile_log;
  const long long row = (long long)blockIdx.x >> log_tpr;
  const int tile = (int)(blockIdx.x & ((1u << log_tpr) - 1u));
  t.root0 = col ? 1 : (1 << (log_n - k)) + (tile << log_w);
  const long long base = col ? ((long long)tile << log_w)
                             : ((long long)tile << t.tile_log);
  const uint64_t* src = in + (row / l) * in_bs + (row % l) * in_ls + base;
  uint64_t* dst = out + (row << log_n) + base;
  const int limb = row_limb[row];
  const uint64_t q = q_[limb], qi = qinv_[limb], ni = ninv_[limb];
  const uint64_t* tw = tw_ + ((long long)limb << log_n);
  const int n_tile = 1 << t.tile_log;

  // Stage groups: the first has k mod 3 stages (3 if that is 0), the
  // others 3.  Forward walks them first to last, the inverse last to
  // first, so the short round always has the longest span.
  const int r_first = k % 3 ? k % 3 : (k < 3 ? k : 3);
  const int rounds = (k + 2) / 3;
  for (int i = 0; i < rounds; ++i) {
    const int grp = INV ? rounds - 1 - i : i;
    const int R = grp == 0 ? r_first : 3;
    const int s0 = grp == 0 ? 0 : r_first + 3 * (grp - 1);
    const int p = k - s0 - R;
    const bool direct = col || p >= 2;   // device-memory access coalesces
    const bool first = i == 0, last = i == rounds - 1;
    if (first && !direct) {
      for (int L = threadIdx.x; L < n_tile; L += blockDim.x)
        sm[swz(L)] = src[goff(t, L)];
      __syncthreads();
    }
    const bool from_g = first && direct, to_g = last && direct;
    const bool fd = final_pass && s0 == 0;   // n^-1 goes into stage 0
    const bool cn = final_pass && last;      // canonical residues out
    if (R == 3)
      radix_round<3, INV>(t, src, dst, sm, from_g, to_g, tw, q, qi, ni, fd, cn,
                          s0);
    else if (R == 2)
      radix_round<2, INV>(t, src, dst, sm, from_g, to_g, tw, q, qi, ni, fd, cn,
                          s0);
    else
      radix_round<1, INV>(t, src, dst, sm, from_g, to_g, tw, q, qi, ni, fd, cn,
                          s0);
    if (!to_g) __syncthreads();
    if (last && !direct)
      for (int L = threadIdx.x; L < n_tile; L += blockDim.x)
        dst[goff(t, L)] = sm[swz(L)];
  }
}

template <bool INV>
cudaError_t launch(const uint64_t* in, uint64_t* out, const int* row_limb,
                   const uint64_t* q, const uint64_t* qinv, const uint64_t* tw,
                   const uint64_t* ninv, long long l, long long in_bs,
                   long long in_ls, int log_n, const int* ps, int final_pass,
                   cudaStream_t stream) {
  const int smem = ps[4];
  if (smem > 48 * 1024) {
    // per device: the attribute belongs to the function in that context
    static bool raised[64] = {};
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev < 0 || dev >= 64 || !raised[dev]) {
      err = cudaFuncSetAttribute(ntt_pass<INV>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 kMaxSmem);
      if (err != cudaSuccess) return err;
      if (dev >= 0 && dev < 64) raised[dev] = true;
    }
  }
  ntt_pass<INV><<<(unsigned)ps[5], ps[3], smem, stream>>>(
      in, out, row_limb, q, qinv, tw, ninv, l, in_bs, in_ls, log_n, ps[0],
      ps[1], ps[2], final_pass);
  return cudaGetLastError();
}

// ps = {k, log_stride, log_w, threads, smem bytes, grid}
bool pass_ok(const int* ps, long long rows, int log_n) {
  const int k = ps[0], ls = ps[1], lw = ps[2], th = ps[3], smem = ps[4];
  if (k < 1 || ls < 0 || lw < 0 || k + lw > log_n) return false;
  if (ls > 0 && (k + ls != log_n || lw > ls)) return false;
  if (th < 32 || th > kMaxThreads || th % 32) return false;
  if (smem < (8 << (k + lw)) || smem > kMaxSmem) return false;
  const long long grid = rows << (log_n - k - lw);
  return grid <= 0x7fffffffll && grid == ps[5];
}

}  // namespace

// Transform in -> out.  in: row r of the [rows, 2^log_n] view starts at
// element (r / l) * in_bs + (r % l) * in_ls and has unit stride; out is
// contiguous and must not overlap in.  tw is psi_br (forward) or ipsi_br
// (inverse), Montgomery form, [L, n]; q/qinv/ninv are [L].  n_pass (1 or
// 2) passes in execution order, six integers each (see pass_ok), from
// core/ntt_kernel.plan.  Returns a cudaError_t; cudaErrorInvalidValue
// for a ring or a plan this file does not take.
extern "C" int optconv_ntt(const void* in_, void* out_, const void* row_limb_,
                           const void* q_, const void* qinv_, const void* tw_,
                           const void* ninv_, long long rows, long long l,
                           long long in_bs, long long in_ls, int log_n,
                           int inverse, int n_pass, int k0, int ls0, int lw0,
                           int th0, int sm0, int g0, int k1, int ls1, int lw1,
                           int th1, int sm1, int g1, void* stream_) {
  if (log_n < 1 || log_n > kMaxLogN || rows < 1 || l < 1)
    return (int)cudaErrorInvalidValue;
  const int ps[2][6] = {{k0, ls0, lw0, th0, sm0, g0},
                        {k1, ls1, lw1, th1, sm1, g1}};
  if (n_pass == 1) {
    if (!pass_ok(ps[0], rows, log_n) || ls0 != 0 || k0 != log_n)
      return (int)cudaErrorInvalidValue;
  } else if (n_pass == 2) {
    const int* colp = ps[inverse ? 1 : 0];
    const int* chk = ps[inverse ? 0 : 1];
    if (!pass_ok(colp, rows, log_n) || !pass_ok(chk, rows, log_n) ||
        colp[1] == 0 || chk[1] != 0 || colp[0] + chk[0] != log_n)
      return (int)cudaErrorInvalidValue;
  } else {
    return (int)cudaErrorInvalidValue;
  }
  auto* in = (const uint64_t*)in_;
  auto* out = (uint64_t*)out_;
  auto* row_limb = (const int*)row_limb_;
  auto* q = (const uint64_t*)q_;
  auto* qinv = (const uint64_t*)qinv_;
  auto* tw = (const uint64_t*)tw_;
  auto* ninv = (const uint64_t*)ninv_;
  auto stream = (cudaStream_t)stream_;
  const long long n = 1ll << log_n;
  cudaError_t err;
  if (!inverse) {
    err = launch<false>(in, out, row_limb, q, qinv, tw, ninv, l, in_bs, in_ls,
                        log_n, ps[0], n_pass == 1, stream);
    if (err != cudaSuccess || n_pass == 1) return (int)err;
    return (int)launch<false>(out, out, row_limb, q, qinv, tw, ninv, l, l * n,
                              n, log_n, ps[1], 1, stream);
  }
  err = launch<true>(in, out, row_limb, q, qinv, tw, ninv, l, in_bs, in_ls,
                     log_n, ps[0], n_pass == 1, stream);
  if (err != cudaSuccess || n_pass == 1) return (int)err;
  return (int)launch<true>(out, out, row_limb, q, qinv, tw, ninv, l, l * n, n,
                           log_n, ps[1], 1, stream);
}

// ---------------------------------------------------------------------------
// One cross stage of an NTT whose columns are split over sp ranks.
//
// Part of K2/K3's work on an sp mesh (core/ntt_kernel.ntt_cross_cuda):
// rank s holds the columns [s n, (s+1) n) of every row, and the first
// log2(sp) forward stages (the last log2(sp) inverse ones) pair a column
// with the same column of a partner rank.  Each rank holds one half of
// every butterfly of the stage, `mine`, has received the partner's half,
// `theirs`, and keeps its own output half:
//
//   forward, lower   mine + w * theirs      inverse, lower   mine + theirs
//   forward, upper   theirs - w * mine      inverse, upper   (theirs - mine) * w
//
// w is one twiddle a row (Montgomery form, selected by the row's limb),
// the same psi_br / ipsi_br entry that the whole in-place network reads.
// Inputs are canonical residues and so are the outputs: the result is the
// same residue the canonical arithmetic of core/ntt.ntt_cross_plain gives.
// Both ranks multiply (the lower rank w * v, the upper w * v of its own
// v): each sends its raw half, so a stage is one exchange and one launch.
//
// What bounds it: the bytes.  Two 8-byte reads and one write an element
// against one Montgomery product (about 20 issue slots): on an H100 the
// memory takes about six times as long as the integer pipe.  So the
// kernel is one grid-stride pass of 16-byte loads and stores, two
// elements a thread, with the three per-limb constants read once a pair.
// ---------------------------------------------------------------------------

namespace {

constexpr int kCrossThreads = 256;

template <bool INV, bool UPPER>
__device__ __forceinline__ uint64_t cross_one(uint64_t m, uint64_t t,
                                              uint64_t w, uint64_t q,
                                              uint64_t qi) {
  if (!INV) {
    if (!UPPER) return cond_sub(m + mont_mul(t, w, q, qi), q);
    const uint64_t v = mont_mul(m, w, q, qi);
    return t >= v ? t - v : t + q - v;
  }
  if (!UPPER) return cond_sub(m + t, q);
  return mont_mul(t + q - m, w, q, qi);  // t - m + q in [1, 2q)
}

template <bool INV, bool UPPER>
__global__ void __launch_bounds__(kCrossThreads)
ntt_cross(const ulonglong2* __restrict__ mine,
          const ulonglong2* __restrict__ theirs, ulonglong2* __restrict__ out,
          const int* __restrict__ row_limb, const uint64_t* __restrict__ q_,
          const uint64_t* __restrict__ qinv_, const uint64_t* __restrict__ w_,
          long long pairs, int log_pairs_row) {
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < pairs; i += step) {
    const int limb = row_limb[i >> log_pairs_row];
    const uint64_t q = q_[limb], qi = qinv_[limb], w = w_[limb];
    const ulonglong2 a = mine[i], b = theirs[i];
    ulonglong2 r;
    r.x = cross_one<INV, UPPER>(a.x, b.x, w, q, qi);
    r.y = cross_one<INV, UPPER>(a.y, b.y, w, q, qi);
    out[i] = r;
  }
}

}  // namespace

// out = one cross stage of (mine, theirs), all [rows, 2^log_n] contiguous
// uint64 and 16-byte aligned; out may not overlap either input.  row_limb
// [rows] int32 selects q, qinv and w, each [L] (w in Montgomery form).
// upper: this rank holds the upper half of the stage's butterflies.
// Returns a cudaError_t; cudaErrorInvalidValue for a shape it does not take.
extern "C" int optconv_ntt_cross(const void* mine, const void* theirs,
                                 void* out, const void* row_limb,
                                 const void* q, const void* qinv,
                                 const void* w, long long rows, int log_n,
                                 int upper, int inverse, void* stream_) {
  if (log_n < 1 || log_n > kMaxLogN || rows < 1)
    return (int)cudaErrorInvalidValue;
  const long long pairs = rows << (log_n - 1);
  const long long blocks = (pairs + kCrossThreads - 1) / kCrossThreads;
  if (blocks > 0x7fffffffll) return (int)cudaErrorInvalidValue;
  auto stream = (cudaStream_t)stream_;
  auto* a = (const ulonglong2*)mine;
  auto* b = (const ulonglong2*)theirs;
  auto* o = (ulonglong2*)out;
  auto* rl = (const int*)row_limb;
  auto* qq = (const uint64_t*)q;
  auto* qi = (const uint64_t*)qinv;
  auto* ww = (const uint64_t*)w;
  const dim3 grid((unsigned)blocks), block(kCrossThreads);
  const int lp = log_n - 1;
  if (!inverse && !upper)
    ntt_cross<false, false><<<grid, block, 0, stream>>>(a, b, o, rl, qq, qi,
                                                        ww, pairs, lp);
  else if (!inverse)
    ntt_cross<false, true><<<grid, block, 0, stream>>>(a, b, o, rl, qq, qi,
                                                       ww, pairs, lp);
  else if (!upper)
    ntt_cross<true, false><<<grid, block, 0, stream>>>(a, b, o, rl, qq, qi,
                                                       ww, pairs, lp);
  else
    ntt_cross<true, true><<<grid, block, 0, stream>>>(a, b, o, rl, qq, qi, ww,
                                                      pairs, lp);
  return (int)cudaGetLastError();
}
