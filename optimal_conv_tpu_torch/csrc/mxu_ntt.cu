// The four-step matrix NTT on Hopper's int8 tensor cores.
//
// Replaces optimal_conv_tpu/core/mxu_ntt.py: _fwd_body, _inv_body and
// their _mod_matmul.  On the TPU that route is an XLA composite (one int8
// einsum on the MXU per step, then the recombination of its byte-diagonal
// groups), the JAX package's default NTT at logN >= 14 on calls over at
// most 12 limbs.  The transform is the butterfly's (K2/K3), bit for bit:
// with A = 256 and B = n/256, a row viewed as x[A][B],
//
//   forward  step 1  Y[r][i2]  = sum_i1 W1[r][i1] x[i1][i2]  (* T[r][i2])
//            step 2  out[r][c] = sum_i2 W2[c][i2] Y[r][i2]
//   inverse  step 1  U[r][i2]  = sum_c  V2[i2][c] x[r][c]    (* Ti[r][i2])
//            step 2  out[i1][i2] = sum_r V1[i1][r] U[r][i2]
//
// each sum mod q.  One launch a step, over every row of the call; a row's
// limb (row_limb) selects its q, its constant matrix and its byte width.
//
// One step is Out[m][n] = sum_t W[m][t] X[t][n] mod q for each row, with
// W the limb's [M][T] matrix and X the row's [T][Nn] view:
//   "A" layout (forward 1, inverse 2): M = T = A, Nn = B, X[t][n] at
//       t*B + n, Out[m][n] at m*B + n;
//   "B" layout (forward 2, inverse 1): M = T = B, Nn = A, X[t][n] at
//       n*B + t, Out[m][n] at n*B + m.
// So both steps read and write the rows in place through strides and no
// pass transposes anything.
//
// The modular matmul on bytes.  W and X hold canonical residues (< 2^62).
// Split both into unsigned bytes, W = sum_p 256^p W_p, X = sum_s 256^s X_s,
// nb planes each (nb = the byte width of the row's q: 4, 6, 7 or 8 on the
// fork's chain).  Then
//   W X = sum_g 256^g G_g,   G_g = sum_{p+s=g} W_p X_s,  g = 0 .. 2nb-2,
// and every entry of G_g sums at most 8 * 255^2 * 256 < 2^27 products: an
// exact s32 accumulation of u8 x u8 tensor-core products
// (mma.sync m16n8k32 .u8.u8.s32, no offset, no correction terms).  The
// epilogue folds the groups as JAX does, lo = sum_{g<5} 2^(8g) G_g,
// mid = sum_{5<=g<10} 2^(8(g-5)) G_g, hi likewise from g = 10 (each
// < 2^60), and reduces lo + 2^40 mid + 2^80 hi with three Montgomery
// products (r1 = 2^64 mod q, c40, c80: 2^40 and 2^80 in Montgomery form)
// and two modular additions; step 1 also multiplies by its twiddle.  Every
// output is the canonical residue, so the result equals the butterfly's.
//
// The block.  A block owns a kBM x kBN tile of one row's output and the
// whole contraction: it copies the kBM rows of the limb's nb planes of W
// (precomputed, uint8 [L][8][M][T]) with cp.async and, while those are in
// flight, loads the row's [T][kBN] slab of X (a batch of loads a thread at
// a time) and splits it into planes on the way into shared memory; both
// keep the contraction contiguous, padded with zeros to a multiple of 32
// (T = B runs from 2 at logN 9 to 256; tiles at the edge of M and Nn are
// padded, not assumed full).  Each warp then computes 16 x 8 output tiles:
// for each k step of 32 it loads the nb fragments of X and, plane by plane,
// those of W, and issues the nb^2 products into the 2nb-1 group
// accumulators (60 registers at nb = 8, which is what keeps a block's tile
// at 64 x 32).
//
// What bounds it on the card: the tensor cores' int8 rate and how close
// mma.sync gets to it.  One transform of a row is 2 * n * (A + B) * nb^2
// operations (67.1 M * nb^2 at logN 16); the card's dense int8 rate,
// SMs x 8192 operations a clock, reached only by wgmma, puts the bound at
// 0.50 us a row for 4-byte limbs and 2.01 us for 8-byte ones (at 1.98
// GHz), above the row's 16 n bytes (0.31 us).  This kernel takes the simple
// road: mma.sync, one shared-memory fill a row and tile with no overlap of
// the fill and the products inside a block, one block an SM at 8 planes
// (204 KB), and each W slab and X slab re-read from L2 by every block that
// shares it (8 column tiles, 4 row tiles).  On an H100 it spends about
// 4.8 us a row on that, whatever nb, and 0.10 us a row per nb^2 on the
// products (PERF.md).  wgmma, TMA, a persistent block that keeps its W slab
// and streams X, a cluster that keeps the middle product on chip and
// fewer planes are the levers for a redesign.

#include <cstdint>
#include <cuda_runtime.h>

#include "modarith.cuh"

namespace {

constexpr int kA = 256;          // A: the step-1 contraction length
constexpr int kBM = 64;          // output rows (m) a block
constexpr int kBN = 32;          // output columns (n) a block
constexpr int kThreads = 256;    // 8 warps
constexpr int kMaxPlanes = 8;
constexpr int kMaxSmem = 232448;
// X items (4 t of one n) a thread loads: kBN columns of at most kA / 4,
// kXBatch at a time
constexpr int kXItems = kA / 4 * kBN / kThreads;
constexpr int kXBatch = 4;

using optconv::cond_sub;
using optconv::mont_mul;

struct Step {
  const uint64_t* in;       // row r at (r / l) * bs + (r % l) * ls
  uint64_t* out;            // row r at r * n
  const uint8_t* w;         // [L][8][M][T] byte planes
  const uint64_t* tw;       // [L][n] Montgomery twiddles, or null
  long long bs, ls, l, rows;
  int n, M, T, Nn, kpad, pitch;
  int xt, xn;               // element strides of X[t][n] in a row
  int om, on;               // element strides of Out[m][n] in a row
};

struct Limbs {
  const int* row_limb;
  const uint64_t *q, *qinv, *r1, *c40, *c80;
  const int* nbytes;
  int planes;               // the planes shared memory holds, >= every
                            // row's nbytes
};

__device__ __forceinline__ void mma_u8(int (&d)[4], uint32_t a0, uint32_t a1,
                                       uint32_t a2, uint32_t a3, uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// sum_{k in [lo_g, hi_g)} 2^(8 (k - lo_g)) G_k of one accumulator element.
template <int NG>
__device__ __forceinline__ uint64_t part(const int (&acc)[NG][4], int e,
                                         int lo_g) {
  uint64_t s = 0;
#pragma unroll
  for (int k = NG - 1; k >= 0; --k)
    if (k >= lo_g && k < lo_g + 5) s = (s << 8) + (uint32_t)acc[k][e];
  return s;
}

// One warp's 16 x 8 output tile (mt, nt) of the block's tile at NB planes:
// the group sums over the whole contraction, then the epilogue.
template <int NB>
__device__ void warp_tile(const Step& st, const uint8_t* ws,
                          const uint8_t* xs, int mt, int nt, int m0, int n0,
                          long long row, int limb, uint64_t q, uint64_t qinv,
                          uint64_t r1, uint64_t c40, uint64_t c80) {
  constexpr int NG = 2 * NB - 1;
  const int lane = threadIdx.x & 31, g = lane >> 2, tig = lane & 3;
  const int pitch = st.pitch;
  const int wplane = kBM * pitch, xplane = kBN * pitch;
  int acc[NG][4];
#pragma unroll
  for (int k = 0; k < NG; ++k) acc[k][0] = acc[k][1] = acc[k][2] = acc[k][3] = 0;
  const uint8_t* wrow = ws + (mt * 16 + g) * pitch + tig * 4;
  const uint8_t* xrow = xs + (nt * 8 + g) * pitch + tig * 4;
  for (int k0 = 0; k0 < st.kpad; k0 += 32) {
    uint32_t b[NB][2];
#pragma unroll
    for (int s = 0; s < NB; ++s) {
      const uint8_t* p = xrow + s * xplane + k0;
      b[s][0] = *(const uint32_t*)p;
      b[s][1] = *(const uint32_t*)(p + 16);
    }
#pragma unroll
    for (int pl = 0; pl < NB; ++pl) {
      const uint8_t* p = wrow + pl * wplane + k0;
      const uint32_t a0 = *(const uint32_t*)p;
      const uint32_t a1 = *(const uint32_t*)(p + 8 * pitch);
      const uint32_t a2 = *(const uint32_t*)(p + 16);
      const uint32_t a3 = *(const uint32_t*)(p + 8 * pitch + 16);
#pragma unroll
      for (int s = 0; s < NB; ++s)
        mma_u8(acc[pl + s], a0, a1, a2, a3, b[s][0], b[s][1]);
    }
  }
  // element e of the accumulator: row g (+8 for e >= 2), column 2 tig + (e & 1)
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int m = m0 + mt * 16 + g + (e >> 1) * 8;
    const int n = n0 + nt * 8 + 2 * tig + (e & 1);
    if (m >= st.M || n >= st.Nn) continue;
    uint64_t r = mont_mul(part<NG>(acc, e, 0), r1, q, qinv);
    if (NG > 5) r = cond_sub(r + mont_mul(part<NG>(acc, e, 5), c40, q, qinv), q);
    if (NG > 10)
      r = cond_sub(r + mont_mul(part<NG>(acc, e, 10), c80, q, qinv), q);
    const long long off = (long long)m * st.om + (long long)n * st.on;
    if (st.tw != nullptr) r = mont_mul(r, st.tw[(long long)limb * st.n + off], q, qinv);
    st.out[row * st.n + off] = r;
  }
}

template <int NB>
__device__ void tiles(const Step& st, const uint8_t* ws, const uint8_t* xs,
                      int m0, int n0, long long row, int limb, uint64_t q,
                      uint64_t qinv, uint64_t r1, uint64_t c40, uint64_t c80) {
  const int warp = threadIdx.x >> 5;
  constexpr int kTilesN = kBN / 8;
  for (int t = warp; t < (kBM / 16) * kTilesN; t += kThreads / 32) {
    const int mt = t / kTilesN, nt = t % kTilesN;
    if (m0 + mt * 16 >= st.M || n0 + nt * 8 >= st.Nn) continue;
    warp_tile<NB>(st, ws, xs, mt, nt, m0, n0, row, limb, q, qinv, r1, c40,
                  c80);
  }
}

__global__ void __launch_bounds__(kThreads, 1)
    mxu_step(const Step st, const Limbs lb) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int tiles_n = (st.Nn + kBN - 1) / kBN;
  const int m0 = (blockIdx.x / tiles_n) * kBM;
  const int n0 = (blockIdx.x % tiles_n) * kBN;
  const int pitch = st.pitch;
  uint8_t* ws = smem;                              // [planes][kBM][pitch]
  uint8_t* xs = smem + lb.planes * kBM * pitch;    // [planes][kBN][pitch]
  const int kq = st.kpad / 4, kc = st.kpad / 16;
  for (long long row = blockIdx.y; row < st.rows; row += gridDim.y) {
    const int limb = lb.row_limb[row];
    const int nb = lb.nbytes[limb];
    const uint64_t* x = st.in + (row / st.l) * st.bs + (row % st.l) * st.ls;
    // W[m0 + m][t] of each plane -> ws[p][m][t], zero past M and T: 16-byte
    // asynchronous copies where the rows allow them, in flight while X loads
    const uint8_t* w = st.w + (long long)limb * kMaxPlanes * st.M * st.T;
    const bool vec = st.T % 16 == 0;
    for (int i = threadIdx.x; i < nb * kBM * kc; i += kThreads) {
      const int c = i % kc, m = (i / kc) % kBM, p = i / (kc * kBM);
      uint8_t* dst = ws + (p * kBM + m) * pitch + 16 * c;
      const bool in = m0 + m < st.M && 16 * c < st.T;
      const uint8_t* src = w + ((long long)p * st.M + m0 + m) * st.T + 16 * c;
      if (vec) {
        // src-size 0 writes zeros without reading
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                         (uint32_t)__cvta_generic_to_shared(dst)),
                     "l"(in ? src : st.w), "r"(in ? 16 : 0));
      } else {
        uint4 v = make_uint4(0, 0, 0, 0);
        uint8_t* vb = (uint8_t*)&v;
        for (int j = 0; in && j < 16 && 16 * c + j < st.T; ++j) vb[j] = src[j];
        *(uint4*)dst = v;
      }
    }
    asm volatile("cp.async.commit_group;\n" ::);
    // X[t][n0 + n] -> xs[s][n][t]: byte s of each residue, 4 t a word;
    // neighbouring threads take neighbouring addresses of the row.  The
    // loads of kXBatch items are all issued before the first is used.
    const bool n_inner = st.xn == 1;
    const int items = kq * kBN;
    for (int b0 = 0; b0 < kXItems; b0 += kXBatch) {
      uint64_t v[kXBatch][4];
#pragma unroll
      for (int it = 0; it < kXBatch; ++it) {
        const int i = threadIdx.x + (b0 + it) * kThreads;
        const int n = n_inner ? i % kBN : i / kq;
        const int t4 = n_inner ? i / kBN : i % kq;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int t = 4 * t4 + j;
          v[it][j] = i < items && t < st.T && n0 + n < st.Nn
                         ? x[(long long)t * st.xt + (long long)(n0 + n) * st.xn]
                         : 0;
        }
      }
#pragma unroll
      for (int it = 0; it < kXBatch; ++it) {
        const int i = threadIdx.x + (b0 + it) * kThreads;
        if (i >= items) break;
        const int n = n_inner ? i % kBN : i / kq;
        const int t4 = n_inner ? i / kBN : i % kq;
        for (int s = 0; s < nb; ++s) {
          uint32_t word = 0;
#pragma unroll
          for (int j = 0; j < 4; ++j)
            word |= (uint32_t)((v[it][j] >> (8 * s)) & 0xff) << (8 * j);
          *(uint32_t*)(xs + (s * kBN + n) * pitch + 4 * t4) = word;
        }
      }
    }
    asm volatile("cp.async.wait_all;\n" ::);
    __syncthreads();
    const uint64_t q = lb.q[limb], qinv = lb.qinv[limb], r1 = lb.r1[limb],
                   c40 = lb.c40[limb], c80 = lb.c80[limb];
    switch (nb) {
      case 1: tiles<1>(st, ws, xs, m0, n0, row, limb, q, qinv, r1, c40, c80); break;
      case 2: tiles<2>(st, ws, xs, m0, n0, row, limb, q, qinv, r1, c40, c80); break;
      case 3: tiles<3>(st, ws, xs, m0, n0, row, limb, q, qinv, r1, c40, c80); break;
      case 4: tiles<4>(st, ws, xs, m0, n0, row, limb, q, qinv, r1, c40, c80); break;
      case 5: tiles<5>(st, ws, xs, m0, n0, row, limb, q, qinv, r1, c40, c80); break;
      case 6: tiles<6>(st, ws, xs, m0, n0, row, limb, q, qinv, r1, c40, c80); break;
      case 7: tiles<7>(st, ws, xs, m0, n0, row, limb, q, qinv, r1, c40, c80); break;
      default: tiles<8>(st, ws, xs, m0, n0, row, limb, q, qinv, r1, c40, c80); break;
    }
    __syncthreads();
  }
}

Step make_step(const uint64_t* in, uint64_t* out, const uint8_t* w,
               const uint64_t* tw, long long bs, long long ls, long long l,
               long long rows, int log_n, bool a_layout) {
  Step st;
  st.in = in; st.out = out; st.w = w; st.tw = tw;
  st.bs = bs; st.ls = ls; st.l = l; st.rows = rows;
  st.n = 1 << log_n;
  const int b = st.n / kA;
  if (a_layout) {
    st.M = st.T = kA; st.Nn = b;
    st.xt = b; st.xn = 1; st.om = b; st.on = 1;
  } else {
    st.M = st.T = b; st.Nn = kA;
    st.xt = 1; st.xn = b; st.om = 1; st.on = b;
  }
  st.kpad = (st.T + 31) / 32 * 32;
  st.pitch = st.kpad + 16;
  return st;
}

cudaError_t launch(const Step& st, const Limbs& lb, cudaStream_t stream) {
  const int smem = lb.planes * (kBM + kBN) * st.pitch;
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    // per device: the attribute belongs to the function in that context
    static bool raised[64] = {};
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev < 0 || dev >= 64 || !raised[dev]) {
      err = cudaFuncSetAttribute(mxu_step,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 kMaxSmem);
      if (err != cudaSuccess) return err;
      if (dev >= 0 && dev < 64) raised[dev] = true;
    }
  }
  const int tiles = ((st.M + kBM - 1) / kBM) * ((st.Nn + kBN - 1) / kBN);
  const long long ys = st.rows < 65535 ? st.rows : 65535;
  mxu_step<<<dim3(tiles, (unsigned)ys), kThreads, smem, stream>>>(st, lb);
  return cudaGetLastError();
}

}  // namespace

// Transform in -> out through mid, two launches.  in: row r of the
// [rows, 2^log_n] view starts at element (r / l) * in_bs + (r % l) * in_ls
// and has unit stride; mid and out are contiguous [rows, n] and overlap
// neither in nor each other.  wa: the [L][8][A][A] planes (W1 forward, V1
// inverse), wb: the [L][8][B][B] planes (W2 forward, V2 inverse), tw: T or
// Ti, [L][n] Montgomery form; q, qinv, r1, c40, c80: [L]; nbytes: int32
// [L], each limb's byte width.  planes: the byte planes shared memory is
// sized for; it must be at least nbytes of every row's limb (the wrapper
// takes it from the same limbs as row_limb), or a row's planes overrun
// shared memory.  Returns a cudaError_t; cudaErrorInvalidValue for a ring
// or an argument this file does not take.
extern "C" int optconv_mxu_ntt(const void* in, void* mid, void* out,
                               const void* row_limb, const void* q,
                               const void* qinv, const void* r1,
                               const void* c40, const void* c80,
                               const void* nbytes, const void* wa,
                               const void* wb, const void* tw, long long rows,
                               long long l, long long in_bs, long long in_ls,
                               int log_n, int inverse, int planes,
                               void* stream_) {
  if (log_n < 9 || log_n > 16 || rows < 1 || l < 1 || planes < 1 ||
      planes > kMaxPlanes)
    return (int)cudaErrorInvalidValue;
  const Limbs lb{(const int*)row_limb, (const uint64_t*)q,
                 (const uint64_t*)qinv, (const uint64_t*)r1,
                 (const uint64_t*)c40,  (const uint64_t*)c80,
                 (const int*)nbytes,    planes};
  auto stream = (cudaStream_t)stream_;
  const long long n = 1ll << log_n;
  auto* x = (const uint64_t*)in;
  auto* m = (uint64_t*)mid;
  auto* o = (uint64_t*)out;
  auto* t = (const uint64_t*)tw;
  auto* a = (const uint8_t*)wa;
  auto* b = (const uint8_t*)wb;
  // forward: A step (W1, * T) then B step (W2); inverse: B step (V2, * Ti)
  // then A step (V1)
  const Step s1 = make_step(x, m, inverse ? b : a, t, in_bs, in_ls, l, rows,
                            log_n, !inverse);
  const Step s2 = make_step(m, o, inverse ? a : b, nullptr, l * n, n, l, rows,
                            log_n, inverse);
  cudaError_t err = launch(s1, lb, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)launch(s2, lb, stream);
}
