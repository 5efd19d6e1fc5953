"""The launch plan and the schedule of the CUDA NTT kernels, on the CPU.

``csrc/ntt.cu`` cannot run without a card, but everything that decides
which element meets which twiddle is integer arithmetic that a CPU can
repeat.  ``_model_pass`` below is that arithmetic in numpy/torch: the
same tile, group, point and twiddle index formulas as ``ntt_pass`` and
``radix_round``, applied with the plain modular operations.  Driven by
``ntt_kernel.plan`` it must equal the plain in-place network bit for bit.
The kernel keeps its values lazily reduced between stages; the model
uses canonical arithmetic, which gives the same residues, and a test of
its own holds the lazy butterflies of ``csrc/modarith.cuh`` to their
ranges in exact integers.
"""

import numpy as np
import pytest
import torch

from optimal_conv_tpu_torch.ckks.params import boot_params
from optimal_conv_tpu_torch.core import modmath as mm
from optimal_conv_tpu_torch.core import ntt_kernel
from optimal_conv_tpu_torch.core.ntt import NttContext

CPU = torch.device("cpu")

# The suite runs in several pytest workers at once; PyTorch's intra-op
# threads on top of them oversubscribe the cores, so each worker keeps one.
torch.set_num_threads(1)


def _rounds(k):
    """(R, s0) of each stage group of a k-stage pass, first to last."""
    r_first = k % 3 if k % 3 else min(k, 3)
    out, s0 = [], 0
    while s0 < k:
        r = r_first if s0 == 0 else 3
        out.append((r, s0))
        s0 += r
    return out


def _swz(L):
    return L ^ ((L >> 3) & 15)


def _model_pass(x, tw, q, qinv, ninv, log_n, ps, inverse, fold):
    """One pass of csrc/ntt.cu on x [l, N] (all tiles of every row)."""
    k, ls, lw = ps["k"], ps["log_stride"], ps["log_w"]
    col = ls > 0
    tile_log = k + lw
    p0 = lw if col else 0
    gw = lw if col else tile_log
    tile = np.arange(1 << (log_n - tile_log), dtype=np.int64)[:, None]
    base = tile << (lw if col else tile_log)
    root0 = np.ones_like(tile) if col else (1 << (log_n - k)) + (tile << lw)
    rounds = _rounds(k)
    for r, s0 in (reversed(rounds) if inverse else rounds):
        p = k - s0 - r
        P = p0 + p
        g = np.arange(1 << (tile_log - r), dtype=np.int64)[None, :]
        Lb = (g & ((1 << P) - 1)) | ((g >> P) << (P + r))
        e = (Lb >> p0) & ((1 << k) - 1)
        root = root0 + ((Lb >> k) if p0 == 0 else 0)
        Rr = ((root << s0) + (e >> (p + r))).ravel()
        idx = []
        for j in range(1 << r):
            L = Lb | (j << P)
            idx.append(torch.from_numpy(
                (base + ((L >> gw) << ls) + (L & ((1 << gw) - 1))).ravel()))
        xs = [x[:, i] for i in idx]
        for uu in range(r):
            u = r - 1 - uu if inverse else uu
            span = 1 << (r - 1 - u)
            for jh in range(1 << u):
                w = tw[:, torch.from_numpy((Rr << u) + jh)]
                scale = inverse and fold and s0 == 0 and u == 0
                if scale:
                    w = mm.mont_mul_plain(w, ninv, q, qinv)
                for jl in range(span):
                    j0 = jh * 2 * span + jl
                    a = xs[j0]
                    if not inverse:
                        b = mm.mont_mul_plain(xs[j0 + span], w, q, qinv)
                        xs[j0] = mm.add_mod(a, b, q)
                        xs[j0 + span] = mm.sub_mod(a, b, q)
                    else:
                        b = xs[j0 + span]
                        s = mm.add_mod(a, b, q)
                        xs[j0] = (mm.mont_mul_plain(s, ninv, q, qinv)
                                  if scale else s)
                        xs[j0 + span] = mm.mont_mul_plain(
                            mm.sub_mod(a, b, q), w, q, qinv)
        x = x.clone()
        for i, v in zip(idx, xs):
            x[:, i] = v
    return x


def _model_transform(ctx, x, idx, inverse):
    q, qinv = ctx.tabs(idx)[:2]
    psi, ipsi, ninv = ctx.plain_tabs(idx)
    passes = ntt_kernel.plan(ctx.log_n, x.shape[0], inverse)
    for i, ps in enumerate(passes):
        assert ps["grid"] == x.shape[0] << (ctx.log_n - ps["k"] - ps["log_w"])
        x = _model_pass(x, ipsi if inverse else psi, q, qinv, ninv, ctx.log_n,
                        ps, inverse, fold=i == len(passes) - 1)
    return x


@pytest.mark.parametrize("log_n", range(1, ntt_kernel.MAX_LOG_N + 1))
def test_plan_covers_every_stage_once(log_n):
    for inverse in (False, True):
        for rows in (1, 2, 33, 768):
            passes = ntt_kernel.plan(log_n, rows, inverse)
            fits = 8 << log_n <= ntt_kernel.SMEM_LIMIT
            assert len(passes) == (1 if fits else 2)
            order = passes[::-1] if inverse else passes
            stages = [s for ps in order
                      for s in range(ps["stages"][0], ps["stages"][1] + 1)]
            assert stages == list(range(log_n))
            for ps in passes:
                tile_log = ps["k"] + ps["log_w"]
                assert ps["stages"][1] - ps["stages"][0] + 1 == ps["k"]
                assert 8 << tile_log <= ps["smem"] <= 232448
                assert ps["grid"] == rows << (log_n - tile_log) > 0
                assert 32 <= ps["threads"] <= 512 and ps["threads"] % 32 == 0
                assert ps["threads"] * 8 <= max(256, 1 << tile_log)
                if ps["log_stride"]:           # a column pass
                    assert ps["k"] + ps["log_stride"] == log_n
                    assert ps["log_w"] <= ps["log_stride"]
                    assert ps["stages"][0] == 0
                else:
                    assert ps["stages"][1] == log_n - 1
                assert sum(r for r, _ in _rounds(ps["k"])) == ps["k"]
    # the small transforms still give most of the 132 SMs a block
    if log_n == 16:
        assert all(ps["grid"] >= 128 for ps in ntt_kernel.plan(16, 2, False))


@pytest.mark.parametrize("bad", [0, ntt_kernel.MAX_LOG_N + 1])
def test_plan_rejects_unsupported_rings(bad):
    with pytest.raises(ValueError):
        ntt_kernel.plan(bad, 1, False)
    with pytest.raises(ValueError):
        ntt_kernel.plan(10, 0, False)


@pytest.mark.parametrize("log_n", [10, 12, 15, 16, 17])
def test_two_pass_model_equals_plain(log_n):
    """The kernel's index arithmetic, pass by pass, against _ntt_fwd and
    _ntt_inv on two limbs of the fork chain (its primes are 1 mod 2^17,
    so they carry every smaller ring too)."""
    mods = boot_params(16).moduli
    mods = [mods[0], mods[-1]]
    if log_n == 17:                      # needs primes that are 1 mod 2^18
        mods = mm.gen_ntt_primes(17, [55, 61])
    ctx = NttContext(mods, log_n, CPU)
    rng = np.random.default_rng(log_n)
    a = np.stack([rng.integers(0, q, size=1 << log_n, dtype=np.int64)
                  for q in mods])
    a[:, 0] = 0
    a[:, 1] = np.array(mods, dtype=np.int64) - 1
    a = torch.from_numpy(a)
    idx = (0, 1)
    f = ctx.ntt(a, idx)
    assert torch.equal(_model_transform(ctx, a, idx, False), f)
    assert torch.equal(_model_transform(ctx, f, idx, True), ctx.intt(f, idx))
    assert torch.equal(ctx.intt(f, idx), a)


def _mont_lazy(a, b, q):
    """mont_mul_lazy of csrc/modarith.cuh in exact integers."""
    qinv = (-pow(q, -1, 1 << 64)) % (1 << 64)
    lo, hi = (a * b) % (1 << 64), (a * b) >> 64
    m = (lo * qinv) % (1 << 64)
    r = hi + ((m * q) >> 64) + (1 if lo else 0)
    assert r < 1 << 64 and (r << 64) % q == (a * b) % q
    return r


@pytest.mark.parametrize("which", ["ct", "gs", "last_gs"])
def test_lazy_butterflies_stay_in_range(which):
    """Harvey's butterflies as the kernel runs them: forward values stay
    below 4q, inverse values below 2q, nothing leaves 64 bits, and each
    result is congruent to the canonical butterfly's.  Corner values and
    random ones, on the largest and the smallest prime of the chain."""
    rng = np.random.default_rng(3)
    mods = boot_params(16).moduli
    for q in (max(mods), min(mods)):
        assert q < 1 << 62
        top = 4 * q if which == "ct" else 2 * q
        vals = [0, 1, q - 1, q, top - 1] + [int(v) for v in
                                            rng.integers(0, top, 40)]
        ws = [0, 1, q - 1] + [int(v) for v in rng.integers(0, q, 6)]
        rinv = pow(1 << 64, -1, q)
        for x0 in vals:
            for x1 in vals:
                for w in ws:
                    if which == "ct":
                        a = x0 - 2 * q if x0 >= 2 * q else x0
                        b = _mont_lazy(x1, w, q)
                        y0, y1 = a + b, a - b + 2 * q
                        assert 0 <= y0 < 4 * q and 0 <= y1 < 4 * q
                        assert b < 2 * q
                        want = x1 * w * rinv
                        assert (y0 - x0 - want) % q == 0
                        assert (y1 - x0 + want) % q == 0
                    elif which == "gs":
                        s = x0 + x1
                        y0 = s - 2 * q if s >= 2 * q else s
                        d = x0 - x1 + 2 * q
                        assert 0 <= d < 4 * q
                        y1 = _mont_lazy(d, w, q)
                        assert 0 <= y0 < 2 * q and 0 <= y1 < 2 * q
                        assert (y0 - x0 - x1) % q == 0
                        assert (y1 - (x0 - x1) * w * rinv) % q == 0
                    else:       # the last inverse stage: canonical out
                        y0 = _mont_lazy(x0 + x1, w, q)
                        y1 = _mont_lazy(x0 - x1 + 2 * q, w, q)
                        assert y0 < 2 * q and y1 < 2 * q


@pytest.mark.parametrize("r,P", [(3, P) for P in range(10)]
                         + [(2, P) for P in range(4, 11)])
def test_swizzle_is_conflict_free(r, P):
    """phys = L ^ ((L >> 3) & 15) permutes a tile, and the 16 accesses of
    a half-warp in a radix-2^r round whose group bits start at bit P of
    the tile index fall on 16 distinct 8-byte bank pairs."""
    tile = 1 << 12
    L = np.arange(tile)
    assert np.array_equal(np.sort(_swz(L)), L)
    g = np.arange(tile >> r)
    Lb = (g & ((1 << P) - 1)) | ((g >> P) << (P + r))
    for j in range(1 << r):
        banks = (_swz(Lb | (j << P)) % 16).reshape(-1, 16)
        assert all(len(set(row)) == 16 for row in banks)


@pytest.mark.parametrize("view,want", [
    ("whole", (6 * 64, 64)), ("limb_slice", (6 * 64, 64)),
    ("one_ct", (0, 64)), ("batch_of_one_limb", (6 * 64, 64)),
    ("two_batch_dims", (6 * 64, 64)), ("batch_step", None),
    ("column_slice", (6 * 64, 64)), ("transposed", None)])
def test_row_strides_of_views(view, want):
    """Which views the wrapper reads in place: (batch stride, limb
    stride) in elements, or None where it makes the one copy."""
    base = torch.arange(4 * 3 * 6 * 64, dtype=torch.int64).reshape(4, 3, 6, 64)
    a = {"whole": base[0], "limb_slice": base[0][:, 4:, :],
         "one_ct": base[0, 0], "batch_of_one_limb": base[0][:, 5:, :],
         "two_batch_dims": base[:, :, 2:, :], "batch_step": base[::2, :, 1:],
         "column_slice": base[0][..., :32],
         "transposed": base[0].transpose(-1, -2)}[view]
    got = ntt_kernel._row_strides(a)
    assert got == want
    if want is not None:
        n, l = a.shape[-1], a.shape[-2]
        flat = a.reshape(-1, n)
        for r in range(flat.shape[0]):      # base holds its own offsets
            off = a.storage_offset() + (r // l) * got[0] + (r % l) * got[1]
            assert torch.equal(flat[r], torch.arange(off, off + n))


# rows of one transform on the ReLU path of the 28+5-limb chain: the top
# limb of a rescale, the P rows of a mod-down, and the key-switch digits
# beta·(l+6) of levels 5 (2 digits), 10 (3) and 15 (4)
@pytest.mark.parametrize("rows", [1, 5, 15, 22, 48, 84])
def test_plan_at_evaluator_row_counts(rows):
    for inverse in (False, True):
        passes = ntt_kernel.plan(16, rows, inverse)
        assert len(passes) == 2
        cols, chunks = passes[::-1] if inverse else passes
        assert (cols["k"], cols["log_stride"]) == (8, 8)
        assert (chunks["k"], chunks["log_stride"]) == (8, 0)
        for ps in passes:
            assert ps["grid"] == rows * 64 and ps["threads"] == 128
            assert ps["smem"] == 8192
        ints = ntt_kernel._plan_ints(16, rows, inverse)
        assert ints[0] == 2 and len(ints) == 13


def test_row_strides_of_evaluator_views():
    """The views the evaluator transforms in place: the top limb of a
    level-15 polynomial, the P rows of a [21, N] accumulator and of a
    batch of them, and a level dropped by slicing."""
    n = 16
    acc = torch.zeros(21, n, dtype=torch.int64)
    assert ntt_kernel._row_strides(acc[16:]) == (0, n)
    assert ntt_kernel._row_strides(acc[15:16]) == (0, n)
    assert ntt_kernel._row_strides(acc[:11]) == (0, n)
    batch = torch.zeros(3, 21, n, dtype=torch.int64)
    assert ntt_kernel._row_strides(batch[:, 16:]) == (21 * n, n)
    assert ntt_kernel._row_strides(batch[:, :6]) == (21 * n, n)
