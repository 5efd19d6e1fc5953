"""The batched kernel encoding of ``ops/conv.prep_ker`` against the
per-plaintext host composition it replaced (CPU, plain versions).

The reference is ``reshape_ker`` → BN fold → ``max_ker`` →
``encode_ker_final`` → ``encode_coeffs``, one plaintext at a time; the
batched pass must give the same residues, plaintext for plaintext, over
the geometries the callers use: ``trans``, an input stride other than
the output one (the RMFC head), norm 1 / 2 / 4, kernel widths 1 to 9
(9: a dilated 3×3), channels below the batch, a limb-sharded encoder's
rows, exact ties at the rounding and taps that wrap around the
negacyclic shift.  The residue tests of ``tests/test_torch_conv.py`` and
``tests/test_torch_imagenet.py`` hold the same function against JAX.
"""

import numpy as np
import pytest
import torch

from optimal_conv_tpu_torch.ckks.context import CkksContext
from optimal_conv_tpu_torch.ckks.params import CkksParams
from optimal_conv_tpu_torch.ops import conv as convops
from optimal_conv_tpu_torch.utils import tracing

CPU = torch.device("cpu")

torch.set_num_threads(1)


class _RankContext(CkksContext):
    """A context whose encoder makes only the limbs of rank `rank` of two,
    as a limb-sharded context's does."""

    rank = 0

    def _encoder_rows(self):
        p, rank = self.params, self.rank
        return lambda level, qp: tuple(
            p.qp_idx(level) if qp else p.q_idx(level))[rank::2]


def _ctx(log_n: int, rank: int | None = None) -> CkksContext:
    p = CkksParams(log_n=log_n, logq=(60, 45), logp=(61,), log_scale=30,
                   h=64)
    if rank is None:
        return CkksContext(p, CPU, seed=3)
    return type("Rank", (_RankContext,), {"rank": rank})(p, CPU, seed=3)


def _host_composition(ctx, ker, bn_a, in_wid, ker_wid, real_ib, real_ob,
                      norm, trans, in_norm):
    """{i: Plaintext} the way ``prep_ker`` made them before: a dense
    ``max_ker`` and one host encode a plaintext."""
    p = ctx.params
    max_bat = p.n // (in_wid * in_wid)
    k_sz = ker_wid * ker_wid
    ker_rs = convops.reshape_ker(ker, k_sz, real_ob, trans)
    ker_rs = ker_rs * np.asarray(bn_a)[:, None]
    max_ker = np.zeros((max_bat, max_bat * k_sz))
    cols = (in_norm * k_sz * np.arange(real_ib)[:, None]
            + np.arange(k_sz)).ravel()
    max_ker[np.ix_(norm * np.arange(real_ob), cols)] = \
        ker_rs[:, : real_ib * k_sz]
    return {i: ctx.encoder.encode_coeffs(
        convops.encode_ker_final(max_ker, i, in_wid, max_bat, ker_wid),
        p.scale, convops.ECD_LEVEL) for i in range(0, max_bat, norm)}


# id: (log_n, in_wid, ker_wid, norm, in_norm, real_ib, real_ob, in_batch,
#      trans, weights, encoder rank)
CASES = {
    "k3_norm1": (10, 8, 3, 1, None, 16, 16, 16, False, "uniform", None),
    "k3_norm2_trans": (10, 8, 3, 2, None, 8, 8, 8, True, "uniform", None),
    "k3_norm4_cut": (10, 8, 3, 4, None, 3, 2, 4, False, "uniform", None),
    "k1_trans": (10, 8, 1, 1, None, 16, 16, 16, True, "uniform", None),
    "k5_norm2": (10, 8, 5, 2, None, 8, 6, 8, False, "uniform", None),
    "k7_head_in_norm2": (10, 8, 7, 1, 2, 8, 12, 8, False, "broadcast", None),
    "k9_dilated": (11, 16, 9, 1, None, 8, 8, 8, False, "dilated", None),
    "k3_half_to_even": (10, 8, 3, 1, None, 16, 16, 16, False, "ties", None),
    "k3_rank0_rows": (10, 8, 3, 2, None, 8, 8, 8, False, "uniform", 0),
    "k5_rank1_rows_trans": (10, 8, 5, 1, None, 16, 12, 16, True, "uniform",
                            1),
}


def _weights(kind, ker_wid, in_batch, real_ob, rng):
    """Flat kernel (python order, k_sz·in_batch·real_ob) and BN scales."""
    k_sz = ker_wid * ker_wid
    bn_a = rng.uniform(0.8, 1.2, real_ob)
    if kind == "uniform":
        ker = rng.uniform(-1, 1, k_sz * in_batch * real_ob) / ker_wid
    elif kind == "broadcast":            # the RMFC head: the FC at each tap
        fc = rng.normal(0, 1.0, (in_batch, real_ob))
        ker = np.broadcast_to(fc[None, None],
                              (ker_wid, ker_wid, in_batch, real_ob)).ravel()
        bn_a = np.full(real_ob, 1.0 / k_sz)
    elif kind == "dilated":              # Conv_inside: a 3×3 at step 4
        small = rng.uniform(-1, 1, (3, 3, in_batch, real_ob))
        ker = np.zeros((ker_wid, ker_wid, in_batch, real_ob))
        ker[::4, ::4] = small
        ker = ker.ravel()
    else:                                # every scaled weight ends in .5
        half = rng.integers(-40, 40, k_sz * in_batch * real_ob) + 0.5
        ker = half * 2.0 ** -30
        bn_a = np.ones(real_ob)
    return ker, bn_a


@pytest.mark.parametrize("case", list(CASES))
def test_batched_prep_ker_equals_host(case):
    (log_n, in_wid, ker_wid, norm, in_norm, real_ib, real_ob, in_batch,
     trans, kind, rank) = CASES[case]
    ctx = _ctx(log_n, rank)
    ker, bn_a = _weights(kind, ker_wid, in_batch, real_ob,
                         np.random.default_rng(len(case)))
    max_bat = ctx.params.n // (in_wid * in_wid)
    pos, sign = convops._ker_layout(in_wid, ker_wid, max_bat,
                                    in_norm or norm, real_ib, CPU)
    assert (sign < 0).any() and (sign > 0).any()      # some taps wrap
    assert len(set(pos.tolist())) == pos.numel()
    before = tracing.counters()
    got = convops.prep_ker(ctx, ker, bn_a, in_wid, ker_wid, real_ib, real_ob,
                           norm, trans, in_norm)
    moved = {k: tracing.counters()[k] - before.get(k, 0)
             for k in ("encode.kernel.pts", "encode.kernel.host_pts")}
    want = _host_composition(ctx, ker, bn_a, in_wid, ker_wid, real_ib,
                             real_ob, norm, trans, in_norm or norm)
    assert moved == {"encode.kernel.pts": len(want),
                     "encode.kernel.host_pts": 0}
    assert len(got) == max_bat
    assert [i for i, g in enumerate(got) if g is not None] == list(want)
    for i, w in want.items():
        g = got[i]
        assert (g.level, g.scale, g.is_mont) == (w.level, w.scale, w.is_mont)
        assert g.poly.shape == w.poly.shape
        assert torch.equal(g.poly, w.poly), i
        assert g.poly.data_ptr() == got.polys[i // norm].data_ptr()
    if kind == "ties":
        ints = np.round(ker * ctx.params.scale)
        assert (np.abs(ints - ker * ctx.params.scale) == 0.5).all()
        assert (ints % 2 == 0).all()


def test_prep_ker_beyond_int64_takes_the_host_path():
    """Weights whose scaled magnitude reaches 2^62 are encoded on the host
    through Python integers, with the same plaintexts the composition
    gives; ``encode.kernel.host_pts`` counts them."""
    ctx = _ctx(10)
    rng = np.random.default_rng(4)
    in_wid, ker_wid, nch, norm = 8, 3, 8, 2
    ker = rng.uniform(-1, 1, 9 * nch * nch)
    ker[5] = 2.0 ** 33                              # ·2^30 = 2^63
    bn_a = rng.uniform(0.8, 1.2, nch)
    before = tracing.counters()
    got = convops.prep_ker(ctx, ker, bn_a, in_wid, ker_wid, nch, nch, norm,
                           False)
    after = tracing.counters()
    want = _host_composition(ctx, ker, bn_a, in_wid, ker_wid, nch, nch, norm,
                             False, norm)
    assert after["encode.kernel.host_pts"] - before.get(
        "encode.kernel.host_pts", 0) == len(want)
    assert after["encode.kernel.pts"] == before.get("encode.kernel.pts", 0)
    assert not hasattr(got, "polys")
    for i, w in want.items():
        assert torch.equal(got[i].poly, w.poly), i


def test_prep_ker_refuses_channels_beyond_the_batch():
    ctx = _ctx(10)                      # in_wid 8: a batch of 16
    ker = np.ones(9 * 16 * 16)
    with pytest.raises(ValueError, match="does not fit"):
        convops.prep_ker(ctx, ker, np.ones(16), 8, 3, 16, 16, 2, False)
    with pytest.raises(ValueError, match="does not fit"):
        convops.prep_ker(ctx, ker, np.ones(16), 8, 3, 17, 16, 1, False)


def test_conv_then_pack_reads_the_kernel_tensor():
    """``conv_then_pack`` takes ``prep_ker``'s tensor itself while the
    list's entries are its rows, stacks a copy otherwise, and both give
    the same ciphertext."""
    ctx = _ctx(10)
    p = ctx.params
    in_wid, ker_wid, norm = 8, 3, 2
    nch = p.n // (in_wid * in_wid) // norm
    rng = np.random.default_rng(7)
    ker = rng.uniform(-1, 1, 9 * nch * nch) / 9
    pl = convops.prep_ker(ctx, ker, np.ones(nch), in_wid, ker_wid, nch, nch,
                          norm, False)
    max_bat = p.n // (in_wid * in_wid)
    pts = [pl[i] for i in range(0, max_bat, norm)]
    assert convops._kernel_polys(pl, pts) is pl.polys
    swapped = convops.KernelPlaintexts(pl, pl.polys)
    swapped[0], swapped[norm] = swapped[norm], swapped[0]
    copy = convops._kernel_polys(
        swapped, [swapped[i] for i in range(0, max_bat, norm)])
    assert copy is not pl.polys
    assert torch.equal(copy[0], pl.polys[1])
    ct = ctx.encrypt(ctx.encoder.encode_coeffs(
        rng.uniform(-1, 1, p.n), p.scale, convops.ECD_LEVEL))
    bias = ctx.encoder.encode_coeffs(np.zeros(p.n), float(1 << 30), 0,
                                     mont=False)
    outs = [convops.conv_then_pack(ctx, ct, kp, max_bat, norm,
                                   float(1 << 30), bias)
            for kp in (pl, list(pl))]
    assert torch.equal(outs[0].c0, outs[1].c0)
    assert torch.equal(outs[0].c1, outs[1].c1)
