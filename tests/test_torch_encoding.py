"""The port's parameters and encoders against the JAX package (CPU).

Encoding is compared residue for residue (``np.array_equal``): both
packages round ``v * scale`` in numpy float64 and split the same
integers.  Decoding is compared value for value (``==`` on float64): the
same residues give the same big integers, and both convert them exactly
while they stay below 2^53.
"""

import numpy as np
import pytest
import torch

from optimal_conv_tpu.ckks import encoding as jenc
from optimal_conv_tpu.ckks import params as jparams
from optimal_conv_tpu.ckks.params import CkksParams as JaxParams

from optimal_conv_tpu_torch import interop
from optimal_conv_tpu_torch.ckks import encoding as tenc
from optimal_conv_tpu_torch.ckks import params as tparams
from optimal_conv_tpu_torch.ckks.params import CkksParams, DeviceTables

CPU = torch.device("cpu")
SPEC = dict(log_n=10, logq=(50, 40, 40, 40, 40), logp=(55, 55), log_scale=30,
            h=64)

# The suite runs in several pytest workers at once; PyTorch's intra-op
# threads on top of them oversubscribe the cores (a 4 s test took 490 s
# under six workers), so each worker keeps one.
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def encoders():
    jp, tp = JaxParams(**SPEC), CkksParams(**SPEC)
    return jenc.Encoder(jp), tenc.Encoder(tp, DeviceTables(tp, CPU))


def _slots(n, seed):
    rng = np.random.default_rng(seed)
    return rng.uniform(-1, 1, n) + 1j * rng.uniform(-1, 1, n)


@pytest.mark.parametrize("name,args", [
    ("boot_params", (12,)), ("mini_boot_params", (10, 14)),
    ("mini_boot_params", (10, 2, 9, 3)), ("tiny_params", (10, 3))])
def test_presets_match_jax(name, args):
    jp, tp = getattr(jparams, name)(*args), getattr(tparams, name)(*args)
    assert tp.moduli == jp.moduli and tp.boot_layout == jp.boot_layout
    assert (tp.slots, tp.log_slots, tp.max_level, tp.scale, tp.h) == \
        (jp.slots, jp.log_slots, jp.max_level, jp.scale, jp.h)
    for level in range(tp.max_level + 1):
        assert tp.digits(level) == jp.digits(level)
        assert tp.qp_idx(level) == jp.qp_idx(level)
    hash(tp)                                  # the layout dict stays out of it


def test_boot_layout_relu_span():
    """The production chain allots the ReLU exactly its 11 tight levels,
    above the repack level."""
    lay = tparams.boot_params(16).boot_layout
    assert lay["relu"] == (5, 16) and lay["repack"] == 4


@pytest.mark.parametrize("log_slots", [3, 9])
def test_embedding_matches_jax(log_slots):
    assert np.array_equal(tenc._rot_group(log_slots), jenc._rot_group(log_slots))
    z = _slots(1 << log_slots, log_slots)
    c = tenc.slots_to_coeffs_np(z)
    assert np.array_equal(c, jenc.slots_to_coeffs_np(z))
    back = tenc.coeffs_to_slots_np(c)
    assert np.array_equal(back, jenc.coeffs_to_slots_np(c))
    np.testing.assert_allclose(back, z, atol=1e-12)      # float64 round trip


@pytest.mark.parametrize("kw", [
    dict(level=4), dict(level=2, mont=False), dict(level=3, log_slots=5),
    dict(level=3, qp=True), dict(level=0, log_slots=7, qp=True, mont=False)],
    ids=["plain", "standard_form", "sparse_slots", "qp", "qp_sparse_l0"])
def test_encode_slots_bit_exact(encoders, kw):
    jenc_, tenc_ = encoders
    n_slots = 1 << kw.get("log_slots", SPEC["log_n"] - 1)
    z = _slots(n_slots, 3)[: n_slots - 5]                # zero-padded tail
    level = kw.pop("level")
    want = jenc_.encode_slots(z, 2.0**30, level, **kw)
    got = tenc_.encode_slots(z, 2.0**30, level, **kw)
    assert got.level == want.level and got.scale == want.scale
    assert got.is_mont == want.is_mont
    rows = level + 1 + (len(SPEC["logp"]) if kw.get("qp") else 0)
    assert got.poly.shape == (rows, 1 << SPEC["log_n"])
    assert np.array_equal(interop.to_numpy(got.poly), np.asarray(want.poly))


def test_encode_coeffs_still_bit_exact(encoders):
    jenc_, tenc_ = encoders
    v = np.random.default_rng(4).uniform(-1, 1, 1000)
    want = jenc_.encode_coeffs(v, 2.0**30, 1)
    got = tenc_.encode_coeffs(v, 2.0**30, 1)
    assert np.array_equal(interop.to_numpy(got.poly), np.asarray(want.poly))


@pytest.mark.parametrize("level,log_slots", [(0, None), (4, None), (2, 6)])
def test_decode_bit_exact(encoders, level, log_slots):
    """The same coefficient-domain residues decode to the same float64
    coefficients and the same complex slots (level > 0 goes through the
    CRT on both sides)."""
    jenc_, tenc_ = encoders
    jp = jenc_.params
    rng = np.random.default_rng(level)
    ints = rng.integers(-2**45, 2**45, jp.n)
    res = np.stack([np.mod(ints, q) for q in jp.q_moduli[: level + 1]]
                   ).astype(np.uint64)
    want_c = jenc_.decode_coeffs(res, 2.0**30)
    got_c = tenc_.decode_coeffs(res.view(np.int64), 2.0**30)
    assert got_c.dtype == np.float64 and np.array_equal(got_c, want_c)
    assert np.array_equal(got_c, ints / 2.0**30)
    want_s = jenc_.decode_slots(res, 2.0**30, log_slots)
    got_s = tenc_.decode_slots(res.view(np.int64), 2.0**30, log_slots)
    assert got_s.shape == want_s.shape and np.array_equal(got_s, want_s)


def test_slot_roundtrip_through_the_ring(encoders):
    """encode_slots → iNTT → decode_slots gives the slots back to the
    rounding of the encoding (2^-30 a coefficient; 1e-6 on a slot)."""
    _, tenc_ = encoders
    z = _slots(512, 8)
    pt = tenc_.encode_slots(z, 2.0**30, 2, mont=False)
    coeff = tenc_.tables.ntt.intt(pt.poly, tenc_.params.q_idx(2)).numpy()
    np.testing.assert_allclose(tenc_.decode_slots(coeff, 2.0**30), z, atol=1e-6)
