"""The port's copy of the special-FFT stage factorisation against the JAX
package's module, and the BSGS baby-step choice on the key sets of every
bootstrap transform.  ``ckks/dft.py`` is pure numpy and was copied; this
pins that the copy stays equal."""

import numpy as np
import pytest

from optimal_conv_tpu.ckks import bootstrap as jboot
from optimal_conv_tpu.ckks import dft as jdft

from optimal_conv_tpu_torch.ckks import bootstrap as tboot
from optimal_conv_tpu_torch.ckks import dft as tdft


def _same_stages(a, b):
    assert len(a) == len(b)
    for sa, sb in zip(a, b):
        assert list(sa) == list(sb)               # keys, in insertion order
        for k in sa:
            assert np.array_equal(sa[k], sb[k])


@pytest.mark.parametrize("log_n", [4, 9])
@pytest.mark.parametrize("which", ["encode_stages", "decode_stages"])
def test_stages_equal(which, log_n):
    _same_stages(getattr(tdft, which)(log_n), getattr(jdft, which)(log_n))


@pytest.mark.parametrize("log_n", [4, 9])
@pytest.mark.parametrize("n_groups", [2, 3])
def test_group_stages_and_tile_equal(log_n, n_groups):
    n = 1 << (log_n + 1)                          # the full slot view
    t = [tdft.tile(s, 2) for s in tdft.encode_stages(log_n)]
    j = [jdft.tile(s, 2) for s in jdft.encode_stages(log_n)]
    _same_stages(t, j)
    _same_stages(tdft.group_stages(t, n_groups, n),
                 jdft.group_stages(j, n_groups, n))


def test_apply_diags_equal():
    rng = np.random.default_rng(0)
    z = rng.uniform(-1, 1, 16) + 1j * rng.uniform(-1, 1, 16)
    for st_t, st_j in zip(tdft.decode_stages(4), jdft.decode_stages(4)):
        assert np.array_equal(tdft.apply_diags_np(st_t, z),
                              jdft.apply_diags_np(st_j, z))


@pytest.mark.parametrize("log_sparse", [0, 1, 2])
def test_bsgs_split_on_the_bootstrap_key_sets(log_sparse):
    """The baby-step modulus, the babies and the giants of every CtoS and
    StoC group at logN 10 (3 CtoS levels, 2 StoC levels), in both packages."""
    log_slots = 9
    n = 1 << log_slots
    log_nsub = log_slots - log_sparse
    reps = n >> log_nsub
    enc = [tdft.tile(s, reps) for s in tdft.encode_stages(log_nsub)]
    dec = [tdft.tile(s, reps) for s in tdft.decode_stages(log_nsub)]
    groups = tdft.group_stages(enc, 3 - (1 if log_sparse else 0), n) \
        + tdft.group_stages(dec, 2, n)
    assert groups
    for g in groups:
        keys = sorted(k % n for k in g)
        bs = tboot._bsgs_bs(keys)
        assert bs == jboot._bsgs_bs(keys)
        babies = {k % bs for k in keys}
        giants = {k // bs for k in keys}
        # balanced on the stride lattice: neither side holds every key
        assert len(babies) * len(giants) >= len(keys)
        assert max(len(babies), len(giants)) <= max(2, len(keys) - 1) \
            or len(keys) <= 2
    assert tboot._bsgs_bs([0]) == jboot._bsgs_bs([0]) == 1
    assert tboot._cheb_depth(31) == jboot._cheb_depth(31)
