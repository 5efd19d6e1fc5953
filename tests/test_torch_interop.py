"""The port's archive writers (``interop.save_ciphertext``, ``save_keys``)
against both packages' readers (CPU).

The archives are the JAX package's format (``utils/serialization.py``):
the port writes them, the port's readers and the JAX package's read
them back bit for bit.  The JAX context that reads the key archive holds
the port's secret key (the same seed draws the same key in both
packages).  logN 8, as ``tests/test_serialization.py``.
"""

import numpy as np
import pytest
import torch

from optimal_conv_tpu.ckks.context import CkksContext as JaxContext
from optimal_conv_tpu.ckks.params import tiny_params as jax_tiny
from optimal_conv_tpu.core.ntt import galois_perm_ntt as jax_perm
from optimal_conv_tpu.utils import serialization as jser

from optimal_conv_tpu_torch import interop
from optimal_conv_tpu_torch.ckks.context import CkksContext
from optimal_conv_tpu_torch.ckks.params import tiny_params

CPU = torch.device("cpu")
SEED = 7
ROTS = (1, 3)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def tctx():
    """A port context holding relinearisation, Galois and pre-permuted
    hoisting keys at two levels."""
    p = tiny_params(log_n=8, levels=3)
    ctx = CkksContext(p, CPU, seed=SEED)
    lvl = p.max_level
    ctx.relin_key(lvl)
    ctx.rot_key(4, lvl - 1)
    msg = np.sin(np.arange(p.n))
    ct = ctx.encrypt(ctx.encoder.encode_coeffs(msg, p.scale, lvl))
    ctx.rotate_hoisted(ct, list(ROTS))
    assert {t[0] for t in ctx.switching_keys} == {"rlk", "gal", "galh"}
    return ctx


def _encrypt(ctx, seed=0):
    p = ctx.params
    msg = np.random.default_rng(seed).uniform(-1, 1, p.n)
    return msg, ctx.encrypt(ctx.encoder.encode_coeffs(msg, p.scale,
                                                      p.max_level))


def test_ciphertext_archive_read_by_both(tmp_path, tctx):
    """The port's save_ciphertext, read by JAX's load_ciphertext and the
    port's: the same residues, level and scale, and it decrypts."""
    msg, ct = _encrypt(tctx)
    path = str(tmp_path / "ct.npz")
    interop.save_ciphertext(path, ct)
    j = jser.load_ciphertext(path)
    assert j.is_ntt and j.level == ct.level and j.scale == ct.scale
    assert np.array_equal(np.asarray(j.c0), interop.to_numpy(ct.c0))
    assert np.array_equal(np.asarray(j.c1), interop.to_numpy(ct.c1))
    t = interop.load_ciphertext(tctx, path)
    assert t.level == ct.level and t.scale == ct.scale
    assert torch.equal(t.c0, ct.c0) and torch.equal(t.c1, ct.c1)
    np.testing.assert_allclose(tctx.decrypt_decode_coeffs(t), msg, atol=1e-5)


def test_key_archive_read_by_the_port(tmp_path, tctx):
    """save_keys then load_keys into a context of another seed: the same
    secret key and every key bit for bit; a single and a hoisted rotation
    then run on the loaded keys alone, make none, and decrypt as the
    original context's."""
    path = str(tmp_path / "keys.npz")
    interop.save_keys(path, tctx)
    p = tctx.params
    other = CkksContext(p, CPU, seed=SEED + 1)
    assert interop.load_keys(path, other) == len(tctx.switching_keys)
    assert np.array_equal(other._sk_ints, tctx._sk_ints)
    assert list(other.switching_keys) == list(tctx.switching_keys)
    for tag, swk in tctx.switching_keys.items():
        got = other.switching_keys[tag]
        assert got.level == swk.level
        assert torch.equal(got.d0, swk.d0) and torch.equal(got.d1, swk.d1)
    held = dict(other.switching_keys)
    msg, ct = _encrypt(tctx, seed=1)
    want = tctx.decrypt_decode_coeffs(tctx.rotate(ct, ROTS[0]))
    got = other.decrypt_decode_coeffs(other.rotate(ct, ROTS[0]))
    hoisted = other.rotate_hoisted(ct, list(ROTS))
    assert other.switching_keys.keys() == held.keys(), "a key was made"
    np.testing.assert_array_equal(got, want)
    for r in ROTS:
        np.testing.assert_array_equal(
            other.decrypt_decode_coeffs(hoisted[r]),
            tctx.decrypt_decode_coeffs(tctx.rotate_hoisted(ct, [r])[r]))


def test_key_archive_read_by_jax(tmp_path, tctx):
    """The same archive through JAX's load_keys on a JAX context that
    holds the port's secret key: every key's d0 and d1 bit for bit, its
    level, no seed, and the "galh" keys with their NTT-domain
    permutation by φ_g⁻¹ (JAX's own ``galois_perm_ntt``)."""
    path = str(tmp_path / "keys.npz")
    interop.save_keys(path, tctx)
    p = tctx.params
    jctx = JaxContext(jax_tiny(log_n=8, levels=3), seed=SEED)
    assert np.array_equal(jctx._sk_ints, tctx._sk_ints)
    assert jser.load_keys(path, jctx) == len(tctx.switching_keys)
    assert list(jctx._swk_cache.d) == list(tctx.switching_keys)
    for tag, swk in tctx.switching_keys.items():
        got = jctx._swk_cache.d[tag]
        assert got.level == swk.level and got.seed is None
        assert np.array_equal(np.asarray(got.d0), interop.to_numpy(swk.d0))
        assert np.array_equal(np.asarray(jctx.swk_d1(got)),
                              interop.to_numpy(swk.d1))
        if tag[0] == "galh":
            g_inv = pow(tag[1], -1, 2 * p.n)
            assert np.array_equal(np.asarray(got.perm),
                                  jax_perm(p.log_n, g_inv))
        else:
            assert got.perm is None


def _from_jax(ctx, jct):
    return interop.ciphertext_from_arrays(ctx, np.asarray(jct.c0),
                                          np.asarray(jct.c1), jct.level,
                                          jct.scale)


def _same_as_jax(tct, jct):
    assert (tct.level, tct.scale) == (jct.level, jct.scale)
    assert np.array_equal(interop.to_numpy(tct.c0), np.asarray(jct.c0))
    assert np.array_equal(interop.to_numpy(tct.c1), np.asarray(jct.c1))


def test_compressed_jax_archive_read_by_the_port(tmp_path, monkeypatch):
    """A JAX context with seed-compressed keys (OPTCONV_COMPRESS_KEYS=1 for
    this test only, as tests/test_key_cache.py's fixture sets it) writes
    save_keys; the port reads d0, seed and permutation, regenerates d1,
    and its rotation, hoisted rotation and ct × ct product on those keys
    equal JAX's bit for bit, making no key."""
    monkeypatch.setenv("OPTCONV_COMPRESS_KEYS", "1")
    p = jax_tiny(log_n=8, levels=3)
    jctx = JaxContext(p, seed=SEED + 2)
    lvl = p.max_level
    msg = np.random.default_rng(4).uniform(-1, 1, p.n)
    jct = jctx.encrypt(jctx.encoder.encode_coeffs(msg, p.scale, lvl))
    jrot = jctx.rotate(jct, ROTS[0])
    jhoist = jctx.rotate_hoisted(jct, list(ROTS))
    jmul = jctx.mul_ct(jct, jct)
    assert all(k.d1 is None for k in jctx._swk_cache.d.values())
    assert {t[0] for t in jctx._swk_cache.d} == {"rlk", "gal", "galh"}
    path = str(tmp_path / "jax_keys.npz")
    jser.save_keys(path, jctx)

    tctx = CkksContext(tiny_params(log_n=8, levels=3), CPU, seed=SEED + 3)
    assert interop.load_keys(path, tctx) == len(jctx._swk_cache.d)
    held = dict(tctx.switching_keys)
    for tag, jk in jctx._swk_cache.d.items():
        tk = tctx.switching_keys[tag]
        assert tk.d1 is None and tk.seed == jk.seed
        assert np.array_equal(interop.to_numpy(tctx.swk_d1(tk)),
                              np.asarray(jctx.swk_d1(jk)))
    ct = _from_jax(tctx, jct)
    _same_as_jax(tctx.rotate(ct, ROTS[0]), jrot)
    hoisted = tctx.rotate_hoisted(ct, list(ROTS))
    for r in ROTS:
        _same_as_jax(hoisted[r], jhoist[r])
    _same_as_jax(tctx.mul_ct(ct, ct), jmul)
    assert tctx.switching_keys.keys() == held.keys(), "the port made a key"


def test_compressed_port_archive_read_by_jax(tmp_path):
    """The port's compressed keys written by save_keys (d0, seed, the
    "galh" permutation, no d1) and read by JAX's load_keys: JAX
    regenerates the port's d1 bit for bit, and its rotations and product
    on those keys equal the port's."""
    p = tiny_params(log_n=8, levels=3)
    tctx = CkksContext(p, CPU, seed=SEED + 4, compress_keys=True)
    lvl = p.max_level
    msg = np.random.default_rng(5).uniform(-1, 1, p.n)
    ct = tctx.encrypt(tctx.encoder.encode_coeffs(msg, p.scale, lvl))
    trot = tctx.rotate(ct, ROTS[0])
    thoist = tctx.rotate_hoisted(ct, list(ROTS))
    tmul = tctx.mul_ct(ct, ct)
    assert {t[0] for t in tctx.switching_keys} == {"rlk", "gal", "galh"}
    path = str(tmp_path / "port_keys.npz")
    interop.save_keys(path, tctx)

    jctx = JaxContext(jax_tiny(log_n=8, levels=3), seed=SEED + 4)
    assert jser.load_keys(path, jctx) == len(tctx.switching_keys)
    assert list(jctx._swk_cache.d) == list(tctx.switching_keys)
    for tag, tk in tctx.switching_keys.items():
        jk = jctx._swk_cache.d[tag]
        assert jk.d1 is None and jk.seed == tk.seed
        assert (jk.perm is not None) == (tag[0] == "galh")
        assert np.array_equal(np.asarray(jk.d0), interop.to_numpy(tk.d0))
        assert np.array_equal(np.asarray(jctx.swk_d1(jk)),
                              interop.to_numpy(tctx.swk_d1(tk)))
    jct = jctx.encrypt(jctx.encoder.encode_coeffs(msg, p.scale, lvl))
    _same_as_jax(ct, jct)
    held = set(jctx._swk_cache.d)
    _same_as_jax(trot, jctx.rotate(jct, ROTS[0]))
    jhoist = jctx.rotate_hoisted(jct, list(ROTS))
    for r in ROTS:
        _same_as_jax(thoist[r], jhoist[r])
    _same_as_jax(tmul, jctx.mul_ct(jct, jct))
    assert set(jctx._swk_cache.d) == held, "JAX made a key"
