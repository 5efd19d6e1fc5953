"""The port's conv slice against the JAX package (CPU, plain versions).

Residue-level tests compare exactly: with the same secret key, the same
Galois keys (imported from the JAX context) and the same input
ciphertext, the port's evaluator computes the same integers.  Tests with
the port's own switching keys compare decrypted values, to the bars the
JAX package's own tests use, because the two key sets carry independent
noise.
"""

import numpy as np
import pytest
import torch

from optimal_conv_tpu.ckks.context import CkksContext as JaxContext
from optimal_conv_tpu.ckks.params import CkksParams as JaxParams
from optimal_conv_tpu.ops import conv as jconv
from optimal_conv_tpu.utils.serialization import save_ciphertext, save_keys

from optimal_conv_tpu_torch import interop
from optimal_conv_tpu_torch.ckks.context import CkksContext
from optimal_conv_tpu_torch.ckks.params import CkksParams
from optimal_conv_tpu_torch.models.resnet import (ResNetConfig,
                                                  encrypt_fc_input, fc_conv)
from optimal_conv_tpu_torch.ops import conv as convops

CPU = torch.device("cpu")
# the conv-only parameters of tests/test_ops_conv.py (levels {0, 1})
SPEC = dict(log_n=12, logq=(60, 45), logp=(61,), log_scale=30, h=128)
SEED = 9

# The suite runs in several pytest workers at once; PyTorch's intra-op
# threads on top of them oversubscribe the cores (a 4 s test took 490 s
# under six workers), so each worker keeps one.
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def jctx():
    return JaxContext(JaxParams(**SPEC), seed=SEED)


@pytest.fixture(scope="module")
def tctx():
    return CkksContext(CkksParams(**SPEC), CPU, seed=SEED)


def _u64(t):
    return interop.to_numpy(t)


def _pack_galois(n, in_wid, norm):
    max_batch = n // (in_wid * in_wid)
    return [(1 << j) + 1 for _, _, j in
            convops._pack_steps(SPEC["log_n"], max_batch, norm)]


def _conv_case(in_wid, ker_wid, real_ib, real_ob, seed, norm=1):
    rng = np.random.default_rng(seed)
    raw_wid = in_wid - ker_wid // 2
    img = rng.uniform(-1, 1, (raw_wid, raw_wid, real_ib))
    ker = rng.uniform(-1, 1, (ker_wid, ker_wid, real_ib, real_ob)) / ker_wid**2
    bn_a = rng.uniform(0.5, 1.5, real_ob)
    bn_b = rng.uniform(-0.5, 0.5, real_ob)
    return img, ker, bn_a, bn_b


def test_encrypt_and_sk_match_jax(jctx, tctx):
    """Same seed → same secret key and, drawing in the same order, the
    same ciphertext of the same plaintext."""
    assert np.array_equal(tctx._sk_ints, jctx._sk_ints)
    vals = np.random.default_rng(0).uniform(-1, 1, 1 << SPEC["log_n"])
    jct = JaxContext(JaxParams(**SPEC), seed=3).encrypt(
        jctx.encoder.encode_coeffs(vals, 2.0**30, 1))
    tct = CkksContext(CkksParams(**SPEC), CPU, seed=3).encrypt(
        tctx.encoder.encode_coeffs(vals, 2.0**30, 1))
    assert np.array_equal(_u64(tct.c0), np.asarray(jct.c0))
    assert np.array_equal(_u64(tct.c1), np.asarray(jct.c1))
    # the encoders agree; a plaintext carried across encrypts the same
    jpt = jctx.encoder.encode_coeffs(vals, 2.0**30, 0, mont=False)
    tpt = interop.plaintext_from_arrays(tctx, np.asarray(jpt.poly), 0, 2.0**30,
                                        is_mont=False)
    assert torch.equal(tpt.poly, tctx.encoder.encode_coeffs(
        vals, 2.0**30, 0, mont=False).poly)


def test_evaluator_ops_match_jax(jctx, tmp_path):
    """rescale, mul_monomial, add/sub and a level-1 Galois key switch on
    imported keys and ciphertexts are bit-exact."""
    p = jctx.params
    vals = np.random.default_rng(1).uniform(-1, 1, p.n)
    jct = jctx.encrypt(jctx.encoder.encode_coeffs(vals, p.scale, 1))
    g = 5
    jctx.galois_key(g, 1)
    save_keys(str(tmp_path / "keys.npz"), jctx)
    save_ciphertext(str(tmp_path / "ct.npz"), jct)
    tctx = CkksContext(CkksParams(**SPEC), CPU, seed=123)
    assert interop.load_keys(str(tmp_path / "keys.npz"), tctx) >= 1
    tct = interop.load_ciphertext(tctx, str(tmp_path / "ct.npz"))

    def same(t, j):
        assert t.level == j.level and t.scale == j.scale
        assert np.array_equal(_u64(t.c0), np.asarray(j.c0))
        assert np.array_equal(_u64(t.c1), np.asarray(j.c1))

    same(tctx.rescale(tct), jctx.rescale(jct))
    same(tctx.mul_monomial(tct, 3), jctx.mul_monomial(jct, 3))
    same(tctx.mul_monomial(tct, -5), jctx.mul_monomial(jct, -5))
    same(tctx.sub(tct, tctx.add(tct, tct)), jctx.sub(jct, jctx.add(jct, jct)))
    same(tctx.apply_galois(tct, g), jctx.apply_galois(jct, g))
    np.testing.assert_array_equal(tctx.decrypt_to_coeffs(tct).view(np.uint64),
                                  jctx.decrypt_to_coeffs(jct))


def test_pack_ctxts_bit_exact(jctx):
    """The unfused pack butterfly on imported keys and ciphertexts."""
    p = jctx.params
    rng = np.random.default_rng(12)
    jcts = [jctx.encrypt(jctx.encoder.encode_coeffs(
        rng.uniform(-1, 1, p.n), p.scale, 0)) for _ in range(4)]
    want = jconv.pack_ctxts(jctx, jcts, 4, 2)
    tctx = CkksContext(CkksParams(**SPEC), CPU, seed=0)
    interop.load_secret_key(tctx, jctx._sk_ints)
    g = (1 << (SPEC["log_n"] - 1)) + 1
    swk = jctx.galois_key(g, 0)
    interop.load_switching_keys(tctx, {("gal", g, 0): (
        np.asarray(swk.d0), np.asarray(jctx.swk_d1(swk)))})
    tcts = [interop.ciphertext_from_arrays(tctx, np.asarray(c.c0),
                                           np.asarray(c.c1), 0, c.scale)
            for c in jcts]
    got = convops.pack_ctxts(tctx, tcts, 4, 2)
    assert got.scale == want.scale
    assert np.array_equal(_u64(got.c0), np.asarray(want.c0))
    assert np.array_equal(_u64(got.c1), np.asarray(want.c1))


@pytest.mark.parametrize("ker_wid,norm", [(3, 1), (5, 1), (3, 2), (5, 2)])
def test_eval_conv_bn_bit_exact(jctx, ker_wid, norm):
    """(a) Same sk, JAX's Galois keys and a JAX-encrypted input: the
    port's eval_conv_bn output ciphertext equals JAX's, residue for
    residue."""
    p = jctx.params
    in_wid, nch = 16, 16 // norm
    img, ker, bn_a, bn_b = _conv_case(in_wid, ker_wid, nch, nch, 40 + ker_wid,
                                      norm)
    inp = jconv.prep_input(img.ravel(), in_wid - ker_wid // 2, in_wid, p.n,
                           norm)
    jct = jctx.encrypt(jctx.encoder.encode_coeffs(inp, p.scale, 1))
    keys = {}
    for g in _pack_galois(p.n, in_wid, norm):
        swk = jctx.galois_key(g, 0)
        keys[("gal", g, 0)] = (np.asarray(swk.d0), np.asarray(jctx.swk_d1(swk)))
    want = jconv.eval_conv_bn(jctx, jct, ker.ravel(), bn_a, bn_b, in_wid,
                              ker_wid, nch, nch, norm, float(1 << 30))

    tctx = CkksContext(CkksParams(**SPEC), CPU, seed=0)
    interop.load_secret_key(tctx, jctx._sk_ints)
    interop.load_switching_keys(tctx, keys)
    tct = interop.ciphertext_from_arrays(tctx, np.asarray(jct.c0),
                                         np.asarray(jct.c1), jct.level,
                                         jct.scale)
    got = convops.eval_conv_bn(tctx, tct, ker.ravel(), bn_a, bn_b, in_wid,
                               ker_wid, nch, nch, norm, float(1 << 30))
    assert got.level == want.level == 0 and got.scale == want.scale
    assert np.array_equal(_u64(got.c0), np.asarray(want.c0))
    assert np.array_equal(_u64(got.c1), np.asarray(want.c1))


@pytest.mark.parametrize("ker_wid,norm,trans", [(3, 1, False), (5, 2, False),
                                                (3, 1, True)])
def test_eval_conv_bn_port_keys(tctx, ker_wid, norm, trans):
    """(b) The port's own keys: decrypted outputs agree with the numpy
    conv to 2e-3, the bar of tests/test_ops_conv.py (the scheme's noise
    at scale 2^30 is far below it; the bar catches layout errors)."""
    p = tctx.params
    in_wid = 16
    batch = p.n // (in_wid * in_wid)
    if trans:
        raw, nout = 6, batch // 4
        img, ker, bn_a, bn_b = _conv_case(in_wid, ker_wid, batch, nout, 7)
        img = img[:raw, :raw]
        inp = convops.prep_input(img.ravel(), raw, in_wid, p.n, 1, trans=True)
        ct = tctx.encrypt(tctx.encoder.encode_coeffs(inp, p.scale, 1))
        out = convops.eval_conv_bn(tctx, ct, ker.transpose(0, 1, 3, 2).ravel(),
                                   bn_a, bn_b, in_wid, ker_wid, batch, nout, 1,
                                   float(1 << 30), trans=True)
        got = tctx.decrypt_decode_coeffs(out).reshape(in_wid, in_wid, batch)
        dil = np.zeros((in_wid, in_wid, batch))
        dil[1::2, 1::2][:raw, :raw] = img
        want = convops.conv2d_same_np(dil, ker[::-1, ::-1]) * bn_a + bn_b
        np.testing.assert_allclose(got[:, :, :nout], want, atol=2e-3)
        return
    nch = batch // norm
    raw_wid = in_wid - ker_wid // 2
    img, ker, bn_a, bn_b = _conv_case(in_wid, ker_wid, nch, nch, 8, norm)
    inp = convops.prep_input(img.ravel(), raw_wid, in_wid, p.n, norm)
    ct = tctx.encrypt(tctx.encoder.encode_coeffs(inp, p.scale, 1))
    out = convops.eval_conv_bn(tctx, ct, ker.ravel(), bn_a, bn_b, in_wid,
                               ker_wid, nch, nch, norm, float(1 << 30))
    got = convops.post_process(tctx.decrypt_decode_coeffs(out), raw_wid, in_wid)
    got = got.reshape(raw_wid, raw_wid, batch)[:, :, ::norm][:, :, :nch]
    want = convops.conv2d_same_np(img, ker) * bn_a + bn_b
    np.testing.assert_allclose(got, want, atol=2e-3)


def test_host_layout_matches_jax():
    """The vectorised numpy layout helpers equal the JAX package's loops."""
    rng = np.random.default_rng(5)
    for trans in (False, True):
        raw = rng.uniform(-1, 1, 7 * 7 * 16)
        np.testing.assert_array_equal(
            convops.prep_input(raw, 7, 16, 4096, 1, trans),
            jconv.prep_input(raw, 7, 16, 4096, 1, trans))
        ker = rng.uniform(-1, 1, 9 * 8 * 4)
        np.testing.assert_array_equal(convops.reshape_ker(ker, 9, 4, trans),
                                      jconv.reshape_ker(ker, 9, 4, trans))
    cfs = rng.uniform(-1, 1, 4096)
    np.testing.assert_array_equal(convops.post_process(cfs, 13, 16),
                                  jconv.post_process(cfs, 13, 16))
    big = rng.uniform(-1, 1, (16, 16 * 25))
    for i in (0, 3):
        np.testing.assert_array_equal(
            convops.encode_ker_final(big, i, 16, 16, 5),
            jconv.encode_ker_final(big, 0, i, 16, 16, 5))


def test_fc_head_small(tctx):
    """(c) ResNet FC head at logN 12: in_wid 8, 4 channels at stride 16,
    kw 7, 4 logits.  Agrees with mean-pool + FC in numpy to 2e-3 (the
    conv bar; the error is the scheme's noise, far below it)."""
    cfg = ResNetConfig(in_wids=(32, 16, 8), real_batch=(1, 2, 4), fc_out=4)
    rng = np.random.default_rng(11)
    raw = cfg.raw_in_wids[2]
    x = rng.uniform(-1, 1, (raw, raw, 4))
    fc_w = rng.normal(0, 0.5, (4, 4))
    fc_b = rng.normal(0, 0.1, 4)
    logits = fc_conv(tctx, cfg, encrypt_fc_input(tctx, cfg, x), fc_w, fc_b)
    np.testing.assert_allclose(logits, x.mean((0, 1)) @ fc_w + fc_b, atol=2e-3)
