"""The port's ImageNet tail runners (``models/imagenet.py``) and the RMFC
head's ``in_norm`` against the JAX package (CPU).

What is cheap is compared with JAX exactly: both runners' tables and
the vector ``encrypt_input`` encodes at the JAX minis' widths (logN 10)
and at the real ones (logN 16: 256 → 512 channels), the whole call
sequence of ``infer_features`` and ``infer_logits`` at logN 16 with
``num_blc=(3, 3)`` (a recorder stands in for the fused layer and the
head's conv in both runner modules, so nothing bootstraps), ``prep_ker``
with ``in_norm`` and the RMFC head's conv on one ciphertext.  The
runners' layout helpers, which ``chip_smoke.py`` uses to feed and read
each layer, are held against the repack mirror of every layer.

The whole runners at logN 10 and the ``TransConv`` layer of
``tests/test_pipeline_transconv.py`` run the port alone, in the
``slow_e2e`` tier (``OPTCONV_SLOW=1``): the JAX side of one of them
takes minutes on the CPU.
"""

import inspect
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optimal_conv_tpu.ckks import context as jcontext
from optimal_conv_tpu.ckks.params import CkksParams as JaxParams
from optimal_conv_tpu.ckks.params import boot_params as jax_boot
from optimal_conv_tpu.ckks.params import mini_boot_params as jax_mini
from optimal_conv_tpu.ckks.types import Ciphertext as JaxCiphertext
from optimal_conv_tpu.models import imagenet as jimg
from optimal_conv_tpu.ops import conv as jconv
from optimal_conv_tpu.utils import serialization as jser

from optimal_conv_tpu_torch import interop
from optimal_conv_tpu_torch.ckks.bootstrap import SplitBootstrapper
from optimal_conv_tpu_torch.ckks.context import CkksContext
from optimal_conv_tpu_torch.ckks.params import (CkksParams, boot_params,
                                                mini_boot_params)
from optimal_conv_tpu_torch.models import imagenet as timg
from optimal_conv_tpu_torch.models.plain import conv_bn_relu_plain
from optimal_conv_tpu_torch.ops import conv as convops
from optimal_conv_tpu_torch.ops import repack as rp
from optimal_conv_tpu_torch.ops.debug import DebugOracle
from optimal_conv_tpu_torch.ops.pipeline import LayerMaps, eval_conv_bn_relu
from optimal_conv_tpu_torch.ops.relu import relu_np

CPU = torch.device("cpu")
SEED = 23
BOOT = dict(k_range=12.0, sin_deg=31, double_angle=3)
RUNNERS = ["ImagenetTailRunner", "ImagenetFinalFastRunner"]
# two primes on the logN-10 ring: all the head's conv needs
CHAIN = dict(log_n=10, logq=(50, 40), logp=(55,), log_scale=25, h=64)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def ctxs():
    """The JAX and the port context on the same seed: the same secret key."""
    return (jcontext.CkksContext(JaxParams(**CHAIN), seed=SEED),
            CkksContext(CkksParams(**CHAIN), CPU, seed=SEED))


def _same(a, b):
    """Equal values, arrays and repack tables included."""
    if type(a).__name__ == "LayerMaps":
        for f in ("ext_idx", "r_idx", "r_idx_l", "m_idx", "m_idx_l"):
            _same(getattr(a, f), getattr(b, f))
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, dict):
        assert list(a) == list(b)
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        assert np.array_equal(a, b)
    else:
        assert a == b, (a, b)


class _Encoder:
    """Records what encrypt_input encodes; encryption is the identity."""

    def encode_coeffs(self, v, scale, level):
        return (np.array(v), scale, level)


def _stub(params):
    """A context with the geometry of `params` and no keys."""
    return SimpleNamespace(params=params, encoder=_Encoder(),
                           encrypt=lambda pt: pt)


def _weights(b0, b1, seed, n_out=None):
    """The JAX minis' draws (tests/test_imagenet_mini.py), num_blc (1, 1)."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-0.8, 0.8, (14, 14, b0))
    convs = [rng.uniform(-1, 1, (3, 3, b0, b0)) / 5.0,
             rng.uniform(-1, 1, (3, 3, b0, b1)) / 5.0,
             rng.uniform(-1, 1, (3, 3, b1, b1)) / 5.0]
    bn_a = [rng.uniform(0.8, 1.2, k.shape[-1]) for k in convs]
    bn_b = [rng.uniform(-0.2, 0.2, k.shape[-1]) for k in convs]
    fc = None
    if n_out:
        fc = (rng.normal(0, 1.0, (b1, n_out)), rng.normal(0, 0.3, n_out))
    return x, convs, bn_a, bn_b, fc


def _deep_weights(b0, b1, num_blc, seed, n_out):
    """Seeded weights of num_blc[0] + 1 + num_blc[1] layers and the head."""
    rng = np.random.default_rng(seed)
    shapes = ([(b0, b0)] * num_blc[0] + [(b0, b1)] + [(b1, b1)] * num_blc[1])
    convs = [rng.uniform(-1, 1, (3, 3, i, o)) / np.sqrt(9 * i)
             for i, o in shapes]
    bn_a = [rng.uniform(0.8, 1.2, o) for _, o in shapes]
    bn_b = [rng.uniform(-0.2, 0.2, o) for _, o in shapes]
    x = rng.uniform(-1, 1, (14, 14, b0))
    return (x, convs, bn_a, bn_b,
            rng.normal(0, 1 / np.sqrt(b1), (b1, n_out)),
            rng.normal(0, 0.3, n_out))


# ---------------------------------------------------------------------------
# tables and the encoded input
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("log_n", [10, 16])
@pytest.mark.parametrize("name", RUNNERS)
def test_tables_and_encoded_input_equal_jax(name, log_n):
    """Widths, real_batch, norms, log_sparse, every map of keep_maps and
    str_maps and the vector encrypt_input encodes, at the minis' widths
    (logN 10: 4 → 8 channels) and the real ones (logN 16: 256 → 512)."""
    jp = jax_mini(10, n_relu=14) if log_n == 10 else jax_boot(16)
    tp = mini_boot_params(10, n_relu=14) if log_n == 10 else boot_params(16)
    jr = getattr(jimg, name)(_stub(jp), 3, BOOT)
    tr = getattr(timg, name)(_stub(tp), 3, BOOT)
    fields = ["in_wids", "kp_wids", "real_batch", "num_blc", "keep_maps",
              "str_maps"]
    if name == "ImagenetTailRunner":
        fields += ["norm", "log_sparse"]
    else:
        assert tr.norm == (1, 1)
    if name == "ImagenetTailRunner":
        # F9: at logN 16 the port moves the keys of the first stage of
        # the transition's maps; the masks and the second stage are JAX's
        fields.remove("str_maps")
        t, j = tr.str_maps, jr.str_maps
        for f in ("r_idx", "r_idx_l"):
            _same(getattr(t, f), getattr(j, f))
        for f in ("m_idx", "m_idx_l"):
            _same(list(getattr(t, f).values()), list(getattr(j, f).values()))
            same_keys = list(getattr(t, f)) == list(getattr(j, f))
            assert same_keys == (log_n == 10)
    for f in fields:
        _same(getattr(tr, f), getattr(jr, f))
    assert tr.btps.kwargs == jr.btps.kwargs
    assert tr.real_batch == (tp.n // 256, tp.n // 128)
    b0 = tr.real_batch[0]
    x = np.random.default_rng(2).uniform(-1, 1, (14, 14, b0))
    got, want = tr.encrypt_input(x), jr.encrypt_input(x)
    _same(got[0], want[0])
    assert got[1:] == want[1:] == (tp.scale, 1)
    # block 1's layout: channel c at coefficient c + max_batch·(16·i + j)
    assert got[0][3 + b0 * (16 * 2 + 5)] == x[2, 5, 3]


@pytest.mark.parametrize("ch,raw", [(8, 7), (64, 7), (6, 6)])
def test_identity_fc_equals_jax(ch, raw):
    _same(timg._identity_fc(ch, raw), jimg._identity_fc(ch, raw))


# ---------------------------------------------------------------------------
# the call sequence of infer_features / infer_logits
# ---------------------------------------------------------------------------

class _Recorder:
    """Stands in for eval_conv_bn_relu and the heads' eval_conv_bn: records
    the bootstrappers' kwargs and every argument but the context and the
    ciphertext (the head's by name, defaults applied, in_norm None read
    as norm), and returns the ciphertext it got.  Also records the
    context's add and mul_monomial; decryption gives 0, 1, 2, ... so
    the readout slice shows in what infer_* returns."""

    def __init__(self, conv_module, n):
        self.calls = []
        self.sig = inspect.signature(conv_module.eval_conv_bn)
        self.n = n

    def layer(self, ctx, btps, ct, *args, **kw):
        self.calls.append(("layer", dict(btps.kwargs), args, kw))
        return ct

    def conv(self, *args, **kw):
        a = self.sig.bind(*args, **kw)
        a.apply_defaults()
        d = dict(a.arguments)
        d.pop("ctx"), d.pop("ct_in")
        assert d.pop("ecd_lv", 1) == 1
        if d["in_norm"] is None:
            d["in_norm"] = d["norm"]
        self.calls.append(("conv", d))
        return "conv out"

    def decrypt(self, ct):
        assert ct == "conv out"
        return np.arange(self.n, dtype=float)


def _record(monkeypatch, runner_module, conv_module, ctx):
    rec = _Recorder(conv_module, ctx.params.n)
    monkeypatch.setattr(runner_module, "eval_conv_bn_relu", rec.layer)
    monkeypatch.setattr(conv_module, "eval_conv_bn", rec.conv)
    ctx.add = lambda a, b: rec.calls.append(("add",)) or a
    ctx.mul_monomial = lambda a, k: rec.calls.append(("mono", k)) or a
    ctx.decrypt_decode_coeffs = rec.decrypt
    return rec


@pytest.mark.parametrize("head", ["features", "logits"])
@pytest.mark.parametrize("name", RUNNERS)
def test_call_sequence_equals_jax(monkeypatch, name, head):
    """At logN 16, 256 → 512 channels, num_blc (3, 3), init_pow 6 /
    mid_pow 5, seeded weights and the FC-1000 head: every fused layer
    (kernel, BN, pow, in_wid, kp_wid, ker_wid, real_ib/ob, norm, pos,
    log_sparse, kind, maps), the transition's add and X^2 shift, and the
    head's conv (kernel, BN, in_norm, out_scale), in order, with what
    infer_* returns (the readout slice)."""
    jctx, tctx = _stub(jax_boot(16)), _stub(boot_params(16))
    jr = getattr(jimg, name)(jctx, 3, BOOT, (3, 3))
    tr = getattr(timg, name)(tctx, 3, BOOT, (3, 3))
    b0, b1 = tr.real_batch
    assert (b0, b1) == (256, 512)
    x, convs, bn_a, bn_b, fc_w, fc_b = _deep_weights(b0, b1, (3, 3), 5, 1000)
    if name == "ImagenetTailRunner":
        jr.str_maps = tr.str_maps     # F9: the tables test holds the rest
    jrec = _record(monkeypatch, jimg, jconv, jctx)
    trec = _record(monkeypatch, timg, convops, tctx)
    if head == "features":
        want = jr.infer_features(x, convs, bn_a, bn_b)
        got = tr.infer_features(x, convs, bn_a, bn_b)
        _same(tr.features(got), got[tr._ctr(): tr._ctr() + tr.norm[1] * b1:
                                    tr.norm[1]])
    else:
        want = jr.infer_logits(x, convs, bn_a, bn_b, fc_w, fc_b)
        got = tr.infer_logits(x, convs, bn_a, bn_b, fc_w, fc_b)
        assert got.shape == (1000,) and got[0] == 3 * 8 * 1024 + 3 * 1024
    _same(got, want)
    assert len(trec.calls) == len(jrec.calls)
    for t, j in zip(trec.calls, jrec.calls):
        _same(t, j)
    kinds = [c[2][-2] for c in trec.calls if c[0] == "layer"]
    pows = [c[2][4] for c in trec.calls if c[0] == "layer"]
    assert len(kinds) == 8 and pows == [6.0, 6.0] + [5.0] * 6
    if name == "ImagenetTailRunner":
        assert kinds == ["Conv_sparse"] * 3 + ["StrConv_sparse_full"] * 2 \
            + ["Conv_sparse"] * 3
        assert ("mono", 2) in trec.calls
    else:
        assert kinds == ["Conv"] * 3 + ["StrConv"] * 2 + ["Conv"] * 3
    conv = trec.calls[-1][1]
    if head == "logits":
        assert conv["in_norm"] == tr.norm[1] and conv["norm"] == 1
        assert conv["real_ob"] == 1000 and conv["ker_wid"] == 7


# ---------------------------------------------------------------------------
# in_norm: prep_ker and the RMFC head's conv
# ---------------------------------------------------------------------------

def _rmfc_case(seed=31, b1=8, n_out=12):
    rng = np.random.default_rng(seed)
    fc_w = rng.normal(0, 1.0, (b1, n_out))
    ker = np.broadcast_to(fc_w[None, None], (7, 7, b1, n_out)).ravel()
    return ker, np.full(n_out, 1 / 49), rng.normal(0, 0.3, n_out), fc_w


def test_prep_ker_in_norm_equals_jax(ctxs):
    """The RMFC mini geometry (in_wid 8, kw 7, 8 inputs at stride 2, 12
    outputs at stride 1, logN 10): the same plaintexts bit for bit; with
    in_norm None the same as in_norm = norm."""
    jctx, tctx = ctxs
    ker, bn_a, _, _ = _rmfc_case()
    want = jconv.prep_ker(jctx, ker, bn_a, 8, 7, 8, 12, 1, 1, 0, False,
                          in_norm=2)
    got = convops.prep_ker(tctx, ker, bn_a, 8, 7, 8, 12, 1, False, in_norm=2)
    assert sum(g is not None for g in got) == 16
    for g, w in zip(got, want):
        assert g.level == w.level and g.scale == w.scale
        assert np.array_equal(interop.to_numpy(g.poly), np.asarray(w.poly))
    same = convops.prep_ker(tctx, ker, bn_a, 8, 7, 8, 12, 1, False)
    explicit = convops.prep_ker(tctx, ker, bn_a, 8, 7, 8, 12, 1, False,
                                in_norm=1)
    for a, b in zip(same, explicit):
        assert torch.equal(a.poly, b.poly)


def test_rmfc_head_conv_equals_jax(ctxs, tmp_path):
    """The sparse tail's RMFC head at logN 10 (block-2 features at
    channel stride 2, 12 logits at stride 1) on one ciphertext the port
    encrypts in block 2's layout: the port's eval_conv_bn with in_norm=2
    and JAX's, on the port's keys (carried by ``interop.save_keys``), give
    the same ciphertext, and ``logits_head`` the same logits, within 2e-3
    of numpy's mean + FC."""
    jctx, tctx = ctxs
    tr = timg.ImagenetTailRunner(tctx, 3, BOOT, (1, 1))
    b1 = tr.real_batch[1]
    assert (b1, tr.norm[1]) == (8, 2)
    ker, bn_a, fc_b, fc_w = _rmfc_case()
    x = np.random.default_rng(13).uniform(-1, 1, (7, 7, b1))
    p = tctx.params
    tct = tctx.encrypt(tctx.encoder.encode_coeffs(tr.pack(x, 1), p.scale,
                                                  convops.ECD_LEVEL))
    got = convops.eval_conv_bn(tctx, tct, ker, bn_a, fc_b, 8, 7, b1, 12, 1,
                               float(1 << 30), in_norm=2)
    path = str(tmp_path / "keys.npz")
    interop.save_keys(path, tctx)
    assert jser.load_keys(path, jctx) == len(tctx.switching_keys) > 0
    held = len(jctx._swk_cache.d)
    jct = JaxCiphertext(jnp.asarray(interop.to_numpy(tct.c0)),
                        jnp.asarray(interop.to_numpy(tct.c1)),
                        level=tct.level, scale=tct.scale)
    want = jconv.eval_conv_bn(jctx, jct, ker, bn_a, fc_b, 8, 7, b1, 12, 1,
                              float(1 << 30), in_norm=2)
    assert len(jctx._swk_cache.d) == held, "JAX made a key"
    assert got.level == want.level and got.scale == want.scale
    assert np.array_equal(interop.to_numpy(got.c0), np.asarray(want.c0))
    assert np.array_equal(interop.to_numpy(got.c1), np.asarray(want.c1))
    logits = tr.logits_head(tct, fc_w, fc_b)
    ctr = 3 * 8 * 16 + 3 * 16
    _same(logits, jctx.decrypt_decode_coeffs(want)[ctr: ctr + 12])
    np.testing.assert_allclose(logits, x.mean((0, 1)) @ fc_w + fc_b,
                               atol=2e-3)


@pytest.mark.parametrize("name", RUNNERS)
def test_heads_read_block2_layout(ctxs, name):
    """Both heads on a ciphertext packed in block 2's layout (port keys):
    ``features`` gives the channel means and ``logits_head`` mean @ fc_w
    + fc_b, each to 2e-3."""
    _, tctx = ctxs
    tr = getattr(timg, name)(tctx, 3, BOOT, (1, 1))
    b1 = tr.real_batch[1]
    _, _, fc_b, fc_w = _rmfc_case(seed=32)
    x = np.random.default_rng(14).uniform(-1, 1, (7, 7, b1))
    p = tctx.params
    ct = tctx.encrypt(tctx.encoder.encode_coeffs(tr.pack(x, 1), p.scale,
                                                 convops.ECD_LEVEL))
    np.testing.assert_allclose(tr.features(tr.features_head(ct)),
                               x.mean((0, 1)), atol=2e-3)
    np.testing.assert_allclose(tr.logits_head(ct, fc_w, fc_b),
                               x.mean((0, 1)) @ fc_w + fc_b, atol=2e-3)


# ---------------------------------------------------------------------------
# the layout helpers against the repack mirror
# ---------------------------------------------------------------------------

def _monomial(v, k):
    """v · X^k in Z[X]/(X^n + 1), k >= 0."""
    return np.concatenate([-v[len(v) - k:], v[: len(v) - k]])


def _mirror(ctx, vec, call):
    """The coefficients one recorded layer writes for the input
    coefficients `vec`, in plaintext: the conv on the grid (input channel
    j at slot j·norm), BN, then ``DebugOracle``'s repack mirror of the
    layer's own maps, at pow 0 (ReLU of the conv output)."""
    (ker, bn_a, bn_b, _, _, in_wid, kp, kw, rib, rob, norm, _, _, _, ls,
     kind, maps) = call
    mb = ctx.params.n // (in_wid * in_wid)
    g = vec.reshape(in_wid, in_wid, mb)
    x = np.stack([g[:, :, j * norm] for j in range(rib)], -1)
    y = convops.conv2d_same_np(x, np.reshape(ker, (kw, kw, rib, rob)))
    cfs = np.zeros((in_wid, in_wid, mb))
    cfs[:, :, : rob * norm: norm] = y * bn_a + bn_b
    return DebugOracle(ctx, in_wid, kp, kind, 0.0, ls, cfs.ravel(),
                       maps=maps).expected_output()


@pytest.mark.parametrize("log_n,num_blc", [(10, (2, 2)), (16, (1, 1))])
@pytest.mark.parametrize("name", RUNNERS)
def test_layout_helpers_match_the_repack_mirror(monkeypatch, name, log_n,
                                                num_blc):
    """At logN 10 (4 → 8 channels) and 16 (256 → 512): a seeded input
    packed by ``pack(x, block)`` goes through each layer's plaintext
    mirror; the output, read by ``unpack`` in the next block's layout, is
    the logical conv + BN + ReLU (the transition: each half in its
    ``transition_channels``, then both, the tail's odd half shifted by
    X^2, stride 2 at ``stride_phase``), and every other coefficient is
    zero.  The tail keeps y[2i, 2j] and the final-fast runner
    y[2i+1, 2j+1]; at logN 16 the tail's transition on the maps of
    ``gen_comprs_sparse`` as JAX builds them keeps 32 of a half's 256
    channels (F9)."""
    params = (mini_boot_params(10, n_relu=14) if log_n == 10
              else boot_params(16))
    ctx = _stub(params)
    tr = getattr(timg, name)(ctx, 3, BOOT, num_blc)
    calls = []
    monkeypatch.setattr(timg, "eval_conv_bn_relu",
                        lambda c, btps, ct, *a: calls.append(a) or ct)
    ctx.add = lambda a, b: a
    ctx.mul_monomial = lambda a, k: a
    b0, b1 = tr.real_batch
    x, convs, bn_a, bn_b, _, _ = _deep_weights(b0, b1, num_blc, 3, 4)
    tr._run_blocks(x, convs, bn_a, bn_b, 4.0, 4.0)
    assert len(calls) == sum(num_blc) + 2
    rng = np.random.default_rng(3)
    li = blk = 0
    while calls:
        group = [calls.pop(0)]
        if group[0][-2].startswith("Str"):
            group.append(calls.pop(0))
        raw = tr.raw_wid(blk)
        x = rng.uniform(-1, 1, (raw, raw, convs[li].shape[2]))
        pre = convops.conv2d_same_np(x, convs[li]) * bn_a[li] + bn_b[li]
        outs = [_mirror(ctx, tr.pack(x, blk), c) for c in group]
        if len(outs) == 1:
            got = outs[0]
        else:
            blk, ph, raw1 = 1, tr.stride_phase, tr.raw_wid(1)
            pre = pre[ph::2, ph::2][:raw1, :raw1]
            # each half alone, from its own call's kernel and BN
            for h, (c, out) in enumerate(zip(group, outs)):
                kh = np.reshape(c[0], (3, 3, c[8], c[9]))
                pre_h = (convops.conv2d_same_np(x, kh) * c[1]
                         + c[2])[ph::2, ph::2][:raw1, :raw1]
                assert np.allclose(tr.unpack(out, 1, b1)[
                    ..., tr.transition_channels(h)], relu_np(pre_h),
                    atol=1e-12)
                if log_n == 16 and name == "ImagenetTailRunner" and h == 0:
                    jax_maps = [rp.gen_comprs_sparse(params.n // 2, 16, 7, 0,
                                                     ul, 0) for ul in (0, 1)]
                    lost = _mirror(ctx, tr.pack(x, 0), c[:-1] + (LayerMaps(
                        m_idx=jax_maps[0][0], r_idx=jax_maps[0][1],
                        m_idx_l=jax_maps[1][0], r_idx_l=jax_maps[1][1]),))
                    kept = np.isclose(tr.unpack(lost, 1, b1)[
                        ..., tr.transition_channels(h)], relu_np(pre_h),
                        atol=1e-12).all(axis=(0, 1))
                    assert kept.sum() == 32 and kept[:32].all()
            shift = tr.norm[1] if name == "ImagenetTailRunner" else 0
            got = outs[0] + (_monomial(outs[1], shift) if shift else outs[1])
        assert np.allclose(tr.unpack(got, blk, pre.shape[-1]), relu_np(pre),
                           atol=1e-12)
        rest = got.copy()
        rest[tr._index(blk, pre.shape[-1])] = 0
        assert not rest.any()
        li += 1
    assert li == sum(num_blc) + 1 and blk == 1


# ---------------------------------------------------------------------------
# slow_e2e: the JAX minis and the TransConv layer, port only
# ---------------------------------------------------------------------------

MINI_CASES = {   # (runner, head, seed): tests/test_imagenet_mini.py
    "tail_features": ("ImagenetTailRunner", "features", 11),
    "tail_logits": ("ImagenetTailRunner", "logits", 17),
    "final_fast_logits": ("ImagenetFinalFastRunner", "logits", 19),
    "final_fast_features": ("ImagenetFinalFastRunner", "features", 13),
}


@pytest.fixture(scope="module")
def boot_ctx():
    return CkksContext(mini_boot_params(10, n_relu=14), CPU, seed=23)


def _plain_mirror(x, convs, bn_a, bn_b, phase=None):
    """tests/test_imagenet_mini.py's mirror; `phase` picks the stride-2
    samples where it is not conv_bn_relu_plain's."""
    y = conv_bn_relu_plain(x, convs[0], bn_a[0], bn_b[0])
    if phase is None:
        y = conv_bn_relu_plain(y, convs[1], bn_a[1], bn_b[1], stride=2)
    else:
        y = relu_np((convops.conv2d_same_np(y, convs[1]) * bn_a[1]
                     + bn_b[1])[phase::2, phase::2])
    y = y[:7, :7]
    return conv_bn_relu_plain(y, convs[2], bn_a[2], bn_b[2]).mean(axis=(0, 1))


@pytest.mark.slow_e2e
@pytest.mark.parametrize("case", list(MINI_CASES))
def test_imagenet_mini_end_to_end(boot_ctx, case):
    """The four JAX minis on the port, logN 10, num_blc (1, 1), the same
    seeds, weights, boot kwargs, mirror and bars (features 0.1, logits
    0.2 with the argmax equal); also against the mirror at the runner's
    own stride phase (F9), to the same bars."""
    name, head, seed = MINI_CASES[case]
    runner = getattr(timg, name)(boot_ctx, ker_wid=3, num_blc=(1, 1),
                                 boot_kwargs=BOOT)
    b0, b1 = runner.real_batch
    assert (b0, b1) == (4, 8)
    x, convs, bn_a, bn_b, fc = _weights(b0, b1, seed,
                                        12 if head == "logits" else None)
    if head == "features":
        got = runner.features(runner.infer_features(
            x, convs, bn_a, bn_b, init_pow=4.0, mid_pow=4.0))
    else:
        got = runner.infer_logits(x, convs, bn_a, bn_b, *fc, init_pow=4.0,
                                  mid_pow=4.0)
    for phase in (None, runner.stride_phase):
        want = _plain_mirror(x, convs, bn_a, bn_b, phase)
        if head == "features":
            assert np.max(np.abs(want)) > 0.02
            bar = 0.1
        else:
            want = want @ fc[0] + fc[1]
            assert np.argmax(got) == np.argmax(want), (got, want)
            bar = 0.2
        assert got.shape == want.shape
        err = np.max(np.abs(got - want))
        assert err < bar, f"{head} err {err}: {got} vs {want}"


@pytest.mark.slow_e2e
def test_transconv_end_to_end(boot_ctx):
    """tests/test_pipeline_transconv.py on the port: interleaved input →
    transposed conv → CtoS → ReLU → extend repack → StoC at logN 10,
    against the mirror chain, max error < 5e-2."""
    ctx = boot_ctx
    p = ctx.params
    n, in_wid, kw, raw, kp_wid, pow_ = p.n, 16, 3, 6, 14, 4.0
    mb = n // (in_wid * in_wid)
    ob = mb // 4
    rng = np.random.default_rng(61)
    img = rng.uniform(-0.8, 0.8, (raw, raw, mb))
    ker = rng.uniform(-1, 1, (kw, kw, mb, ob)) / 8.0
    bn_a = rng.uniform(0.8, 1.2, ob)
    bn_b = rng.uniform(-0.2, 0.2, ob)
    inp = convops.prep_input(img.ravel(), raw, in_wid, n, 1, trans=True)
    ct = ctx.encrypt(ctx.encoder.encode_coeffs(inp, p.scale, 1))
    r0 = rp.gen_extend_full(n // 2, in_wid, kp_wid, 0, 0)
    r1 = rp.gen_extend_full(n // 2, in_wid, kp_wid, 0, 1)
    btps = {0: SplitBootstrapper(ctx, log_sparse=0, **BOOT)}
    out = eval_conv_bn_relu(ctx, btps, ct, ker.transpose(0, 1, 3, 2).ravel(),
                            bn_a, bn_b, 0.0, pow_, in_wid, kp_wid, kw, mb, ob,
                            1, 0, 1, 2, 0, "TransConv",
                            LayerMaps(r_idx=r0, r_idx_l=r1))
    got = ctx.decrypt_decode_coeffs(out)
    dil = np.zeros((in_wid, in_wid, mb))
    dil[1::2, 1::2][:raw, :raw] = img
    conv = convops.conv2d_same_np(dil, ker[::-1, ::-1]) * bn_a + bn_b
    cfs = np.zeros(n)
    for b in range(ob):
        cfs[b::mb] = conv[..., b].ravel()
    brv = np.array([rp.reverse_bits(i, p.log_n - 1) for i in range(n // 2)])
    t0 = rp.apply_rot_maps(relu_np(cfs[: n // 2][brv]), r0)
    t1 = rp.apply_rot_maps(relu_np(cfs[n // 2:][brv]), r1)
    want = np.concatenate([t0[brv], t1[brv]])
    err = np.max(np.abs(got - want))
    assert err < 5e-2, f"max err {err}"
    assert np.max(np.abs(want)) > 0.1
