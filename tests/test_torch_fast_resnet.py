"""The port's crop_fast runners (``FastResNetRunner``, ``WideFastResNetRunner``)
and ``cli resnet --fast`` against the JAX package (CPU).

The configurations are the JAX tests' minis (``tests/test_resnet_fast_mini.py``,
``tests/test_resnet_wide_fast_mini.py``) at logN 10, and ResNet-20's widths
at logN 16 for the tables alone.  What is cheap is compared with JAX
exactly: every table the runners build, the packed image, the whole call
sequence of ``infer`` (a recorder stands in for the fused layer in both
runner modules, so no bootstrap runs) and the fast head's conv on one
ciphertext.  The runners' layout helpers, which ``chip_smoke.py`` uses to
feed and read each layer, are held against the repack mirror of every
layer the runners call.
"""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optimal_conv_tpu import cli as jcli
from optimal_conv_tpu.ckks import context as jcontext
from optimal_conv_tpu.ckks.params import CkksParams as JaxParams
from optimal_conv_tpu.ckks.params import boot_params as jax_boot
from optimal_conv_tpu.ckks.params import mini_boot_params as jax_mini
from optimal_conv_tpu.ckks.types import Ciphertext as JaxCiphertext
from optimal_conv_tpu.models import resnet as jres

from optimal_conv_tpu_torch import cli, interop
from optimal_conv_tpu_torch.ckks import context as tcontext
from optimal_conv_tpu_torch.ckks.context import CkksContext
from optimal_conv_tpu_torch.ckks.params import (CkksParams, boot_params,
                                                mini_boot_params)
from optimal_conv_tpu_torch.models import plain
from optimal_conv_tpu_torch.models import resnet as tres
from optimal_conv_tpu_torch.ops import conv as convops
from optimal_conv_tpu_torch.ops.debug import DebugOracle
from optimal_conv_tpu_torch.ops.pipeline import LayerMaps
from optimal_conv_tpu_torch.ops.relu import relu_np

CPU = torch.device("cpu")
SEED = 19
BOOT = dict(k_range=12.0, sin_deg=31, double_angle=3)
MINI = dict(ker_wid=3, depth=8, in_wids=(16, 8, 4), fc_out=4, init_pow=4.0,
            mid_pow=4.0, final_pow=4.0)
# distinct pows where nothing is computed, so the recorder sees which
# layer takes which
POWS = dict(init_pow=4.0, mid_pow=5.0, final_pow=6.0)
# name: (config, input channels, weight seed)
CONFIGS = {
    "fast1_d8": (dict(MINI, real_batch=(1, 2, 4)), 1, 4),
    "wide2_d8": (dict(MINI, real_batch=(2, 4, 8), wide=2, init_batch=1), 2,
                 5),
    "wide3_d8": (dict(MINI, real_batch=(3, 6, 12), wide=3, init_batch=2), 3,
                 8),
    "cf100_fast1_d8": (dict(MINI, real_batch=(1, 2, 4), fc_out=8,
                            cf100=True), 1, 4),
}
# ResNet-20's widths at logN 16 (cli.RESNET_BATCHES)
FULL = {wide: dict(depth=20, wide=wide, real_batch=rb)
        for wide, rb in cli.RESNET_BATCHES.items()}

torch.set_num_threads(1)


# two primes on the logN-10 ring: all the head's conv and the recorded
# runs need (nothing bootstraps)
CHAIN = dict(log_n=10, logq=(50, 40), logp=(55,), log_scale=25, h=64)


@pytest.fixture(scope="module")
def ctxs():
    """The JAX and the port context on the same seed: the same secret key."""
    return (jcontext.CkksContext(JaxParams(**CHAIN), seed=SEED),
            CkksContext(CkksParams(**CHAIN), CPU, seed=SEED))


def _runners(jctx, tctx, cfg: dict):
    """(JAX runner, port runner) of the class ``cli resnet --fast`` picks."""
    jcls = jres.FastResNetRunner if cfg.get("wide", 1) == 1 \
        else jres.WideFastResNetRunner
    tcls = getattr(tres, jcls.__name__)
    return (jcls(jctx, jres.ResNetConfig(**cfg), BOOT),
            tcls(tctx, tres.ResNetConfig(**cfg), BOOT))


def _weights(name: str):
    cfg, in_ch, seed = CONFIGS[name]
    return plain.random_weights(
        3, cfg["depth"], cfg["real_batch"], fc_out=cfg["fc_out"], in_ch=in_ch,
        seed=seed, scale=0.7,
        init_batch=cfg.get("init_batch") if cfg.get("wide", 1) > 1 else None)


def _image(cfg: dict, in_ch: int, seed: int = 6):
    raw0 = cfg["in_wids"][0] - cfg["ker_wid"] // 2
    return np.random.default_rng(seed).uniform(-1, 1, (raw0, raw0, in_ch))


def _same(a, b):
    """Equal values, arrays and repack tables included."""
    if isinstance(a, LayerMaps):
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
    """Records what encrypt_image encodes; encryption is the identity."""

    def __init__(self, params):
        self.params = params

    def encode_coeffs(self, v, scale, level):
        return (np.array(v), scale, level)


def _stub(params):
    """A context with the geometry of `params` and no keys."""
    return SimpleNamespace(params=params, encoder=_Encoder(params),
                           encrypt=lambda pt: pt)


# ---------------------------------------------------------------------------
# tables and the packed image
# ---------------------------------------------------------------------------

def _check_tables(jr, tr, image):
    fields = ["max_batch", "norm", "steps", "keep_maps"]
    if isinstance(tr, tres.WideFastResNetRunner):
        fields.append("str_maps")
        assert sorted(tr.str_maps) == ([0] if tr.cfg.wide == 2 else [0, 2])
    else:
        fields.append("w0")
    for f in fields:
        _same(getattr(tr, f), getattr(jr, f))
    assert tr.btps.kwargs == jr.btps.kwargs
    _same(tr.packed_image(image), jr.encrypt_image(image)[0])


@pytest.mark.parametrize("name", ["fast1_d8", "wide2_d8", "wide3_d8"])
def test_mini_tables_and_packed_image_equal_jax(name):
    """max_batch, norm, steps, every keep and strided map (wide 3's pos-2
    maps too) and the vector encrypt_image encodes, at logN 10."""
    cfg, in_ch, _ = CONFIGS[name]
    jr, tr = _runners(_stub(jax_mini(10, n_relu=14)),
                      _stub(mini_boot_params(10, n_relu=14)), cfg)
    _check_tables(jr, tr, _image(cfg, in_ch))
    got = tr.encrypt_image(_image(cfg, in_ch))
    assert got[1:] == (tr.ctx.params.scale, 1)


@pytest.mark.parametrize("wide", [1, 2, 3])
def test_resnet20_tables_and_packed_image_equal_jax(wide):
    """The same at ResNet-20's widths on the logN-16 ring (no keys):
    the geometry of ``resnet 3 20 <wide> --fast``."""
    cfg = FULL[wide]
    jr, tr = _runners(_stub(jax_boot(16)), _stub(boot_params(16)), cfg)
    image = np.random.default_rng(2).uniform(-1, 1, (31, 31, 3))
    _check_tables(jr, tr, image)
    if wide == 1:
        assert (tr.max_batch, tr.norm, tr.steps) == (64, [4, 2, 1], (1, 2, 4))
    else:
        assert tr.norm == list(tres.WideFastResNetRunner.NORMS[wide])


# ---------------------------------------------------------------------------
# the call sequence of infer
# ---------------------------------------------------------------------------

class _Recorder:
    """Stands in for eval_conv_bn_relu and the runner's FC head: records
    the bootstrappers' kwargs and every argument but the context and the
    ciphertext, and returns the ciphertext it got."""

    def __init__(self):
        self.calls = []

    def __call__(self, ctx, btps, ct, *args, **kw):
        self.calls.append((dict(btps.kwargs), args, kw))
        return ct

    def fc(self, ct, w):
        self.calls.append(("fc", (w.fc_w, w.fc_b), {}))
        return np.zeros(w.fc_b.shape)


def _record(monkeypatch, module, runner, ctx):
    rec = _Recorder()
    monkeypatch.setattr(module, "eval_conv_bn_relu", rec)
    monkeypatch.setattr(runner, "_fc_head", rec.fc)
    orig = ctx.add

    def add(a, b):
        rec.calls.append(("add", (a.level, a.scale, b.level, b.scale), {}))
        return orig(a, b)

    monkeypatch.setattr(ctx, "add", add)
    return rec


@pytest.mark.parametrize("name", list(CONFIGS))
def test_infer_call_sequence_equals_jax(ctxs, monkeypatch, name):
    """Kind, pow, in_wid, kp, step, norm, real_ib/ob, the interleaved
    kernels, the wide-3 halves' BN slices and maps, in order, with the
    sum of the halves and the block timings."""
    jctx, tctx = ctxs
    cfg, in_ch, _ = CONFIGS[name]
    cfg = dict(cfg, **POWS)
    jr, tr = _runners(jctx, tctx, cfg)
    w = _weights(name)
    image = _image(cfg, in_ch)
    jrec = _record(monkeypatch, jres, jr, jctx)
    trec = _record(monkeypatch, tres, tr, tctx)
    jt, tt = {}, {}
    jr.infer(image, w, jt)
    tr.infer(image, w, tt)
    n_wide3 = 2 if cfg.get("wide") == 3 else 0       # a second half + an add
    assert len(trec.calls) == len(jrec.calls) == 7 + 1 + n_wide3
    for (tk, ta, tkw), (jk, ja, jkw) in zip(trec.calls, jrec.calls):
        _same(tk, jk)
        _same(ta, ja)
        _same(tkw, jkw)
    layers = [c[1] for c in trec.calls if isinstance(c[0], dict)]
    kinds = [a[-2] for a in layers]
    if cfg.get("wide", 1) == 1:
        assert kinds == ["Conv_inside"] * 3 + ["StrConv_inside", "Conv_inside",
                                               "StrConv_inside", "Conv_inside"]
        assert [a[-5] for a in layers] == [1, 1, 1, 2, 2, 4, 4]     # step
        # the transitions' kernels: the real input channels at even slots
        for li, a in ((3, layers[3]), (5, layers[5])):
            k = a[0].reshape(3, 3, -1, w.convs[li].shape[3])
            _same(k[:, :, 0::2], w.convs[li])
            assert not k[:, :, 1::2].any()
    else:
        odd = kinds.count("StrConv_odd")
        assert odd == (2 if cfg["wide"] == 3 else 1)
        assert kinds[:3] == ["Conv"] * 3 and "StrConv_inside" in kinds
    if name.startswith("cf100"):
        assert trec.calls[-1][0] == "fc" and trec.calls[-1][1][0].shape[1] == 8
    assert list(tt) == list(jt) == ["blc1", "blc1to2", "blc2", "blc2to3",
                                    "blc3", "fc"]


# ---------------------------------------------------------------------------
# the fast head on one ciphertext
# ---------------------------------------------------------------------------

def test_fast_head_conv_equals_jax(ctxs):
    """FastResNetRunner._fc_conv (kw = raw0 = 15 replicated taps on the
    16² grid, logN 10): one ciphertext the port encrypts in block 3's
    layout goes to JAX as numpy arrays; the port then runs on the JAX
    keys.  The logits are equal, and within 2e-3 of numpy's mean + FC;
    the split head of CIFAR-100 is the two halves' logits."""
    jctx, tctx = ctxs
    jr, tr = _runners(jctx, tctx, CONFIGS["cf100_fast1_d8"][0])
    w = _weights("cf100_fast1_d8")
    raw = tr.cfg.raw_in_wids[2]
    x = np.random.default_rng(13).uniform(-1, 1, (raw, raw, 4))
    p = tctx.params
    tct = tctx.encrypt(tctx.encoder.encode_coeffs(tr.pack(x, 2), p.scale,
                                                  convops.ECD_LEVEL))
    jct = JaxCiphertext(jnp.asarray(interop.to_numpy(tct.c0)),
                        jnp.asarray(interop.to_numpy(tct.c1)),
                        level=tct.level, scale=tct.scale)
    half = slice(0, 4)
    want = jr._fc_conv(jct, w.fc_w[:, half], w.fc_b[half])
    keys = {key: (np.asarray(swk.d0), np.asarray(jctx.swk_d1(swk)))
            for key, swk in jctx._swk_cache.d.items()}
    assert interop.load_switching_keys(tctx, keys) > 0
    held = len(tctx.switching_keys)
    got = tr._fc_conv(tct, w.fc_w[:, half], w.fc_b[half])
    assert len(tctx.switching_keys) == held, "the port made a key"
    assert got.shape == (4,) and np.array_equal(got, want)
    logits = tr._fc_head(tct, w)
    _same(logits[:4], got)
    np.testing.assert_allclose(logits, x.mean((0, 1)) @ w.fc_w + w.fc_b,
                               atol=2e-3)


def test_wide_head_reads_the_mean(ctxs):
    """WideFastResNetRunner's head (kw = raw1 | 1 on the in_wids[1] grid,
    norm[2] 2) on block 3's layout: numpy's mean + FC to 2e-3."""
    jctx, tctx = ctxs
    cfg = CONFIGS["wide2_d8"][0]
    _, tr = _runners(jctx, tctx, cfg)
    w = _weights("wide2_d8")
    raw, b3 = tr.cfg.raw_in_wids[2], cfg["real_batch"][2]
    x = np.random.default_rng(14).uniform(-1, 1, (raw, raw, b3))
    p = tctx.params
    ct = tctx.encrypt(tctx.encoder.encode_coeffs(tr.pack(x, 2), p.scale,
                                                 convops.ECD_LEVEL))
    np.testing.assert_allclose(tr._fc_head(ct, w),
                               x.mean((0, 1)) @ w.fc_w + w.fc_b, atol=2e-3)


# ---------------------------------------------------------------------------
# the layout helpers against the repack mirror
# ---------------------------------------------------------------------------

def _dilate(ker, s):
    kw = ker.shape[0]
    out = np.zeros((kw * s - s + 1,) * 2 + ker.shape[2:])
    out[::s, ::s] = ker
    return out


def _mirror(ctx, c, vec):
    """The coefficients one recorded layer writes for the input
    coefficients `vec`, in plaintext: the conv on the grid (input channel
    j at slot j·norm), BN, then ``DebugOracle``'s repack mirror of the
    layer's own maps, at pow 0 (ReLU of the conv output)."""
    (ker, bn_a, bn_b, _, _, in_wid, kp, kw, rib, rob, norm, _, step, _, _,
     kind, maps) = c
    mb = ctx.params.n // (in_wid * in_wid)
    ker = np.reshape(ker, (kw, kw, rib, rob))
    if "inside" in kind:
        ker = _dilate(ker, step // 2 if kind == "StrConv_inside" else step)
    if kind == "StrConv_odd" and (in_wid - kw // 2) % 2 == 1:
        off = mb * (in_wid + 1)          # the layer's X^offset premultiply
        assert not vec[-off:].any()
        vec = np.concatenate([np.zeros(off), vec[:-off]])
    g = vec.reshape(in_wid, in_wid, mb)
    x = np.stack([g[:, :, j * norm] for j in range(rib)], -1)
    y = convops.conv2d_same_np(x, ker) * bn_a + bn_b
    cfs = np.zeros((in_wid, in_wid, mb))
    cfs[:, :, : rob * norm: norm] = y
    orc = DebugOracle(ctx, in_wid, kp, kind, 0.0, 0, cfs.ravel(), maps=maps)
    r = [orc._repack_mirror(ul, relu_np(v)) for ul, v in enumerate(orc.w_slots)]
    return np.concatenate([r[0][orc.brv], r[1][orc.brv]])


@pytest.mark.parametrize("name", ["fast1_d8", "wide2_d8", "wide3_d8"])
def test_layout_helpers_match_the_repack_mirror(monkeypatch, name):
    """For every layer infer calls, a seeded input packed by
    ``pack(x, block)`` goes through the layer's plaintext mirror; the
    output, read by ``unpack`` in the next block's layout, is the logical
    conv + BN + ReLU (stride 2 at the transitions, the wide-3 halves
    summed), and every other coefficient is zero."""
    cfg, in_ch, _ = CONFIGS[name]
    _, tr = _runners(_stub(jax_mini(10, n_relu=14)),
                     _stub(mini_boot_params(10, n_relu=14)), cfg)
    w = _weights(name)
    calls = []
    monkeypatch.setattr(tres, "eval_conv_bn_relu",
                        lambda ctx, btps, ct, *a: calls.append(a) or ct)
    monkeypatch.setattr(tr, "_fc_head", lambda ct, w_: None)
    tr.ctx.add = lambda a, b: a
    tr.infer(_image(cfg, in_ch), w)
    rng = np.random.default_rng(3)
    blk = li = 0
    while calls:
        group = [calls.pop(0)]
        if group[0][-2] == "StrConv_odd" and cfg.get("wide") == 3:
            group.append(calls.pop(0))
        raw = tr.cfg.raw_in_wids[blk]
        x = rng.uniform(-1, 1, (raw, raw, w.convs[li].shape[2]))
        pre = convops.conv2d_same_np(x, w.convs[li]) * w.bn_a[li] + w.bn_b[li]
        got = sum(_mirror(tr.ctx, c, tr.pack(x, blk)) for c in group)
        if group[0][-2].startswith("Str"):
            blk += 1
            out_raw = tr.cfg.raw_in_wids[blk]
            pre = pre[0::2, 0::2][:out_raw, :out_raw]
        assert np.allclose(tr.unpack(got, blk, pre.shape[-1]), relu_np(pre),
                           atol=1e-12)
        rest = got.copy()
        rest[tr._index(blk, pre.shape[-1])] = 0
        assert not rest.any()
        li += 1
    assert li == 7 and blk == 2


# ---------------------------------------------------------------------------
# cli resnet --fast
# ---------------------------------------------------------------------------

class _Picked(Exception):
    pass


def _pick(module, monkeypatch):
    for name in ("ResNetRunner", "FastResNetRunner", "WideFastResNetRunner"):
        def stop(ctx, cfg, *a, name=name, **k):
            raise _Picked(name, cfg.wide)
        monkeypatch.setattr(module, name, stop)


@pytest.mark.parametrize("wide,fast", [(1, True), (2, True), (3, True),
                                       (1, False), (3, False)])
def test_cli_fast_picks_the_runner_jax_picks(monkeypatch, wide, fast):
    """``resnet 3 8 <wide> 1 [--fast]``: the same runner class as the JAX
    CLI's, with the same configuration (no context is built)."""
    picked = []
    for mod, ctxmod, main in ((jres, jcontext, jcli.main),
                              (tres, tcontext, cli.main)):
        _pick(mod, monkeypatch)
        monkeypatch.setattr(ctxmod, "CkksContext", lambda *a, **k: None)
        argv = ["resnet", "3", "8", str(wide), "1"] + (["--fast"] if fast
                                                       else [])
        if main is cli.main:
            argv += ["--device", "cpu"]
        with pytest.raises(_Picked) as got:
            main(argv)
        picked.append(got.value.args)
    assert picked[0] == picked[1]
    assert picked[1][0] == ("ResNetRunner" if not fast else
                            "FastResNetRunner" if wide == 1 else
                            "WideFastResNetRunner")


# ---------------------------------------------------------------------------
# the scorer of the CSVs cli resnet writes
# ---------------------------------------------------------------------------

def test_compare_equals_jax(tmp_path, monkeypatch):
    """Per-sample CSVs with gaps (a missing sample, a sample without its
    plain logits) and a labels file: the port's compare() returns JAX's
    dict, with and without the labels and for the cf100 directories."""
    from optimal_conv_tpu import compare as jcompare
    from optimal_conv_tpu_torch import compare

    monkeypatch.chdir(tmp_path)
    rng = np.random.default_rng(8)
    for tag, n_out in (("crop", 10), ("cf100_crop", 100)):
        enc = tmp_path / f"Resnet_enc_results/results_{tag}_ker3_d20_wid1"
        enc.mkdir(parents=True)
        for i in range(7):
            if i == 3:
                continue
            plain_l = rng.normal(size=n_out)
            np.savetxt(enc / f"class_result_ker3_{i}.csv",
                       plain_l + rng.normal(0, 0.4, n_out))
            if i != 5:
                np.savetxt(enc / f"plain_result_ker3_{i}.csv", plain_l)
    for args in ((3, 20, 1), (3, 20, 1, True), (3, 20, 1, False, 4)):
        assert compare.compare(*args) == jcompare.compare(*args)
    lab = tmp_path / "Resnet_plain_data/crop_ker3_d20_wid1"
    lab.mkdir(parents=True)
    np.savetxt(lab / "labels.csv", rng.integers(0, 10, 6))
    got = compare.compare(3, 20, 1)
    assert got == jcompare.compare(3, 20, 1)
    assert got["samples"] == 5 and set(got) == {
        "samples", "enc_vs_plain_agree", "enc_accuracy", "plain_accuracy"}
    for res in (compare.compare(3, 20, 2), jcompare.compare(3, 20, 2)):
        assert res["samples"] == 0 and np.isnan(res["enc_vs_plain_agree"])
    assert compare.main(["3", "20", "1", "cf100", "6"]) == 0
