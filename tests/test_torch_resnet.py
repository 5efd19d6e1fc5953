"""The port's ResNet runner, plaintext model and debug oracles against the
JAX package (CPU), at logN 10 with the configurations of
``tests/test_resnet_mini.py`` and ``tests/test_resnet_wide3_mini.py``.

What is cheap is compared with JAX exactly: the weight files, every
repack table the runner builds, the packed image it encrypts, the call
sequence of ``infer`` (a recorder stands in for the fused layer in both
runner modules, so no bootstrap runs), the debug oracles' expected
views and the split FC head on one ciphertext.  The whole encrypted
ResNet-8 runs port only, against ``plain_forward``; it takes minutes
on the CPU, so it is in the ``slow_e2e`` tier.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optimal_conv_tpu.ckks.context import CkksContext as JaxContext
from optimal_conv_tpu.ckks.params import mini_boot_params as jax_mini
from optimal_conv_tpu.ckks.types import Ciphertext as JaxCiphertext
from optimal_conv_tpu.models import plain as jplain
from optimal_conv_tpu.models import resnet as jres
from optimal_conv_tpu.ops import debug as jdebug

from optimal_conv_tpu_torch import interop
from optimal_conv_tpu_torch.ckks.context import CkksContext
from optimal_conv_tpu_torch.ckks.params import mini_boot_params
from optimal_conv_tpu_torch.models import plain
from optimal_conv_tpu_torch.models import resnet as tres
from optimal_conv_tpu_torch.ops import debug
from optimal_conv_tpu_torch.ops import repack as rp
from optimal_conv_tpu_torch.ops.pipeline import LayerMaps

CPU = torch.device("cpu")
SEED = 19
BOOT = dict(k_range=12.0, sin_deg=31, double_angle=3)
MINI = dict(ker_wid=3, in_wids=(16, 8, 4), real_batch=(1, 2, 4), fc_out=4,
            init_pow=4.0, mid_pow=4.0, final_pow=4.0)
# distinct pows where nothing is computed, so the recorder sees which
# layer takes which
POWS = dict(init_pow=4.0, mid_pow=5.0, final_pow=6.0)
CONFIGS = {
    "wide1_d8": dict(MINI, depth=8),
    "wide1_d20": dict(MINI, depth=20),
    "wide3_d8": dict(MINI, depth=8, real_batch=(4, 8, 16), wide=3,
                     init_batch=4),
    "cf100_d8": dict(MINI, depth=8, fc_out=8, cf100=True),
}

# one intra-op thread a worker: the suite runs in several workers at once
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def ctxs():
    """The JAX and the port context on the same seed: the same secret key."""
    return (JaxContext(jax_mini(10, n_relu=14), seed=SEED),
            CkksContext(mini_boot_params(10, n_relu=14), CPU, seed=SEED))


def _weights(cfg: dict, seed: int = 4):
    return plain.random_weights(
        3, cfg["depth"], cfg["real_batch"], fc_out=cfg["fc_out"], in_ch=1,
        seed=seed, scale=0.7,
        init_batch=cfg.get("init_batch") if cfg.get("wide", 1) > 1 else None)


def _image(cfg: dict, seed: int = 6):
    raw0 = cfg["in_wids"][0] - cfg["ker_wid"] // 2
    return np.random.default_rng(seed).uniform(-1, 1, (raw0, raw0, 1))


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


# ---------------------------------------------------------------------------
# the plaintext model and the free functions of ops/debug.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("init_batch", [None, 2])
def test_weights_cross_through_the_csv_layout(tmp_path, init_batch):
    """(b) JAX save_weights_dir → port load_weights_dir and the reverse."""
    assert plain.NUM_BLOCKS == jplain.NUM_BLOCKS
    batches = (4, 8, 16)
    w = jplain.random_weights(3, 8, batches, fc_out=4, in_ch=3, seed=5,
                              init_batch=init_batch)
    jplain.save_weights_dir(str(tmp_path / "jax"), w)
    back = plain.load_weights_dir(str(tmp_path / "jax"), 3, 8, batches,
                                  fc_out=4, init_batch=init_batch)
    plain.save_weights_dir(str(tmp_path / "port"), back)
    again = jplain.load_weights_dir(str(tmp_path / "port"), 3, 8, batches,
                                    fc_out=4, init_batch=init_batch)
    for got in (back, again):
        for f in ("convs", "bn_a", "bn_b", "fc_w", "fc_b"):
            _same(getattr(got, f), getattr(w, f))


def test_debug_free_functions_equal_jax(capsys):
    """(a) precision_stats with and without the distribution and a mask,
    mat_view, mat_one and the printed prt_mat / prt_mat_step views."""
    rng = np.random.default_rng(7)
    want = rng.uniform(-1, 1, 4096)
    have = want + rng.normal(0, 1e-4, 4096)
    mask = rng.integers(0, 2, 4096)
    for kw in ({}, {"distribution": True}, {"mask": mask},
               {"mask": mask, "distribution": True}):
        assert debug.precision_stats(want, have, **kw) == \
            jdebug.precision_stats(want, have, **kw)
    vec = np.arange(8 * 8 * 16, dtype=float)
    for norm in (1, 4):
        _same(debug.mat_view(vec, 16, norm), jdebug.mat_view(vec, 16, norm))
        _same(debug.mat_one(vec, 16, 3, 5, norm),
              jdebug.mat_one(vec, 16, 3, 5, norm))
    for name, args in (("prt_mat", (vec, 16, 2, 4)),
                       ("prt_mat", (vec, 16, 0, 1, True)),
                       ("prt_mat_step", (vec, 16, 4, 2, 1, 2))):
        getattr(debug, name)(*args)
        ours = capsys.readouterr().out
        getattr(jdebug, name)(*args)
        assert ours == capsys.readouterr().out and "(1, 1):" in ours


# ---------------------------------------------------------------------------
# the runner's tables, its packed image and its call sequence
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["wide1_d8", "wide1_d20", "wide3_d8"])
def test_runner_tables_and_packed_image_equal_jax(ctxs, monkeypatch, name):
    """(c) max_batch, norm, log_sparse, str_ls, every LayerMaps table, and
    the vector encrypt_image encodes (with its scale and level)."""
    jctx, tctx = ctxs
    cfg = CONFIGS[name]
    jr = jres.ResNetRunner(jctx, jres.ResNetConfig(**cfg), BOOT)
    tr = tres.ResNetRunner(tctx, tres.ResNetConfig(**cfg), BOOT)
    for f in ("max_batch", "norm", "log_sparse", "str_ls", "keep_maps",
              "str_maps"):
        _same(getattr(tr, f), getattr(jr, f))
    assert tr.btps.kwargs == jr.btps.kwargs
    # wide 3 packs block 1 full (log_sparse 0): two keep masks, and its
    # transition needs both halves of the strided maps
    full = name == "wide3_d8"
    assert (tr.log_sparse[0] == 0) == full == (tr.str_maps[0].r_idx_l
                                                is not None)

    seen = {}
    for key, c in (("jax", jctx), ("port", tctx)):
        orig = c.encoder.encode_coeffs

        def capture(v, scale, level, *a, key=key, orig=orig, **k):
            seen[key] = (np.array(v), scale, level)
            return orig(v, scale, level, *a, **k)

        monkeypatch.setattr(c.encoder, "encode_coeffs", capture)
    image = _image(cfg)
    jct, tct = jr.encrypt_image(image), tr.encrypt_image(image)
    _same(seen["port"], seen["jax"])
    assert (tct.level, tct.scale) == (jct.level, jct.scale) == \
        (1, tctx.params.scale)
    _same(tr.packed_image(image), seen["jax"][0])


class _Recorder:
    """Stands in for eval_conv_bn_relu (and the runner's FC head): records
    the bootstrappers' kwargs, the ciphertext it got and every other
    argument but the context, and returns that ciphertext."""

    def __init__(self, stop_after=None):
        self.calls = []
        self.stop_after = stop_after

    def __call__(self, ctx, btps, ct, *args, **kw):
        if self.stop_after is not None and len(self.calls) == self.stop_after:
            raise _Interrupted
        self.calls.append((dict(btps.kwargs), ct, args, kw))
        return ct

    def fc(self, ct, w):
        self.calls.append(("fc", ct, (w.fc_w, w.fc_b), {}))
        return np.zeros(w.fc_b.shape)


class _Interrupted(Exception):
    pass


def _record(monkeypatch, module, runner, ctx, stop_after=None):
    rec = _Recorder(stop_after)
    monkeypatch.setattr(module, "eval_conv_bn_relu", rec)
    monkeypatch.setattr(runner, "_fc_head", rec.fc)
    orig = ctx.mul_monomial

    def mul_monomial(ct, k):
        rec.calls.append(("mul_monomial", ct, (k,), {}))
        return orig(ct, k)

    monkeypatch.setattr(ctx, "mul_monomial", mul_monomial)
    return rec


@pytest.mark.parametrize("name", ["wide1_d8", "wide3_d8", "cf100_d8"])
def test_infer_call_sequence_equals_jax(ctxs, monkeypatch, name):
    """(d) the kinds, kernels, BN folds, pows, geometry, log_sparse and
    repack tables of every fused layer, the wide-3 transition's monomial
    shift and the FC weights, in order, with the block timings."""
    jctx, tctx = ctxs
    cfg = dict(CONFIGS[name], **POWS)
    jr = jres.ResNetRunner(jctx, jres.ResNetConfig(**cfg), BOOT)
    tr = tres.ResNetRunner(tctx, tres.ResNetConfig(**cfg), BOOT)
    w = _weights(cfg)
    image = _image(cfg)
    jrec = _record(monkeypatch, jres, jr, jctx)
    trec = _record(monkeypatch, tres, tr, tctx)
    jt, tt = {}, {}
    jr.infer(image, w, jt)
    tr.infer(image, w, tt)
    n_layers = sum(jplain.NUM_BLOCKS[cfg["depth"]]) + 2
    n_wide3 = 2 if name == "wide3_d8" else 0     # two halves + a monomial
    assert len(trec.calls) == len(jrec.calls) == n_layers + 1 + n_wide3
    for (tk, _, ta, tkw), (jk, _, ja, jkw) in zip(trec.calls, jrec.calls):
        _same(tk, jk)
        _same(ta, ja)
        _same(tkw, jkw)
    kinds = [c[2][-2] for c in trec.calls if len(c[2]) > 3]
    assert kinds.count("StrConv_sparse_full") == n_wide3
    assert list(tt) == list(jt) == ["blc1", "blc1to2", "blc2", "blc2to3",
                                    "blc3", "fc"]


def test_ckpt_resume_runs_only_the_remaining_layers(ctxs, monkeypatch,
                                                    tmp_path):
    """(f) interrupted after two layers, the checkpoint holds li 1; the
    next call resumes with the saved ciphertext and runs layers 2-6 only,
    then removes the checkpoint."""
    _, tctx = ctxs
    cfg = CONFIGS["wide1_d8"]
    tr = tres.ResNetRunner(tctx, tres.ResNetConfig(**cfg), BOOT)
    w, image = _weights(cfg), _image(cfg)
    rec = _record(monkeypatch, tres, tr, tctx, stop_after=2)
    with pytest.raises(_Interrupted):
        tr.infer(image, w, ckpt_dir=str(tmp_path))
    z = np.load(tmp_path / "layer.npz")
    assert int(z["li"]) == 1
    saved = rec.calls[1][1]                  # what layer 1 returned
    assert np.array_equal(z["c0"], interop.to_numpy(saved.c0))

    rec = _record(monkeypatch, tres, tr, tctx)
    tr.infer(image, w, ckpt_dir=str(tmp_path))
    layers = [c for c in rec.calls if c[0] != "fc"]
    _same([c[2][0] for c in layers], [k.ravel() for k in w.convs[2:]])
    first = layers[0][1]
    assert (first.level, first.scale) == (saved.level, saved.scale)
    assert torch.equal(first.c0, saved.c0) and torch.equal(first.c1, saved.c1)
    assert rec.calls[-1][0] == "fc"
    assert not (tmp_path / "layer.npz").exists()


# ---------------------------------------------------------------------------
# the split FC head and the debug oracles' expected views
# ---------------------------------------------------------------------------

def test_split_fc_head_equals_jax(ctxs):
    """(e) fc_out 8 > real_batch[2] 4: two half-width convs.  One
    ciphertext encrypted by the port goes to JAX as numpy arrays; the
    port then runs on the JAX keys.  The logits are equal, and within
    2e-3 of numpy's mean + FC."""
    jctx, tctx = ctxs
    cfg = CONFIGS["cf100_d8"]
    w = _weights(cfg, seed=12)
    tr = tres.ResNetRunner(tctx, tres.ResNetConfig(**cfg), BOOT)
    jr = jres.ResNetRunner(jctx, jres.ResNetConfig(**cfg), BOOT)
    raw = tres.ResNetConfig(**cfg).raw_in_wids[2]
    x = np.random.default_rng(13).uniform(-1, 1, (raw, raw, 4))
    tct = tres.encrypt_fc_input(tctx, tr.cfg, x)
    jct = JaxCiphertext(jnp.asarray(interop.to_numpy(tct.c0)),
                        jnp.asarray(interop.to_numpy(tct.c1)),
                        level=tct.level, scale=tct.scale)
    want = jr._fc_head(jct, w)
    keys = {key: (np.asarray(swk.d0), np.asarray(jctx.swk_d1(swk)))
            for key, swk in jctx._swk_cache.d.items()}
    assert interop.load_switching_keys(tctx, keys) > 0
    held = len(tctx.switching_keys)
    got = tr._fc_head(tct, w)
    assert len(tctx.switching_keys) == held, "the port made a key"
    assert got.shape == (8,)
    assert np.array_equal(got, want)
    np.testing.assert_allclose(got, x.mean((0, 1)) @ w.fc_w + w.fc_b,
                               atol=2e-3)


def _oracle_cases(n):
    """(kind, in_wid, kp_wid, log_sparse, cfs, maps) of a Conv_sparse layer
    at log_sparse 2 and of a StrConv_sparse transition, at logN 10."""
    rng = np.random.default_rng(3)
    in_wid, raw = 16, 15
    cfs = rng.uniform(-1, 1, n)
    keep = LayerMaps(ext_idx=[rp.gen_keep_vec_sparse(n // 2, in_wid, raw, 2),
                              None])
    m_idx, r_idx = rp.gen_comprs_sparse(n // 2, in_wid, 7, 1, 0, 0)
    return [("Conv_sparse", in_wid, raw, 2, cfs, keep),
            ("StrConv_sparse", in_wid, 7, 1, cfs,
             LayerMaps(m_idx=m_idx, r_idx=r_idx))]


def test_debug_oracle_views_equal_jax(ctxs):
    """(g) both packages' oracles expect the same slot views and keep the
    same positions, and both have a golden for every stage."""
    jctx, tctx = ctxs
    n = tctx.params.n
    for kind, in_wid, kp, ls, cfs, maps in _oracle_cases(n):
        ours = debug.DebugOracle(tctx, in_wid, kp, kind, 4.0, ls, cfs, maps)
        theirs = jdebug.DebugOracle(jctx, in_wid, kp, kind, 4.0, ls, cfs,
                                    maps)
        assert ours.golden and theirs.golden
        for f in ("mode", "golden", "w_slots", "keep", "cfs", "brv"):
            _same(getattr(ours, f), getattr(theirs, f))


# ---------------------------------------------------------------------------
# the whole encrypted ResNet-8, port only
# ---------------------------------------------------------------------------

@pytest.mark.slow_e2e
def test_resnet8_mini_end_to_end(ctxs):
    """(h) tests/test_resnet_mini.py's model, weights, image and bars on
    the port: seven bootstrapped layers and the FC head."""
    _, tctx = ctxs
    cfg = CONFIGS["wide1_d8"]
    runner = tres.ResNetRunner(tctx, tres.ResNetConfig(**cfg), BOOT)
    w = _weights(cfg)
    # the JAX test's boost of the head: the top-2 logit gap dominates the
    # encrypted error
    w.fc_w = w.fc_w * 6.0
    w.fc_b = w.fc_b * 2.0
    image = _image(cfg)
    timings = {}
    logits = runner.infer(image, w, timings)
    want = plain.plain_forward(w, image, 8, runner.cfg.raw_in_wids)
    assert logits.shape == want.shape
    err = np.max(np.abs(logits - want))
    assert err < 0.15, f"logits err {err}: enc {logits} vs plain {want}"
    assert np.argmax(logits) == np.argmax(want), (logits, want)
    assert sorted(runner.btps._live) == [1, 2, 3, 4]
