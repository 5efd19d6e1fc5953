"""The port's split bootstrapper against the JAX package (CPU, plain
versions of the kernels), at logN 9 on ``mini_boot_params(9)``.

Both packages get the same secret key from the same context seed and
encrypt from the same draws; the switching keys (plain Galois keys for
the giants and the conjugation, pre-permuted hoisting keys for the
babies) are made by the JAX context while it runs and are carried across
through ``interop`` AFTER that run.  The port must then run without
making a key of its own.  Residues are compared with ``np.array_equal``,
levels and scales with ``==``; the roundtrips are also held to the JAX
tests' decrypt-level bars (2e-2 after ``ctos``, 3e-2 after ``stoc``).

The JAX side of a whole bootstrap takes minutes, so tier-1 runs the port
alone there, each case on a fresh context and on keys it draws itself
(each from its own seed), and compares its outputs with the JAX
package's recorded as digests in ``tests/golden/torch_jax_replays.json``
("full_bootstrap", "sparse_bootstrap").  The slow_e2e replay here checks
the recording: the JAX package's bootstraps on the port's keys, carried
by ``interop.save_keys``, JAX making none.
"""

import contextlib
import dataclasses
import math

import numpy as np
import pytest
import torch

from optimal_conv_tpu.ckks import bootstrap as jboot
from optimal_conv_tpu.ckks.context import CkksContext as JaxContext
from optimal_conv_tpu.ckks.params import mini_boot_params as jax_mini

from optimal_conv_tpu_torch import interop
from optimal_conv_tpu_torch.ckks import bootstrap as tboot
from optimal_conv_tpu_torch.ckks.context import CkksContext
from optimal_conv_tpu_torch.ckks.params import mini_boot_params
from optimal_conv_tpu_torch.ops.repack import reverse_bits
from optimal_conv_tpu_torch.utils import tracing

from .test_torch_pipeline import (_against_recording, _digest,
                                  _on_port_keys, _replay_entry, _to_jax)

CPU = torch.device("cpu")
LOG_N = 9
SEED = 13
BOOT = dict(k_range=12.0, sin_deg=31, double_angle=3)
LT_LEVEL = 3                      # the top StoC level: 4 limbs, one digit

# one intra-op thread a worker: the suite runs in several workers at once
torch.set_num_threads(1)


class Pair:
    def __init__(self):
        self.j = JaxContext(jax_mini(LOG_N), seed=SEED)
        self.t = CkksContext(mini_boot_params(LOG_N), CPU, seed=SEED)
        self.rng = np.random.default_rng(17)

    def sync_keys(self) -> int:
        """Carry every switching key the JAX context holds across."""
        keys = {key: (np.asarray(swk.d0), np.asarray(self.j.swk_d1(swk)))
                for key, swk in self.j._swk_cache.d.items()}
        return interop.load_switching_keys(self.t, keys)

    def run_port(self, fn):
        """fn() on the port after the JAX side ran: on the JAX keys only."""
        assert self.sync_keys() > 0
        held = len(self.t.switching_keys)
        out = fn()
        assert len(self.t.switching_keys) == held, "the port made a key"
        return out

    def encrypt_slots(self, z, level):
        scale = self.j.params.scale
        return (self.j.encrypt(self.j.encoder.encode_slots(z, scale, level)),
                self.t.encrypt(self.t.encoder.encode_slots(z, scale, level)))

    def encrypt_coeffs(self, v, scale):
        return (self.j.encrypt(self.j.encoder.encode_coeffs(v, scale, 0)),
                self.t.encrypt(self.t.encoder.encode_coeffs(v, scale, 0)))

    @contextlib.contextmanager
    def layout(self, **extra):
        """Both parameter sets with extra boot_layout entries, for the
        bootstrappers built inside (a bootstrapper reads the layout only
        while it is built)."""
        lays = [self.j.params.boot_layout, self.t.params.boot_layout]
        for lay in lays:
            lay.update(extra)
        try:
            yield
        finally:
            for lay in lays:
                for k in extra:
                    del lay[k]


@pytest.fixture(scope="module")
def pair():
    return Pair()


def _same_poly(t, j):
    assert np.array_equal(interop.to_numpy(t), np.asarray(j))


def _same(t, j):
    assert t.level == j.level and t.scale == j.scale
    _same_poly(t.c0, j.c0)
    _same_poly(t.c1, j.c1)


def _complex(rng, n):
    return rng.uniform(-1, 1, n) + 1j * rng.uniform(-1, 1, n)


def test_mod_raise_bit_exact(pair):
    p = pair.t.params
    v = pair.rng.uniform(-1, 1, p.n)
    delta0 = 2.0 ** (55 - 8)
    jct, tct = pair.encrypt_coeffs(v, delta0)
    _same(tct, jct)
    jr, tr = jboot.mod_raise(pair.j, jct), tboot.mod_raise(pair.t, tct)
    assert tr.level == p.max_level
    _same(tr, jr)
    # the message survives mod q0 (tests/test_bootstrap.py)
    got = pair.t.encoder.decode_coeffs(pair.t.decrypt_to_coeffs(tr)[:1], delta0)
    np.testing.assert_allclose(got, v, atol=1e-4)
    with pytest.raises(ValueError):
        tboot.mod_raise(pair.t, tr)


def test_one_source_limb_extender_counts_like_jax(pair):
    """``mod_raise`` extends from ONE source limb; the float32 correction
    count there is 0 or 1 and must be the JAX package's on every
    coefficient, also on the values next to 0 and q0."""
    p = pair.t.params
    idx = p.q_idx(p.max_level)
    q0 = p.q_moduli[0]
    x = pair.rng.integers(0, q0, p.n, dtype=np.int64)
    x[:6] = [0, 1, 2, q0 - 1, q0 - 2, q0 // 2]
    want = np.asarray(pair.j.params.extender((0,), idx).extend(
        np.asarray(x[None].view(np.uint64))))
    got = pair.t.tables.extender((0,), idx).extend(torch.from_numpy(x[None]))
    _same_poly(got, want)


LT_KEYS = {"dense": (0, 1, 2, 5, 9, 12), "strided": (0, 16, 32, 48, 80, 112),
           "no identity baby": (3, 7), "single giant": (0,)}


@pytest.mark.parametrize("dh", [False, True], ids=["single", "double"])
@pytest.mark.parametrize("keys", list(LT_KEYS))
def test_linear_transform_bit_exact(pair, keys, dh):
    n = pair.t.params.slots
    diags = {k: _complex(pair.rng, n) for k in LT_KEYS[keys]}
    z = _complex(pair.rng, n)
    jct, tct = pair.encrypt_slots(z, LT_LEVEL)
    jlt = jboot.LinearTransform(pair.j, diags, LT_LEVEL, double_hoist=dh)
    tlt = tboot.LinearTransform(pair.t, diags, LT_LEVEL, double_hoist=dh)
    assert (tlt.bs, tlt.babies) == (jlt.bs, jlt.babies)
    assert len(tlt.stacked) == len(jlt.stacked)
    for (tg, tsel, tpts, tdev), (jg, jsel, jpts) in zip(tlt.stacked,
                                                        jlt.stacked):
        assert tg == jg and np.array_equal(tsel, jsel)
        _same_poly(tpts, jpts)
        assert (tdev is None) == (len(tsel) == len(tlt.babies))
    if keys == "single giant":
        assert tlt.giants() == [] and tlt.babies == [0]
    if keys == "strided":
        assert tlt.bs % 16 == 0 and len(tlt.babies) > 1
    jout = jlt(jct)
    tout = pair.run_port(lambda: tlt(tct))
    assert tout.level == LT_LEVEL - 1
    _same(tout, jout)
    want = sum(v * np.roll(z, -k) for k, v in diags.items())
    np.testing.assert_allclose(pair.t.decrypt_decode_slots(tout), want,
                               atol=2e-2)


def test_linear_transform_without_rescale(pair):
    p = pair.t.params
    diags = {k: _complex(pair.rng, p.slots) for k in (0, 1, 2, 5, 9, 12)}
    z = _complex(pair.rng, p.slots)
    jct, tct = pair.encrypt_slots(z, LT_LEVEL)
    sq = float(np.sqrt(p.q_moduli[LT_LEVEL]))
    kw = dict(pt_scale=sq, rescale=False, double_hoist=True)
    jout = jboot.LinearTransform(pair.j, diags, LT_LEVEL, **kw)(jct)
    tlt = tboot.LinearTransform(pair.t, diags, LT_LEVEL, **kw)
    tout = pair.run_port(lambda: tlt(tct))
    assert tout.level == LT_LEVEL and tout.scale == tct.scale * sq
    _same(tout, jout)
    with pytest.raises(ValueError):
        tlt(pair.t.drop_level(tct, 1))
    with pytest.raises(ValueError):
        tboot.LinearTransform(pair.t, {}, LT_LEVEL)


@pytest.mark.parametrize("method", ["cheby", "minimax"])
def test_fit_cos_poly_equal(method):
    args = (31, 12.0, 3)
    assert np.array_equal(tboot.fit_cos_poly(*args, method=method),
                          jboot.fit_cos_poly(*args, method=method))
    with pytest.raises(ValueError):
        tboot.fit_cos_poly(7, 12.0, 3, method="remez")


def _jax_boot(jctx, monkeypatch, ls, dh):
    monkeypatch.setenv("OPTCONV_DOUBLE_HOIST", "1" if dh else "0")
    return jboot.SplitBootstrapper(jctx, log_sparse=ls, **BOOT)


def _same_build(jbt, tbt):
    assert (tbt.delta0, tbt.delta_m, tbt.post_ctos_level,
            tbt.post_stoc_level) == (jbt.delta0, jbt.delta_m,
                                     jbt.post_ctos_level, jbt.post_stoc_level)
    assert [(lt.level, lt.pt_scale, lt.rescale, lt.dh, lt.bs, lt.babies)
            for lt in tbt.ctos_lt + tbt.stoc_lt] == \
        [(lt.level, lt.pt_scale, lt.rescale, lt.dh, lt.bs, lt.babies)
         for lt in jbt.ctos_lt + jbt.stoc_lt]


# the recorded cases: a fresh context's first encryption of uniform(-1, 1)
# coefficients drawn from `rng` (every 2^log_sparse-th, the rest 0), put
# through ``ctos`` and ``stoc``
CASES = {
    "full_bootstrap": dict(seed=SEED, rng=17, log_n=LOG_N, boot=BOOT,
                           log_sparse=0, double_hoist=True, stoc_groups=None),
    "sparse_bootstrap": dict(seed=SEED, rng=23, log_n=LOG_N, boot=BOOT,
                             log_sparse=1, double_hoist=False, stoc_groups=3),
}


def _port_case(name):
    """The port's half of a recorded case, on a context of its own: the
    shared ``pair.t`` holds keys carried from JAX by the other tests."""
    c = CASES[name]
    ls = c["log_sparse"]
    ctx = CkksContext(mini_boot_params(LOG_N, stoc_groups=c["stoc_groups"]),
                      CPU, seed=SEED)
    tbt = tboot.SplitBootstrapper(ctx, log_sparse=ls,
                                  double_hoist=c["double_hoist"], **BOOT)
    v = np.zeros(ctx.params.n)
    v[:: 1 << ls] = np.random.default_rng(c["rng"]).uniform(
        -1, 1, ctx.params.n >> ls)
    tct = ctx.encrypt(ctx.encoder.encode_coeffs(v, tbt.delta0, 0))
    stages = []
    tup, tlow = tbt.ctos(tct, on_stage=lambda stage, _: stages.append(stage))
    tout = tbt.stoc(tup, tlow)
    return dict(name=name, ctx=ctx, tbt=tbt, v=v, tct=tct, stages=stages,
                tup=tup, tlow=tlow, tout=tout)


@pytest.fixture(scope="module")
def full():
    return _port_case("full_bootstrap")


@pytest.fixture(scope="module")
def sparse():
    return _port_case("sparse_bootstrap")


def _entry(run, **cts):
    """The replay entry of a port run; the ciphertexts in `cts` (JAX's)
    stand in for the port's of the same name."""
    outs = {"jup": run["tup"], "jlow": run["tlow"], "jout": run["tout"],
            **cts}
    return _replay_entry(CASES[run["name"]], run["ctx"],
                         **{k: ct for k, ct in outs.items() if ct is not None})


def test_full_bootstrap_bit_exact_and_roundtrip(pair, full, monkeypatch):
    """log_sparse 0, double-hoisted: two ciphertexts in bit-reversed slot
    order after ``ctos``, the coefficients back after ``stoc``; all three
    equal to JAX's recorded ones."""
    ctx, tbt, tup, tlow, tout = (full[k] for k in ("ctx", "tbt", "tup",
                                                   "tlow", "tout"))
    p = ctx.params
    _same_build(_jax_boot(pair.j, monkeypatch, 0, True), tbt)
    assert full["stages"] == ["ctos.raise+subsum", "ctos.lt0", "ctos.lt1",
                              "ctos.lt2", "ctos.conj", "ctos.evalmod"]
    _against_recording(full_bootstrap=_entry(full))
    assert tout.level == 1
    v = full["v"]
    br = np.array([reverse_bits(i, p.log_slots) for i in range(p.slots)])
    np.testing.assert_allclose(ctx.decrypt_decode_slots(tup).real, v[br],
                               atol=2e-2)
    np.testing.assert_allclose(ctx.decrypt_decode_slots(tlow).real,
                               v[br + p.slots], atol=2e-2)
    np.testing.assert_allclose(ctx.decrypt_decode_coeffs(tout), v, atol=3e-2)
    with pytest.raises(ValueError):
        tbt.stoc(tup, None)


@pytest.mark.parametrize("fault", ["c1 residue", "scale ulp"])
def test_recording_sees_a_planted_fault(full, fault):
    """The comparison with the recording reads the residues and the scale:
    one residue of the bootstrap output's c1 one higher, or its scale one
    ulp larger, fails it."""
    tout = full["tout"]
    if fault == "c1 residue":
        c1 = tout.c1.clone()
        q = full["ctx"].params.q_moduli[1]
        c1[1, 7] = (c1[1, 7] + 1) % q
        bad = dataclasses.replace(tout, c1=c1)
    else:
        bad = dataclasses.replace(tout, scale=math.nextafter(tout.scale,
                                                             math.inf))
    _against_recording(full_bootstrap=_entry(full))
    with pytest.raises(AssertionError, match="jout"):
        _against_recording(full_bootstrap=_entry(full, jout=bad))


def test_sparse_bootstrap_bit_exact_and_roundtrip(pair, sparse, monkeypatch):
    """log_sparse 1, single-hoisted, with three StoC matrices on the two
    StoC levels: the top level holds two, the first at √q un-rescaled;
    both outputs equal to JAX's recorded ones."""
    ctx, tbt, tf, tout = (sparse[k] for k in ("ctx", "tbt", "tup", "tout"))
    p = ctx.params
    ls = 1
    with pair.layout(stoc_groups=3):
        _same_build(_jax_boot(pair.j, monkeypatch, ls, False), tbt)
    assert [(lt.level, lt.rescale) for lt in tbt.stoc_lt] == \
        [(3, False), (3, True), (2, True)]
    assert sparse["tlow"] is None
    _against_recording(sparse_bootstrap=_entry(sparse))
    v = sparse["v"]
    n_sub = p.slots >> ls
    z = ctx.decrypt_decode_slots(tf).real
    cp = v[:: 1 << ls]
    br = np.array([reverse_bits(i, p.log_slots - ls) for i in range(n_sub)])
    np.testing.assert_allclose(z[:n_sub], cp[br], atol=2e-2)
    np.testing.assert_allclose(z[n_sub: 2 * n_sub], cp[br + n_sub], atol=2e-2)
    np.testing.assert_allclose(ctx.decrypt_decode_coeffs(tout), v, atol=3e-2)


def _ctos_stoc(bt, ct):
    up, low = bt.ctos(ct)
    return up, low, bt.stoc(up, low)


@pytest.mark.slow_e2e
def test_replay_jax_bootstraps_on_the_port_keys(full, sparse, tmp_path,
                                                monkeypatch):
    """The recording's source: in each recorded case, the JAX package's
    ``ctos`` + ``stoc`` on the port's switching keys (``interop.save_keys``
    → its ``load_keys``; it makes none), from the port's input ciphertext,
    give the recorded digests, and the port's outputs the same."""
    entries = {}
    for run in (full, sparse):
        c = CASES[run["name"]]
        jctx = JaxContext(jax_mini(LOG_N, stoc_groups=c["stoc_groups"]),
                          seed=SEED)
        jbt = _jax_boot(jctx, monkeypatch, c["log_sparse"], c["double_hoist"])
        jct = _to_jax(run["tct"])
        jup, jlow, jout = _on_port_keys(
            jctx, run["ctx"], str(tmp_path / f"{run['name']}.npz"),
            lambda: _ctos_stoc(jbt, jct))
        assert (jlow is None) == (run["tlow"] is None)
        entries[run["name"]] = _entry(run, jup=jup, jlow=jlow, jout=jout)
        for t, j in [("tup", jup), ("tlow", jlow), ("tout", jout)]:
            if j is not None:
                assert _digest(run[t]) == _digest(j), (run["name"], t)
    _against_recording(**entries)


def test_family_builds_lazily_and_bounds_residency(pair):
    fam = tboot.BootstrapperFamily(pair.t, BOOT)
    assert 1 not in fam
    before = tracing.counters()
    with tracing.collect():
        b1 = fam[1]
    assert fam[1] is b1
    after = tracing.counters()
    # one build, counted with its host seconds and recorded as a span
    assert after["boot.builds"] - before.get("boot.builds", 0) == 1
    assert after["boot.build_s"] - before.get("boot.build_s", 0.0) > 0
    build = [r for r in tracing.records() if r["name"] == "boot.build"][-1]
    assert build["attrs"] == {"log_sparse": 1} and build["parent"] == 0
    assert b1.plaintext_bytes() == sum(
        pts.numel() * 8 for lt in b1.ctos_lt + b1.stoc_lt
        for _, _, pts, _ in lt.stacked) + 2 * b1.fold_a_pt.poly.numel() * 8
    small = tboot.BootstrapperFamily(pair.t, BOOT, max_live=1)
    s1, _ = small[1], small[2]
    assert 1 not in small and 2 in small and small[1] is not s1
