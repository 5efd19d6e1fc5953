"""The whole fused layer on limb-sharded contexts (``parallel/limbs.py``)
over real gloo process groups, against the port's single-device context.

Every rank of a world holds a ``LimbShardedContext`` of the same seed
and runs ``ops/pipeline.eval_conv_bn_relu`` unchanged on its own RNS
limbs (``tests/torch_parallel_layer_ranks.py``, which imports no JAX);
each output, gathered whole, must equal the single device's residue for
residue, with equal level and scale.  The bit-parity to JAX is
transitive in the default tier: the port's single-device layer equals
the JAX package's bit for bit (``tests/test_torch_block_layer.py``), so
a sharded layer equal to it equals JAX's.  The slow tier also runs the
JAX module's own sharded-layer geometry (``tests/test_parallel.py``) on
the JAX keys against the JAX single-device layer.

Default tier, one spawn of 4 ranks: ``dryrun_fused_layer``'s leg 1 at tp
4, and the pieces of a layer (encryption, double-hoisted rotations, both
BSGS forms, ``mod_raise``, the conv's rescale 1 → 0 and level-0 pack) at
tp 4 on a chain of two P limbs, where at level 0 one rank holds neither
a Q nor a P limb.  And the key's uniform half drawn by rows (K11's plain
version) against the whole draw and against JAX's.
"""

import json

import numpy as np
import pytest
import torch

from optimal_conv_tpu.ckks.context import CkksContext as JaxContext
from optimal_conv_tpu.ckks.params import tiny_params as jax_tiny
from optimal_conv_tpu_torch.ckks.context import CkksContext
from optimal_conv_tpu_torch.ckks.params import (DeviceTables, mini_boot_params,
                                                tiny_params)
from optimal_conv_tpu_torch.core import d1_kernel, threefry
from optimal_conv_tpu_torch.core import ntt as nttmod
from optimal_conv_tpu_torch.parallel import sharding as sh
from optimal_conv_tpu_torch.parallel.limbs import LimbPlacement
from tests import torch_parallel_layer_ranks as ranks

torch.set_num_threads(1)
CPU = torch.device("cpu")
WORLD = 4


def _equal(got: dict, want: dict, what: str) -> None:
    assert (got["level"], got["scale"]) == (want["level"], want["scale"]), what
    assert np.array_equal(got["c0"], want["c0"]), what
    assert np.array_equal(got["c1"], want["c1"]), what


@pytest.fixture(scope="module")
def world():
    """The single-device references, and one spawn of 4 gloo ranks: the
    pieces at tp 4, and ``dryrun_fused_layer``'s leg 1 at tp 4."""
    single = ranks.pieces(CkksContext(ranks.PIECES, CPU,
                                      seed=ranks.PIECES_SEED))
    ctx = CkksContext(mini_boot_params(9, n_relu=14, stoc_groups=3), CPU,
                      seed=sh.FUSED_SEED)
    digest = sh._ct_digest(sh.fused_layer_legs(ctx, (1,))[1])
    got = sh.run_ranks(ranks.run_dryrun, WORLD, ((1,),), backend="gloo",
                       timeout=600)
    return single, digest, got


def test_dryrun_fused_layer_leg1_tp4(world):
    """Leg 1 (``Conv_sparse``, keep repack, log_sparse 1) at tp 4: every
    rank's output equals the single-device layer residue for residue,
    with equal level and scale (by digest)."""
    _, digest, got = world
    for r, res in enumerate(got):
        assert res["dryrun"]["digests"][1] == digest, r
        comm = res["dryrun"]["comm"]
        # every key switch gathers c1 and the P rows, every rescale and
        # the ModRaise broadcast one limb; the same calls on every rank
        assert comm["c1 all_gather"][0] > 0 and comm["P all_gather"][0] > 0
        assert comm["limb broadcast"][0] > 0
        assert comm == got[0]["dryrun"]["comm"]
    # 31 limbs over tp 4 after ModRaise: ranks hold 8, 8, 8, 7
    raised = [dict((s, q) for s, q, _ in res["dryrun"]["limbs"])
              ["ctos.raise+subsum"] for res in got]
    assert raised == [[8], [8], [8], [7]]


@pytest.mark.parametrize("case", ["encrypt", "lazy 0", "lazy 2", "bsgs 2",
                                  "bsgs 0 dh", "mod_raise", "conv"])
def test_layer_pieces_tp4(world, case):
    """Each piece at tp 4 on two P limbs equals the single device: the
    sharded encryption is the rank's rows of the whole one; the raw
    double-hoisted triples (φ(c0), acc0, acc1 on QP); both BSGS forms
    (the double-hoisted one at level 0, where rank 1 holds no limb);
    ``mod_raise`` (limb 0 broadcast); the conv's rescale 1 → 0 and the
    level-0 key switches of its pack."""
    single, _, got = world
    keys = [k for k in single if k == case or k.startswith(case + " ")]
    assert keys
    for r, res in enumerate(got):
        for k in keys:
            want, have = single[k], res["pieces"][k]
            if isinstance(want, list):
                for a, b in zip(have, want):
                    assert np.array_equal(a, b), f"rank {r} {k}"
            else:
                _equal(have, want, f"rank {r} {k}")


def test_a_rank_holds_no_limb(world):
    """At level 0 over tp 4 with two P limbs rank 1 holds neither a Q nor
    a P limb and still joins every collective; the keys every rank made
    alone are the rows of the single device's."""
    single_ctx = CkksContext(ranks.PIECES, CPU, seed=ranks.PIECES_SEED)
    for r, res in enumerate(world[2]):
        assert res["limbs_0"] == [(1, 0), (0, 0), (0, 1), (0, 1)]
        for tag, (rows, d0, d1) in res["keys"].items():
            swk = single_ctx.galois_key(tag[1], tag[2]) if tag[0] == "gal" \
                else single_ctx.galois_key_hoisted(tag[1], tag[2])
            sel = [ranks.PIECES.qp_idx(tag[2]).index(i) for i in rows]
            assert np.array_equal(d0, swk.d0[:, sel].numpy()), (r, tag)
            assert np.array_equal(d1, single_ctx.swk_d1(swk)[:, sel].numpy())


def test_placement():
    pl = LimbPlacement(mini_boot_params(9, n_relu=14), 4)
    assert pl.q_rows(30, 1) == tuple(range(1, 31, 4))
    assert [c for c, _ in pl.counts(30)] == [8, 8, 8, 7]
    # P limbs from the last rank down: the ranks the Q limbs leave short
    assert [len(pl.p_rows(r)) for r in range(4)] == [1, 1, 1, 1]
    assert pl.counts(2) == [(1, 1), (1, 1), (1, 1), (0, 1)]
    assert sorted(i for r in range(4) for i in pl.p_rows(r)) == list(
        pl.params.p_idx())
    for lv in (0, 7, 30):
        assert sorted(i for r in range(4) for i in pl.q_rows(lv, r)) == list(
            range(lv + 1))


def test_a_dropped_context_is_freed_at_once():
    """A context, single-device or limb-sharded, with its keys and
    plaintext caches, is freed when its last reference goes, without the
    cyclic collector: a context in a cycle would hold its keys on the
    card until a collection happens to run."""
    import gc
    import weakref

    from optimal_conv_tpu_torch.parallel.limbs import LimbShardedContext

    gc.disable()
    try:
        for make in (lambda: CkksContext(ranks.PIECES, CPU, seed=1),
                     lambda: LimbShardedContext(ranks.PIECES, CPU,
                                                sh.make_mesh(1), seed=1)):
            ctx = make()
            ct = ctx.encrypt(ctx.encoder.encode_coeffs(np.ones(8), 2.0 ** 30,
                                                       2))
            ctx.rotate(ct, 1)
            ref = weakref.ref(ctx)
            del ctx, ct
            assert ref() is None
    finally:
        gc.enable()


def test_dryrun_fused_layer_refuses():
    with pytest.raises(ValueError):
        sh.dryrun_fused_layer(2, device="cpu")      # no world of 2 here
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):           # the card, unless asked
            sh.dryrun_fused_layer(1)


# ---------------------------------------------------------------------------
# K11's row subset (plain version; the kernel is held on the card by
# tests/test_torch_cuda.py and chip_smoke.py)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("permuted", [False, True], ids=["plain", "galh"])
@pytest.mark.parametrize("rows", [(0, 4, 8), (1, 5), (3, 7, 9), (2, 6, 10)])
def test_uniform_mont_rows_equal_the_whole_draw(rows, permuted):
    """A rank's rows of a key, drawn alone at their counters in the whole
    key, equal the whole draw's rows bit for bit, with and without the
    pre-permutation; the rows of tp 4's ranks at level 8 of a chain of
    two P limbs."""
    p = tiny_params(log_n=8, levels=8)
    tables = DeviceTables(p, CPU)
    level = 8
    qp = p.qp_idx(level)
    beta = len(p.digits(level))
    perm = None
    if permuted:
        g = pow(nttmod.rot_to_galois(3, p.log_n), -1, 2 * p.n)
        perm = torch.from_numpy(nttmod.galois_perm_ntt(p.log_n, g).copy())
    seed = (1 << 40) + 77
    whole = threefry.uniform_mont(seed, beta, *tables.ntt.tabs(qp), p.n, perm)
    mine = tuple(qp[j] for j in rows)
    d1_kernel.STATS.reset()
    got = threefry.uniform_mont(seed, beta, *tables.ntt.tabs(mine), p.n,
                                perm, rows=rows, nqp=len(qp))
    assert (d1_kernel.STATS.plain_calls, d1_kernel.STATS.launches) == (1, 0)
    assert got.shape == (beta, len(rows), p.n)
    assert torch.equal(got, whole[:, list(rows)])


def test_uniform_mont_rows_equal_jax_swk_d1(monkeypatch):
    """The rows of a seed-compressed JAX key's uniform half, plain and
    pre-permuted ("galh"), drawn alone from its seed equal JAX's
    ``swk_d1`` rows."""
    monkeypatch.setenv("OPTCONV_COMPRESS_KEYS", "1")
    jctx = JaxContext(jax_tiny(log_n=8, levels=5), seed=5)
    p = tiny_params(log_n=8, levels=5)
    tables = DeviceTables(p, CPU)
    level = 5
    qp = p.qp_idx(level)
    g = nttmod.rot_to_galois(1, p.log_n)
    for swk in (jctx.galois_key(g, level), jctx.galois_key_hoisted(g, level)):
        assert swk.d1 is None and swk.seed is not None
        want = np.asarray(jctx.swk_d1(swk)).view(np.int64)
        perm = None if swk.perm is None else torch.from_numpy(
            np.asarray(swk.perm).astype(np.int64))
        for r in range(WORLD):
            pl = LimbPlacement(p, WORLD)
            mine = pl.q_rows(level, r) + pl.p_rows(r)
            rows = tuple(qp.index(i) for i in mine)
            got = threefry.uniform_mont_plain(
                swk.seed, swk.d0.shape[0], *tables.ntt.tabs(mine), p.n, perm,
                rows=rows, nqp=len(qp))
            assert np.array_equal(got.numpy(), want[:, list(rows)]), r


def test_d1_regen_cuda_checks_rows():
    tables = DeviceTables(tiny_params(log_n=8, levels=3), CPU)
    tabs = tables.ntt.tabs((0, 1))
    with pytest.raises(ValueError):      # CPU tensors: never computed here
        d1_kernel.d1_regen_cuda(1, 1, *tabs, 256, rows=(0, 1), nqp=6)


# ---------------------------------------------------------------------------
# slow tier: every leg on every mesh, and JAX's own geometry on its keys
# ---------------------------------------------------------------------------

@pytest.mark.slow_e2e
def test_fused_layer_all_legs_tp2_tp4_dp2tp2():
    """The three legs at tp 2 (a world of 2), at tp 4 and at dp 2 × tp 2
    (a world of 4): every rank's output equals the single device's, and
    ``dryrun_fused_layer``'s own check passes at tp 2."""
    ctx = CkksContext(mini_boot_params(9, n_relu=14, stoc_groups=3), CPU,
                      seed=sh.FUSED_SEED)
    want = {leg: ranks.arrays(ctx, o)
            for leg, o in sh.fused_layer_legs(ctx).items()}
    got = (sh.run_ranks(ranks.run, 2, (("tp",), (1, 2, 3), 9),
                        backend="gloo", timeout=1800)
           + sh.run_ranks(ranks.run, WORLD, (("tp", "dp 2 x tp 2"),
                                             (1, 2, 3), 9),
                          backend="gloo", timeout=1800))
    for r, res in enumerate(got):
        for kind, case in res.items():
            for leg, arr in case["legs"].items():
                _equal(arr, want[leg], f"rank {r} {kind} leg {leg}")
    sh.run_ranks(ranks.run_dryrun_checked, 2, (), backend="gloo",
                 timeout=1800)


@pytest.mark.slow_e2e
@pytest.mark.parametrize("kind", ["tp", "dp 2 x tp 2"])
def test_sharded_layer_on_jax_keys_equals_jax(tmp_path, monkeypatch, kind):
    """``tests/test_parallel.py``'s ``test_sharded_fused_layer_bit_exact``
    geometry (logN 10, seed 19, log_sparse 2, k_range 12, sin_deg 31,
    double_angle 3): the port's layer on 4 limb-sharded ranks, on the
    JAX keys, equals JAX's single-device ``eval_conv_bn_relu``."""
    from optimal_conv_tpu.ckks.bootstrap import SplitBootstrapper as JaxBoot
    from optimal_conv_tpu.ckks.params import mini_boot_params as jax_mini
    from optimal_conv_tpu.ops import conv as jconv
    from optimal_conv_tpu.ops import pipeline as jpipe
    from optimal_conv_tpu.ops import repack as jrp

    monkeypatch.setenv("OPTCONV_DOUBLE_HOIST", "1")
    seed, boot = 19, dict(k_range=12.0, sin_deg=31, double_angle=3)
    jctx = JaxContext(jax_mini(10, n_relu=14), seed=seed)
    n = jctx.params.n
    in_wid, kw, norm, ls = 16, 3, 4, 2
    raw = in_wid - kw // 2
    real_b = n // (in_wid * in_wid) // norm
    rng = np.random.default_rng(41)
    img = rng.uniform(-0.8, 0.8, (raw, raw, real_b))
    ker = rng.uniform(-1, 1, (kw, kw, real_b, real_b)) / 4.0
    bn_a = rng.uniform(0.8, 1.2, real_b)
    bn_b = rng.uniform(-0.2, 0.2, real_b)
    inp = jconv.prep_input(img.ravel(), raw, in_wid, n, norm)
    ct = jctx.encrypt(jctx.encoder.encode_coeffs(inp, jctx.params.scale, 1))
    out = jpipe.eval_conv_bn_relu(
        jctx, {ls: JaxBoot(jctx, log_sparse=ls, **boot)}, ct, ker.ravel(),
        bn_a, bn_b, 0.0, 4.0, in_wid, raw, kw, real_b, real_b, norm, 0, 1, 2,
        ls, "Conv_sparse", jpipe.LayerMaps(ext_idx=[
            jrp.gen_keep_vec_sparse(n // 2, in_wid, raw, ls), None]))
    keys = list(jctx._swk_cache.d.items())
    arrays = {f"d{h}_{i}": np.asarray(swk.d0 if h == 0 else jctx.swk_d1(swk))
              for i, (_, swk) in enumerate(keys) for h in (0, 1)}
    path = tmp_path / "jax.npz"
    np.savez(path, c0=np.asarray(ct.c0), c1=np.asarray(ct.c1), ker=ker.ravel(),
             bn_a=bn_a, bn_b=bn_b, tags=json.dumps([list(t) for t, _ in keys]),
             geometry=json.dumps(dict(seed=seed, scale=ct.scale, ls=ls,
                                      in_wid=in_wid, raw=raw, ker_wid=kw,
                                      real_b=real_b, norm=norm, pow=4.0,
                                      boot=boot)), **arrays)
    got = sh.run_ranks(ranks.run_jax_keys, WORLD, (str(path), kind),
                       backend="gloo", timeout=1800)
    want = dict(c0=np.asarray(out.c0), c1=np.asarray(out.c1),
                level=out.level, scale=out.scale)
    for r, res in enumerate(got):
        assert res["made"] == 0, f"rank {r} made a key"
        _equal(res["out"], want, f"rank {r}")
