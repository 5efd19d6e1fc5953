"""The port's sp axis (``parallel/coeffs.py``) against the JAX package.

JAX shards the coefficient axis of its (dp, tp, sp) mesh in
``tests/test_parallel.py`` (``test_coeff_axis_sharding_matches_single_device``)
and lets GSPMD insert the NTT's stage exchanges.  Here the distributed
NTT, the sharded Galois gather, the rotated key switch and the layer step
run over real gloo process groups, in one spawn of 4 ranks
(``tests/torch_coeff_ranks.py``, which imports no JAX) on the (tp, sp),
(dp, sp) and sp-only meshes of that world, at levels 7 and 2, each check
bit for bit against the JAX single device; the JAX side hands its
ciphertext, plaintexts and keys over as an ``.npz``.  In one process:
the cross stages with every shard emulated, the shard tables, the
Galois element's shard map, and the mesh and layouts at sp 1 and above.
"""

import math

import numpy as np
import pytest
import torch

from optimal_conv_tpu.ckks.context import CkksContext as JaxContext
from optimal_conv_tpu.ckks.params import CkksParams as JaxParams
from optimal_conv_tpu.core import ntt as jax_ntt
from optimal_conv_tpu_torch.ckks.params import CkksParams
from optimal_conv_tpu_torch.core import ntt_kernel
from optimal_conv_tpu_torch.core.ntt import (NttContext, _ntt_fwd, _ntt_inv,
                                             galois_perm_ntt, ntt_cross_plain)
from optimal_conv_tpu_torch.parallel import coeffs
from optimal_conv_tpu_torch.parallel import sharding as sh
from tests import torch_coeff_ranks as ranks

torch.set_num_threads(1)

LOG_N = ranks.PARAMS["log_n"]
N = 1 << LOG_N
CASES = [(kind, level, check) for kind in ranks.MESHES
         for level in ranks.LEVELS for check in coeffs.CHECKS]


def _jax_refs(tmp_path_factory, meshes, world):
    """The JAX single-device results of every check at levels 7 and 2,
    and the results of a world of ranks on `meshes`."""
    params = JaxParams(**ranks.PARAMS)
    ctx = JaxContext(params, seed=0)
    rng = np.random.default_rng(0)
    v = rng.uniform(-1, 1, params.n)
    ct = ctx.encrypt(ctx.encoder.encode_coeffs(v, params.scale,
                                               params.max_level))
    g = jax_ntt.rot_to_galois(ranks.ROT, params.log_n)
    perm = np.asarray(jax_ntt.galois_perm_ntt(params.log_n, g))
    perm_inv = np.asarray(jax_ntt.galois_perm_ntt(
        params.log_n, jax_ntt.rot_to_galois(-ranks.ROT, params.log_n)))
    arrays, refs = {}, {}
    for level in ranks.LEVELS:
        c = ctx.drop_level(ct, ct.level - level)
        pt = ctx.encoder.encode_coeffs(rng.uniform(-1, 1, 8), params.scale,
                                       level)
        swk = ctx.galois_key(g, level)
        idx = params.q_idx(level)
        c0, c1 = np.asarray(c.c0), np.asarray(c.c1)
        ks = ctx.keyswitch(jax_ntt.apply_galois_ntt(c.c1, perm), level, swk)
        out = ctx.rescale(ctx.rotate(ctx.mul_plain(c, pt), ranks.ROT))
        fwd = np.asarray(params.ntt.ntt(c.c0, idx))
        inv = np.asarray(params.ntt.intt(c.c0, idx))
        refs[level] = {
            "context step": (np.asarray(out.c0), np.asarray(out.c1)),
            "ntt": (fwd, fwd), "intt": (inv, inv), "intt(ntt)": (c0, c0),
            "galois +rot": (c0[:, perm],) * 2,
            "galois -rot": (c0[:, perm_inv],) * 2,
            "keyswitch": tuple(np.asarray(k) for k in ks),
            "step": (np.asarray(out.c0), np.asarray(out.c1))}
        arrays.update({f"c0_{level}": c0, f"c1_{level}": c1,
                       f"pt_{level}": np.asarray(pt.poly),
                       f"d0_{level}": np.asarray(swk.d0),
                       f"d1_{level}": np.asarray(ctx.swk_d1(swk))})
    path = tmp_path_factory.mktemp("coeffs") / "inputs.npz"
    np.savez(path, **arrays)
    results = sh.run_ranks(ranks.run, world,
                           (str(path), meshes, meshes is ranks.MESHES),
                           backend="gloo")
    return refs, results


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    return _jax_refs(tmp_path_factory, ranks.MESHES, ranks.WORLD)


def _check_equal(refs, results, kind, level, check, batch):
    want = refs[level][check]
    for r, res in enumerate(results):
        got = res[(kind, level)][check]
        assert got.shape == (2, batch) + want[0].shape, (r, got.shape)
        for i in range(batch):
            np.testing.assert_array_equal(got[0, i], want[0], err_msg=f"rank {r}")
            np.testing.assert_array_equal(got[1, i], want[1], err_msg=f"rank {r}")


@pytest.mark.parametrize("kind,level,check", CASES)
def test_sp_matches_jax(sharded, kind, level, check):
    """Each check, gathered on every rank, equal to JAX's single device."""
    refs, results = sharded
    _check_equal(refs, results, kind, level, check, ranks.MESHES[kind][2])


@pytest.mark.parametrize("kind", [k for k, (s, _, _) in ranks.MESHES.items()
                                  if s[1] == 1])
@pytest.mark.parametrize("level", ranks.LEVELS)
def test_context_on_shards_matches_jax(sharded, kind, level):
    """Without tp, the context's own mul_plain, rotate (the sharded Galois
    gather, the key switch on the key's columns) and rescale run on the
    column shards unchanged and equal JAX's step."""
    refs, results = sharded
    _check_equal(refs, results, kind, level, "context step",
                 ranks.MESHES[kind][2])


def test_dryrun_coeffs(sharded):
    """``dryrun_coeffs`` at sp 2 on the world of 4 (tp 2 x sp 2) checks
    itself against the single device; every rank agrees, and its bytes
    name the step's tp collectives and the sp transfers."""
    _, results = sharded
    runs = [res["dryrun"] for res in results]
    assert all(r["digests"] == runs[0]["digests"] for r in runs)
    assert len(runs[0]["digests"]) == 2 * len(coeffs.CHECKS)
    moved = runs[0]["bytes"]
    assert set(moved) == {"c1 all_gather", "P all_gather", "top broadcast",
                          "ntt cross", "intt cross"}
    assert all(v[0] == v[1] > 0 for k, v in moved.items() if "cross" in k)


@pytest.mark.parametrize("kind", list(ranks.MESHES))
@pytest.mark.parametrize("level", ranks.LEVELS)
def test_sp_transfers(sharded, kind, level):
    """A forward NTT of a shard is log2(sp) exchanges of the whole shard;
    a conjugation one transfer of it (every shard moves); the step's tp
    collectives move N/sp columns a row."""
    _, results = sharded
    shape, sp, batch = ranks.MESHES[kind]
    tp = shape[1]
    for res in results:
        got = res[(kind, level)]
        shard = got["shard"]
        assert shard[-1] == N // sp
        nbytes = math.prod(shard) * 8
        stages = sp.bit_length() - 1
        assert got["ntt comm"] == {"ntt cross": [stages, stages * nbytes,
                                                 stages * nbytes]}
        src, dst, _ = coeffs.shard_galois(LOG_N, ranks.GALOIS_MOVED, sp,
                                          got["sp coord"])
        assert src != got["sp coord"] and dst != got["sp coord"]
        assert got["galois comm"] == {"galois": [1, nbytes, nbytes]}
        b_rank = batch // (len(results) // (tp * sp))
        assert got["bytes"]["c1 all_gather"][0] == b_rank * (level + 1) * N // sp * 8
        assert got["bytes"]["P all_gather"][0] == 2 * b_rank * 4 * N // sp * 8
        assert got["bytes"]["top broadcast"][0] == 2 * b_rank * N // sp * 8


# ---------------------------------------------------------------------------
# one process, no world
# ---------------------------------------------------------------------------

def _chain():
    p = CkksParams(**ranks.PARAMS)
    ntt = NttContext(p.moduli, LOG_N, "cpu")
    idx = tuple(range(len(p.moduli)))
    q, qinv = ntt.tabs(idx)[:2]
    rng = np.random.default_rng(3)
    a = torch.from_numpy(np.stack([rng.integers(0, m, (2, N)) for m in p.moduli],
                                  axis=-2))                  # [2, L, N]
    return ntt, q, qinv, a


def _emulate(ntt, q, qinv, a, sp, inverse):
    """Every rank of sp in one process: the cross stages on the partners'
    shards and the local sub-transform on the shard tables."""
    w, log_cols = N // sp, LOG_N - (sp.bit_length() - 1)
    tab = ntt.ipsi_br if inverse else ntt.psi_br
    shards = [a[..., s * w:(s + 1) * w] for s in range(sp)]

    def local(x, s):
        t = coeffs.shard_twiddles(tab, sp, s)
        if inverse:
            return _ntt_inv(x, t, ntt.n_inv[:, None], q, qinv, log_cols)
        return _ntt_fwd(x, t, q, qinv, log_cols)

    if inverse:
        shards = [local(x, s) for s, x in enumerate(shards)]
    plan = [coeffs.cross_stages(sp, s, inverse) for s in range(sp)]
    for k in range(len(plan[0])):
        shards = [ntt_cross_plain(shards[s], shards[plan[s][k][0]],
                                  tab[:, plan[s][k][2]][:, None], q, qinv,
                                  plan[s][k][1], inverse) for s in range(sp)]
    if not inverse:
        shards = [local(x, s) for s, x in enumerate(shards)]
    return torch.cat(shards, -1)


@pytest.mark.parametrize("sp", [2, 4, 8])
def test_cross_stages_emulated(sp):
    """log2(sp) cross stages then the shard's own sub-transform equal the
    whole forward NTT; the inverse in reverse returns the input."""
    ntt, q, qinv, a = _chain()
    want = _ntt_fwd(a, ntt.psi_br, q, qinv, LOG_N)
    assert torch.equal(_emulate(ntt, q, qinv, a, sp, False), want)
    assert torch.equal(_emulate(ntt, q, qinv, want, sp, True), a)
    assert torch.equal(_emulate(ntt, q, qinv, a, sp, True),
                       _ntt_inv(a, ntt.ipsi_br, ntt.n_inv[:, None], q, qinv,
                                LOG_N))


@pytest.mark.parametrize("sp", [2, 4, 8])
def test_shard_galois_maps_whole_shards(sp):
    """For 8 Galois elements σ is a permutation of the shards, each
    shard's image is one whole shard, and the shard-wise gather equals
    the whole permutation."""
    w = N // sp
    x = np.arange(N)
    for g in (5, 25, 125, 2 * N - 1, 3, 7, 11, 2 * N - 5):
        perm = galois_perm_ntt(LOG_N, g)
        got = [coeffs.shard_galois(LOG_N, g, sp, s) for s in range(sp)]
        sigma = [src for src, _, _ in got]
        assert sorted(sigma) == list(range(sp))
        for s, (src, dst, local) in enumerate(got):
            assert sigma[dst] == s
            assert np.all((perm[s * w:(s + 1) * w] // w) == src)
            assert np.array_equal(x[src * w:(src + 1) * w][local],
                                  x[perm][s * w:(s + 1) * w])


@pytest.mark.parametrize("sp", [2, 4])
def test_shard_twiddles_index_map(sp):
    """Entry m' + b of rank s's table is psi_br[m'·(sp + s) + b]."""
    ntt = _chain()[0]
    w = N // sp
    for s in range(sp):
        tab = coeffs.shard_twiddles(ntt.psi_br, sp, s)
        assert tab.shape == (ntt.psi_br.shape[0], w)
        assert torch.equal(tab[:, 0], ntt.psi_br[:, 0])
        m = 1
        while m < w:
            for b in range(m):
                assert torch.equal(tab[:, m + b], ntt.psi_br[:, m * (sp + s) + b])
            m *= 2


@pytest.mark.parametrize("sp", [2, 4, 8])
def test_cross_stage_partners(sp):
    """Each stage pairs two ranks, one lower and one upper, that read the
    same twiddle column."""
    for inverse in (False, True):
        plan = [coeffs.cross_stages(sp, s, inverse) for s in range(sp)]
        for k in range(len(plan[0])):
            for s in range(sp):
                peer, upper, col = plan[s][k]
                assert plan[peer][k][0] == s and plan[peer][k][1] != upper
                assert plan[peer][k][2] == col


def test_build_mesh_with_sp():
    """sp is the innermost axis: ranks row-major, as JAX's reshape."""
    mesh = sh.build_mesh((2, 2), sp=2)
    assert mesh.axis_names == ("dp", "tp", "sp")
    assert mesh.devices.tolist() == np.arange(8).reshape(2, 2, 2).tolist()
    assert (mesh.size("dp"), mesh.size("tp"), mesh.size("sp")) == (2, 2, 2)
    hybrid = sh.build_mesh((2, 1, 2), sp=4)
    assert hybrid.axis_names == ("dcn", "dp", "tp", "sp")
    assert hybrid.devices.shape == (2, 1, 2, 4)
    assert sh.batch_parts(hybrid) == 2


@pytest.mark.parametrize("shape", [(2, 2), (1, 4), (2, 1, 2)])
def test_sp1_leaves_mesh_and_layout(shape):
    """sp 1 (and every mesh made today) has no sp axis, and its layouts
    and shards are today's."""
    mesh = sh.build_mesh(shape, sp=1)
    assert mesh.axis_names == sh.build_mesh(shape).axis_names
    assert mesh.devices.shape == tuple(shape) and mesh.size("sp") == 1
    assert sh.make_mesh(4).size("sp") == sh.make_hybrid_mesh(8).size("sp") == 1
    lay = sh.ct_sharding(mesh, 8, 3)
    assert lay == sh.Layout(sh.limb_split(8, mesh.size("tp")), 3, ("dp",))
    a = torch.arange(3 * 8 * 16).reshape(3, 8, 16)
    assert lay.take(a, mesh).shape[-1] == 16


def test_sp1_step_tensors_unchanged():
    """At sp 1 the step's plaintext and key shards are today's: the
    context's rows, every column, and the dryrun step passes in process."""
    from optimal_conv_tpu_torch.ckks.context import CkksContext
    p = CkksParams(**ranks.PARAMS)
    ctx = CkksContext(p, "cpu", seed=0)
    step = sh.ShardedLayerStep(ctx, 7, sh.build_mesh((1, 1), sp=1))
    pt = torch.arange(8 * N).reshape(8, N)
    assert step.shard_pt(pt).data_ptr() == pt.data_ptr()
    assert step.shard_pt(pt).shape == pt.shape
    swk = ctx.galois_key(5, 7)
    d0, d1 = step.shard_key(swk)
    assert torch.equal(d0, swk.d0) and torch.equal(d1, ctx.swk_d1(swk))
    assert sh.dryrun(1, device="cpu", sp=1) == {}


def test_cross_kernel_wrapper_needs_the_card():
    """The cross-stage wrapper launches its kernel or raises."""
    x = torch.zeros(2, 4, dtype=torch.int64)
    tab = torch.zeros(1, dtype=torch.int64)
    with pytest.raises(ValueError):
        ntt_kernel.ntt_cross_cuda(x, x, torch.zeros(2, dtype=torch.int32), tab,
                                  tab, tab, False, False)


@pytest.mark.slow_e2e
def test_jax_mesh_2x2x2(tmp_path_factory):
    """The JAX sp test's own (dp, tp, sp) = (2, 2, 2) mesh on 8 ranks."""
    refs, results = _jax_refs(tmp_path_factory, ranks.JAX_MESH, 8)
    for kind, (_, _, batch) in ranks.JAX_MESH.items():
        for level in ranks.LEVELS:
            for check in coeffs.CHECKS:
                _check_equal(refs, results, kind, level, check, batch)
