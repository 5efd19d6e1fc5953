"""The port's sharding module against the JAX package's
(``optimal_conv_tpu/parallel/sharding.py``): the mesh factoring, and the
limb-sharded layer step over real gloo process groups, bit for bit
against the JAX single-device ``rescale(rotate(mul_plain(ct, pt), 1))``.

The step runs in one spawn of 4 ranks (``tests/torch_parallel_ranks.py``,
which imports no JAX) on four meshes of that world in turn; the JAX side
hands its ciphertext, plaintext and key over as an ``.npz``.
"""

import numpy as np
import pytest
import torch

from optimal_conv_tpu.ckks.context import CkksContext as JaxContext
from optimal_conv_tpu.ckks.params import CkksParams as JaxParams
from optimal_conv_tpu.core import ntt as jax_ntt
from optimal_conv_tpu.parallel import sharding as jax_sh
from optimal_conv_tpu_torch.parallel import sharding as sh
from tests import torch_parallel_ranks as ranks

torch.set_num_threads(1)


@pytest.mark.parametrize("n", range(1, 9))
def test_mesh_factoring_matches_jax(n):
    mesh, want = sh.make_mesh(n), jax_sh.make_mesh(n)
    assert mesh.devices.shape == want.devices.shape
    assert mesh.axis_names == want.axis_names == ("dp", "tp")


def test_hybrid_mesh_matches_jax():
    mesh, want = sh.make_hybrid_mesh(8, n_hosts=2), jax_sh.make_hybrid_mesh(
        8, n_hosts=2)
    assert mesh.devices.shape == want.devices.shape == (2, 1, 4)
    assert mesh.axis_names == want.axis_names == ("dcn", "dp", "tp")
    assert sh.make_hybrid_mesh(8).devices.shape == \
        jax_sh.make_hybrid_mesh(8).devices.shape


@pytest.mark.parametrize("n,parts", [(28, 4), (33, 4), (5, 4), (3, 4), (1, 2)])
def test_limb_split(n, parts):
    split = sh.limb_split(n, parts)
    assert len(split) == parts
    assert [i for r in split for i in r] == list(range(n))
    sizes = [len(r) for r in split]
    assert max(sizes) - min(sizes) <= 1 and sizes == sorted(sizes, reverse=True)


def test_init_distributed_single_process():
    assert sh.init_distributed() == 1


def test_dryrun_in_process():
    assert sh.dryrun(1, device="cpu") == {}


def test_dryrun_runs_on_the_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        sh.dryrun(1)
    with pytest.raises(ValueError):
        sh.dryrun(2, device="cpu")      # no world of 2 ranks here


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    """The JAX references at levels 7 and 2, and the 4 ranks' results."""
    params = JaxParams(**ranks.PARAMS)
    ctx = JaxContext(params, seed=0)
    rng = np.random.default_rng(0)
    v = rng.uniform(-1, 1, params.n)
    ct = ctx.encrypt(ctx.encoder.encode_coeffs(v, params.scale,
                                               params.max_level))
    g = jax_ntt.rot_to_galois(ranks.ROT, params.log_n)
    arrays, refs = {}, {}
    for level in ranks.LEVELS:
        c = ctx.drop_level(ct, ct.level - level)
        pt = ctx.encoder.encode_coeffs(rng.uniform(-1, 1, 8), params.scale,
                                       level)
        swk = ctx.galois_key(g, level)
        ref = ctx.rescale(ctx.rotate(ctx.mul_plain(c, pt), ranks.ROT))
        refs[level] = (np.asarray(ref.c0), np.asarray(ref.c1))
        arrays.update({f"c0_{level}": np.asarray(c.c0),
                       f"c1_{level}": np.asarray(c.c1),
                       f"pt_{level}": np.asarray(pt.poly),
                       f"d0_{level}": np.asarray(swk.d0),
                       f"d1_{level}": np.asarray(ctx.swk_d1(swk))})
    path = tmp_path_factory.mktemp("sharding") / "inputs.npz"
    np.savez(path, **arrays)
    results = sh.run_ranks(ranks.run, ranks.WORLD, (str(path),),
                           backend="gloo")
    return refs, results


@pytest.mark.parametrize("case,kind,level,batch", ranks.CASES)
def test_sharded_step_matches_jax(sharded, case, kind, level, batch):
    refs, results = sharded
    ref0, ref1 = refs[level]
    for r, res in enumerate(results):
        got = res[case]
        assert got["c0"].shape == (batch, level, ref0.shape[-1]), r
        for i in range(batch):
            np.testing.assert_array_equal(got["c0"][i], ref0)
            np.testing.assert_array_equal(got["c1"][i], ref1)
    shards_in = [res[case]["shard_in"][-2] for res in results]
    shards_out = [res[case]["shard_out"][-2] for res in results]
    if level == 2:
        # 3 limbs over tp 4: rank 3 holds none going in, ranks 2-3 coming out
        assert shards_in == [1, 1, 1, 0] and shards_out == [1, 1, 0, 0]
    moved = results[0][case]["bytes"]
    n = ref0.shape[-1]
    b_rank = -(-batch // (len(results) // (4 if kind == "tp4" else 2)))
    assert moved["c1 all_gather"][0] == b_rank * (level + 1) * n * 8
    assert moved["P all_gather"][0] == 2 * b_rank * 4 * n * 8
    assert moved["top broadcast"][0] == 2 * b_rank * n * 8
