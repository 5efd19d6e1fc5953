"""The ranks of ``tests/test_torch_coeff_sharding.py``: spawned processes
that import the port and numpy, never JAX.

Each rank reads the JAX package's ciphertext, plaintexts and Galois keys
from an ``.npz`` and runs the sp checks (``parallel/coeffs.coeff_case``)
on several meshes of one world of gloo ranks, each on a
``CoeffShardedContext`` of its own.  Rank 0 alone loads the JAX keys
(through ``interop``); ``share_galois_key`` broadcasts them whole, and
each rank takes its rows and columns.
"""

import numpy as np
import torch

from optimal_conv_tpu_torch import interop
from optimal_conv_tpu_torch.ckks.params import CkksParams
from optimal_conv_tpu_torch.ckks.types import Ciphertext, Plaintext
from optimal_conv_tpu_torch.core.ntt import rot_to_galois
from optimal_conv_tpu_torch.parallel import coeffs
from optimal_conv_tpu_torch.parallel import sharding as sh
from tests.torch_parallel_ranks import PARAMS

WORLD = 4
ROT = 1
# conjugation: g = 2N - 1 moves shards at every sp, a rotation (g = 5^k,
# 1 mod 4) none at sp 2
GALOIS_MOVED = 2 * (1 << PARAMS["log_n"]) - 1
LEVELS = (7, 2)
# mesh kind → ((dp, tp) shape, sp, batch): the (tp, sp) and (dp, sp)
# meshes of a world of 4, and the coefficient axis alone at sp 4
MESHES = {"tp 2 x sp 2": ((1, 2), 2, 1),
          "dp 2 x sp 2": ((2, 1), 2, 2),
          "sp 4": ((1, 1), 4, 1)}
# the JAX package's own sp test mesh, (dp, tp, sp) = (2, 2, 2)
JAX_MESH = {"dp 2 x tp 2 x sp 2": ((2, 2), 2, 2)}


def run(rank: int, path: str, meshes: dict, dryrun: bool) -> dict:
    """{(mesh, level): {check: gathered numpy pair}, with this rank's
    transfers of one forward NTT and of one conjugation of c0's shard,
    its shard's shape and the step's tp bytes; on a mesh without tp,
    "context step": the context's own rescale(rotate(mul_plain)) on the
    shards}, and with `dryrun`, ``dryrun_coeffs`` at sp 2 ("dryrun")."""
    torch.set_num_threads(1)
    z = np.load(path)
    params = CkksParams(**PARAMS)
    g = rot_to_galois(ROT, params.log_n)
    out = {}
    for kind, (shape, sp, batch) in meshes.items():
        mesh = sh.build_mesh(shape, sp=sp)
        ctx = coeffs.CoeffShardedContext(params, "cpu", mesh, seed=0)
        if rank == 0:
            interop.load_switching_keys(ctx, {
                ("gal", g, lv): (z[f"d0_{lv}"], z[f"d1_{lv}"]) for lv in LEVELS})
        keys = {lv: sh.share_galois_key(ctx, g, lv) for lv in LEVELS}
        for level in LEVELS:
            c0, c1, pt = (interop.to_tensor(z[f"{k}_{level}"], "cpu")
                          for k in ("c0", "c1", "pt"))
            ct = Ciphertext(c0, c1, level=level)
            got = coeffs.coeff_case(ctx, mesh, level, ct,
                                    Plaintext(pt, level=level), keys[level],
                                    ROT, batch)
            res = {k: got[k].numpy() for k in coeffs.CHECKS}
            # one forward NTT and one conjugation of this rank's shard
            lay = sh.batch_sharding(mesh, level + 1, batch)
            x = lay.take(c0.expand((batch,) + tuple(c0.shape)), mesh)
            step = sh.ShardedLayerStep(ctx, level, mesh)
            ctx.ntt.comm.clear()
            ctx.ntt.ntt(x, step.own_q)
            res["ntt comm"] = {k: list(v) for k, v in ctx.ntt.comm.items()}
            ctx.ntt.comm.clear()
            ctx._permute(x, ctx.galois_perm(GALOIS_MOVED))
            res["galois comm"] = {k: list(v) for k, v in ctx.ntt.comm.items()}
            res["shard"] = tuple(x.shape)
            res["sp coord"] = mesh.coord("sp")
            res["bytes"] = got["bytes"]
            if shape[1] == 1:
                cols = coeffs.shard_cols(params.n, sp, mesh.coord("sp"))
                x1 = lay.take(c1.expand((batch,) + tuple(c1.shape)), mesh)
                o = ctx.rescale(ctx.rotate(ctx.mul_plain(
                    Ciphertext(x, x1, level=level, scale=1.0),
                    Plaintext(pt[..., cols], level=level, scale=1.0)), ROT))
                whole = sh.gather_ct(o, mesh, sh.batch_sharding(mesh, level,
                                                                batch))
                res["context step"] = np.stack([whole.c0.numpy(),
                                                whole.c1.numpy()])
            out[(kind, level)] = res
    if dryrun:
        out["dryrun"] = coeffs.dryrun_coeffs(WORLD, 2, device="cpu")
    return out
