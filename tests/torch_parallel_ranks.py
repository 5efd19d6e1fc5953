"""The ranks of ``tests/test_torch_parallel.py``: spawned processes that
import the port and numpy, never JAX.

Each rank reads the JAX package's ciphertext, plaintext and Galois key
from an ``.npz``, and runs the sharded layer step on four meshes of one
world of 4 gloo ranks in turn.  Rank 0 alone holds the JAX key (loaded
through ``interop``); ``share_galois_key`` broadcasts it to the others.
"""

import numpy as np
import torch

from optimal_conv_tpu_torch import interop
from optimal_conv_tpu_torch.ckks.context import CkksContext
from optimal_conv_tpu_torch.ckks.params import CkksParams
from optimal_conv_tpu_torch.ckks.types import Ciphertext
from optimal_conv_tpu_torch.core.ntt import rot_to_galois
from optimal_conv_tpu_torch.parallel import sharding as sh

# the JAX module's own test chain (tests/test_parallel.py)
PARAMS = dict(log_n=8, logq=(45,) + (35,) * 7, logp=(45,) * 4, log_scale=25,
              h=32)
WORLD = 4
ROT = 1
# (case, mesh, level, batch): at level 2 the 3 limbs leave tp rank 3
# without one, and the rescaled 2 limbs ranks 2 and 3
CASES = (("tp 4", "tp4", 7, 1),
         ("dp 2 x tp 2", "dp2tp2", 7, 3),
         ("dcn 2 x dp 1 x tp 2", "dcn2tp2", 7, 2),
         ("tp 4, level 2", "tp4", 2, 1))
LEVELS = (7, 2)


def mesh_of(kind: str) -> sh.Mesh:
    if kind == "tp4":
        return sh.make_mesh(WORLD)
    if kind == "dp2tp2":
        return sh.build_mesh((2, 2))
    return sh.make_hybrid_mesh(WORLD, n_hosts=2)


def run(rank: int, path: str) -> dict:
    torch.set_num_threads(1)
    z = np.load(path)
    params = CkksParams(**PARAMS)
    ctx = CkksContext(params, "cpu", seed=0)
    g = rot_to_galois(ROT, params.log_n)
    if rank == 0:
        interop.load_switching_keys(ctx, {
            ("gal", g, lv): (z[f"d0_{lv}"], z[f"d1_{lv}"]) for lv in LEVELS})
    keys = {lv: sh.share_galois_key(ctx, g, lv) for lv in LEVELS}
    perm = ctx.galois_perm(g)
    out = {}
    for case, kind, level, batch in CASES:
        mesh = mesh_of(kind)
        step = sh.build_sharded_layer_step(ctx, level, mesh)
        c0, c1, pt = (interop.to_tensor(z[f"{k}_{level}"], "cpu")
                      for k in ("c0", "c1", "pt"))
        shape = (batch,) + tuple(c0.shape)
        ct = Ciphertext(c0.expand(shape), c1.expand(shape), level=level)
        if kind == "dcn2tp2":     # images over (dcn, dp)
            lay = sh.batch_sharding(mesh, level + 1, batch)
            x0, x1 = lay.take(ct.c0, mesh), lay.take(ct.c1, mesh)
        else:                     # images over dp (shard_ct's placement)
            lay = sh.ct_sharding(mesh, level + 1, batch)
            local = sh.shard_ct(ct, mesh)
            x0, x1 = local.c0, local.c1
        o0, o1 = step(x0, x1, step.shard_pt(pt), perm, *step.shard_key(keys[level]))
        whole = sh.gather_ct(Ciphertext(o0, o1, level=level - 1), mesh,
                             step.out_layout(lay))
        out[case] = dict(shard_in=tuple(x0.shape), shard_out=tuple(o0.shape),
                         bytes=step.bytes, c0=interop.to_numpy(whole.c0),
                         c1=interop.to_numpy(whole.c1))
    return out
