"""The ranks of ``tests/test_torch_parallel_layer.py``: spawned processes
that import the port and numpy, never JAX.

Each rank holds a ``LimbShardedContext`` in one world of gloo ranks and
returns its results as numpy arrays, every ciphertext gathered whole
(``gather_ct``), so that the test process holds them against the port's
single-device context of the same seed (and, in the slow tier, against
the JAX package's layer on its keys).  ``pieces`` runs on either kind
of context.
"""

import json

import numpy as np
import torch

from optimal_conv_tpu_torch import interop
from optimal_conv_tpu_torch.ckks import bootstrap as boot
from optimal_conv_tpu_torch.ckks.context import SwitchingKey
from optimal_conv_tpu_torch.ckks.params import CkksParams, mini_boot_params
from optimal_conv_tpu_torch.ckks.types import Ciphertext
from optimal_conv_tpu_torch.ops import conv as convops
from optimal_conv_tpu_torch.ops import pipeline as pipe
from optimal_conv_tpu_torch.ops import repack as rp
from optimal_conv_tpu_torch.parallel import sharding as sh
from optimal_conv_tpu_torch.parallel.limbs import LimbShardedContext

# two P limbs over tp 4: at level 0 tp rank 0 holds q0, ranks 3 and 2 one
# P limb each, rank 1 nothing
PIECES = CkksParams(log_n=8, logq=(50,) + (40,) * 5, logp=(55, 55),
                    log_scale=30, h=32)
PIECES_SEED = 3
BABIES = (0, 1, 2, 3, 5, 8)


def _whole(ctx, ct) -> Ciphertext:
    return ctx.gather_ct(ct) if isinstance(ctx, LimbShardedContext) else ct


def arrays(ctx, ct) -> dict:
    """A ciphertext, whole, as numpy arrays with its level and scale."""
    out = _whole(ctx, ct)
    return dict(c0=interop.to_numpy(out.c0), c1=interop.to_numpy(out.c1),
                level=out.level, scale=out.scale)


def _qp_arrays(ctx, t: torch.Tensor, level: int) -> np.ndarray:
    """A [..., own Q + own P rows, N] accumulator, whole."""
    if isinstance(ctx, LimbShardedContext):
        pl, nq = ctx.placement, len(ctx.q_rows(level))
        t = torch.cat([
            ctx._gather(t[..., :nq, :], [pl.q_rows(level, r)
                                         for r in range(ctx.tp)], "test"),
            ctx._gather(t[..., nq:, :], [pl.p_rows(r) for r in range(ctx.tp)],
                        "test")], -2)
    return interop.to_numpy(t)


def pieces(ctx) -> dict:
    """A layer's pieces on the PIECES chain, on `ctx` (single device or
    limb-sharded, seed PIECES_SEED): encryption; ``rotate_hoisted_lazy``
    at levels 0 and 2 (the raw triples); a single-hoisted BSGS transform
    at level 2 with its rescale and a double-hoisted one at level 0
    without; ``mod_raise``; ``eval_conv_bn`` (ct × pt, the rescale 1 → 0,
    the level-0 pack's key switches)."""
    p = ctx.params
    rng = np.random.default_rng(11)
    out = {}
    z = rng.uniform(-1, 1, p.slots) + 1j * rng.uniform(-1, 1, p.slots)
    ct = {lv: ctx.encrypt(ctx.encoder.encode_slots(z, p.scale, lv))
          for lv in (0, 2)}
    out["encrypt"] = arrays(ctx, ct[2])
    for lv in (0, 2):
        for k, (c0, a0, a1) in ctx.rotate_hoisted_lazy(ct[lv], BABIES).items():
            out[f"lazy {lv} {k}"] = [
                arrays(ctx, Ciphertext(c0, c0, level=lv))["c0"],
                _qp_arrays(ctx, a0, lv), _qp_arrays(ctx, a1, lv)]
    diags = {k: rng.uniform(-1, 1, p.slots) for k in BABIES + (13, 21)}
    out["bsgs 2"] = arrays(ctx, boot.LinearTransform(
        ctx, diags, 2, double_hoist=False)(ct[2]))
    out["bsgs 0 dh"] = arrays(ctx, boot.LinearTransform(
        ctx, diags, 0, pt_scale=2.0 ** 20, rescale=False,
        double_hoist=True)(ct[0]))
    c0 = ctx.encrypt(ctx.encoder.encode_coeffs(rng.uniform(-1, 1, p.n),
                                               2.0 ** 40, 0))
    out["mod_raise"] = arrays(ctx, boot.mod_raise(ctx, c0))
    in_wid, ch, norm = 8, 2, 2
    img = rng.uniform(-1, 1, (in_wid - 1, in_wid - 1, ch))
    ker = rng.uniform(-1, 1, (3, 3, ch, ch))
    cin = ctx.encrypt(ctx.encoder.encode_coeffs(convops.prep_input(
        img.ravel(), in_wid - 1, in_wid, p.n, norm), p.scale, 1))
    out["conv"] = arrays(ctx, convops.eval_conv_bn(
        ctx, cin, ker.ravel(), np.ones(ch), rng.uniform(-0.1, 0.1, ch), in_wid,
        3, ch, ch, norm, 2.0 ** 30))
    return out


def _mesh(kind: str):
    return sh.build_mesh((2, 2)) if kind == "dp 2 x tp 2" else sh.make_mesh()


def _pieces_rank() -> dict:
    """The pieces at tp = the world, this rank's (Q, P) limbs at level 0,
    and its rows of three keys it made (``gal`` and ``galh`` of levels 0
    and 2) with no collective."""
    ctx = LimbShardedContext(PIECES, "cpu", _mesh("tp"), seed=PIECES_SEED)
    out = dict(pieces=pieces(ctx), limbs_0=ctx.placement.counts(0), keys={})
    tags = [t for t in ctx.switching_keys if t[0] in ("gal", "galh")]
    for tag in sorted(tags, key=repr)[:3]:
        swk = ctx.switching_keys[tag]
        out["keys"][tag] = (ctx.qp_rows(tag[2]), interop.to_numpy(swk.d0),
                            interop.to_numpy(ctx.swk_d1(swk)))
    return out


def run_dryrun(rank: int, legs) -> dict:
    """The default tier's world of 4: the pieces at tp 4, then
    ``dryrun_fused_layer(4, 9)``'s `legs` (its digests, its collectives
    and this rank's limbs by stage; checked by the test process)."""
    torch.set_num_threads(1)
    out = _pieces_rank()
    out["dryrun"] = sh.dryrun_fused_layer(sh._world_size(), 9, "cpu", legs,
                                          check=False)
    return out


def run_dryrun_checked(rank: int) -> dict:
    """``dryrun_fused_layer`` with its own check against the single
    device, every leg."""
    torch.set_num_threads(1)
    return sh.dryrun_fused_layer(sh._world_size(), 9, "cpu")


def run(rank: int, kinds, legs, log_n: int) -> dict:
    """The fused layer's `legs` at `log_n` (``sharding.fused_layer_legs``,
    seed 7) on each mesh of `kinds`: "tp" (the world on tp) and "dp 2 x
    tp 2"; each output gathered whole, and the collectives by kind."""
    torch.set_num_threads(1)
    out = {}
    for kind in kinds:
        ctx = LimbShardedContext(mini_boot_params(log_n, n_relu=14,
                                                  stoc_groups=3), "cpu",
                                 _mesh(kind), seed=sh.FUSED_SEED)
        outs = sh.fused_layer_legs(ctx, legs)
        out[kind] = dict(legs={leg: arrays(ctx, o) for leg, o in outs.items()},
                         comm={k: list(v) for k, v in ctx.comm.items()})
    return out


def run_jax_keys(rank: int, path: str, kind: str) -> dict:
    """The JAX ``test_sharded_fused_layer_bit_exact`` layer on a sharded
    context that holds the JAX keys: each rank installs its rows of every
    key the JAX layer made, takes its rows of the JAX ciphertext and runs
    the port's layer (double-hoisted, as JAX's), which makes no key."""
    torch.set_num_threads(1)
    z = np.load(path)
    g = json.loads(str(z["geometry"]))
    p = mini_boot_params(10, n_relu=14)
    ctx = LimbShardedContext(p, "cpu", _mesh(kind), seed=g["seed"])
    for i, tag in enumerate(json.loads(str(z["tags"]))):
        level = tag[-1]
        sel = [p.qp_idx(level).index(j) for j in ctx.qp_rows(level)]
        ctx.switching_keys[tuple(tag)] = SwitchingKey(
            interop.to_tensor(z[f"d0_{i}"][:, sel], "cpu"),
            interop.to_tensor(z[f"d1_{i}"][:, sel], "cpu"), level)
    held = len(ctx.switching_keys)
    ct = ctx.shard_ct(Ciphertext(interop.to_tensor(z["c0"], "cpu"),
                                 interop.to_tensor(z["c1"], "cpu"), level=1,
                                 scale=g["scale"]))
    ls = g["ls"]
    btps = {ls: boot.SplitBootstrapper(ctx, log_sparse=ls, double_hoist=True,
                                       **g["boot"])}
    maps = pipe.LayerMaps(ext_idx=[rp.gen_keep_vec_sparse(
        p.n // 2, g["in_wid"], g["raw"], ls), None])
    out = pipe.eval_conv_bn_relu(
        ctx, btps, ct, z["ker"], z["bn_a"], z["bn_b"], 0.0, g["pow"],
        g["in_wid"], g["raw"], g["ker_wid"], g["real_b"], g["real_b"],
        g["norm"], 0, 1, 2, ls, "Conv_sparse", maps)
    return dict(out=arrays(ctx, out), made=len(ctx.switching_keys) - held)
