"""The port's fused conv → CtoS → ReLU → repack → StoC layer against the
JAX package (CPU, plain versions of the kernels), at logN 10 on
``mini_boot_params(10, n_relu=14)`` with the geometry of
``tests/test_pipeline.py``.

The same seed gives both packages the same secret key and the same
ciphertexts; switching keys are made by the JAX context while it runs
and carried across through ``interop`` after that.  Residues are compared
with ``np.array_equal``, levels and scales with ``==``.  The repack
generators, their mirrors and the three repack evaluators equal the JAX
package's; ``StrConv_sparse`` is held to its bar at decrypt level; every
kind's conv branch (the kernel reshaping, the monomial offsets) is
compared at the layer's first stage, where ``debug_hook`` stops both
packages.  One whole layer against JAX is ``tests/test_torch_block_layer.py``,
a file of its own so that it runs beside this one.
"""

import hashlib
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optimal_conv_tpu.ckks.context import CkksContext as JaxContext
from optimal_conv_tpu.ckks.params import mini_boot_params as jax_mini
from optimal_conv_tpu.ckks.types import Ciphertext as JaxCiphertext
from optimal_conv_tpu.ops import conv as jconv
from optimal_conv_tpu.ops import pipeline as jpipe
from optimal_conv_tpu.ops import repack as jrp
from optimal_conv_tpu.utils import serialization as jser

from optimal_conv_tpu_torch import interop
from optimal_conv_tpu_torch.ckks.bootstrap import SplitBootstrapper
from optimal_conv_tpu_torch.ckks.context import CkksContext
from optimal_conv_tpu_torch.ckks.params import mini_boot_params
from optimal_conv_tpu_torch.ops import conv as convops
from optimal_conv_tpu_torch.ops import pipeline as tpipe
from optimal_conv_tpu_torch.ops import repack as rp
from optimal_conv_tpu_torch.ops.relu import relu_np

CPU = torch.device("cpu")
SEED = 19
POW = 4.0
BOOT = dict(k_range=12.0, sin_deg=31, double_angle=3)
IN_WID, KER = 16, 3

# one intra-op thread a worker: the suite runs in several workers at once
torch.set_num_threads(1)


class Pair:
    def __init__(self):
        self.j = JaxContext(jax_mini(10, n_relu=14), seed=SEED)
        self.t = CkksContext(mini_boot_params(10, n_relu=14), CPU, seed=SEED)
        self.rng = np.random.default_rng(41)
        self.n = self.t.params.n

    def run_port(self, fn):
        """fn() on the port after the JAX side ran: on the JAX keys only."""
        keys = {key: (np.asarray(swk.d0), np.asarray(self.j.swk_d1(swk)))
                for key, swk in self.j._swk_cache.d.items()}
        assert interop.load_switching_keys(self.t, keys) > 0
        held = len(self.t.switching_keys)
        out = fn()
        assert len(self.t.switching_keys) == held, "the port made a key"
        return out

    def encrypt_coeffs(self, v, level=1):
        scale = self.t.params.scale
        return (self.j.encrypt(self.j.encoder.encode_coeffs(v, scale, level)),
                self.t.encrypt(self.t.encoder.encode_coeffs(v, scale, level)))

    def encrypt_slots(self, z, level):
        scale = self.t.params.scale
        return (self.j.encrypt(self.j.encoder.encode_slots(z, scale, level)),
                self.t.encrypt(self.t.encoder.encode_slots(z, scale, level)))


@pytest.fixture(scope="module")
def pair():
    return Pair()


def _same(t, j):
    assert t.level == j.level and t.scale == j.scale
    assert np.array_equal(interop.to_numpy(t.c0), np.asarray(j.c0))
    assert np.array_equal(interop.to_numpy(t.c1), np.asarray(j.c1))


# the JAX package's outputs in the port parity cases whose JAX side takes
# minutes, recorded by their slow_e2e replays (on the port's keys)
REPLAYS = os.path.join(os.path.dirname(__file__), "golden",
                       "torch_jax_replays.json")


def _sha(a) -> str:
    """sha256 of residues as int64, C order (a port tensor or a JAX array)."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    a = np.ascontiguousarray(np.asarray(a).view(np.int64))
    return hashlib.sha256(a.tobytes()).hexdigest()


def _digest(ct) -> tuple:
    """(sha256 of c0, sha256 of c1, level, scale) of a port or JAX
    ciphertext."""
    return _sha(ct.c0), _sha(ct.c1), ct.level, ct.scale


def _keys_digest(ctx) -> str:
    """sha256 of every switching key the port context holds: tag, d0, d1,
    in the order of the tags."""
    h = hashlib.sha256()
    for tag, swk in sorted(ctx.switching_keys.items(),
                           key=lambda kv: repr(kv[0])):
        h.update(repr(tag).encode())
        h.update(_sha(swk.d0).encode())
        h.update(_sha(ctx.swk_d1(swk)).encode())
    return h.hexdigest()


def _to_jax(ct) -> JaxCiphertext:
    """The JAX package's ciphertext of the same residues."""
    return JaxCiphertext(jnp.asarray(interop.to_numpy(ct.c0)),
                         jnp.asarray(interop.to_numpy(ct.c1)),
                         level=ct.level, scale=ct.scale)


def _on_port_keys(jctx, tctx, path: str, fn):
    """fn() on the JAX context after the port ran: on the port's switching
    keys only, carried by ``interop.save_keys`` → JAX's ``load_keys``."""
    interop.save_keys(path, tctx)
    assert jser.load_keys(path, jctx) == len(tctx.switching_keys) > 0
    held = len(jctx._swk_cache.d)
    out = fn()
    assert len(jctx._swk_cache.d) == held, "JAX made a key"
    return out


def _replay_entry(case: dict, ctx, **cts) -> dict:
    """What a replay records: the case's seeds and geometry, the digest of
    the port's switching keys in `ctx`, and each ciphertext's digest."""
    return {"case": case, "keys": _keys_digest(ctx),
            **{name: list(_digest(ct)) for name, ct in cts.items()}}


def _against_recording(**entries) -> None:
    """Each replay entry (name=entry) must be the recorded one.  Those that
    are not are printed: after a replay with OPTCONV_SLOW=1, what to
    record."""
    with open(REPLAYS) as f:
        recs = json.load(f)
    changed = {name: e for name, e in entries.items() if e != recs.get(name)}
    if changed:
        print(json.dumps(changed, indent=1))
    for name, entry in entries.items():
        rec = recs.get(name, {})
        assert entry["case"] == rec.get("case"), (
            f"{name}: the case changed: replay with OPTCONV_SLOW=1 and record")
        assert entry["keys"] == rec["keys"], (
            f"{name}: the port's keys changed: replay with OPTCONV_SLOW=1 and "
            "record")
        differ = sorted(k for k in set(rec) | set(entry)
                        if entry.get(k) != rec.get(k))
        assert not differ, f"{name}: {differ} differ from the recording"


def _same_maps(t, j):
    if isinstance(t, tuple):
        assert len(t) == len(j)
        for a, b in zip(t, j):
            _same_maps(a, b)
    elif isinstance(t, dict):
        assert list(t) == list(j)
        for k in t:
            assert np.array_equal(t[k], j[k])
    else:
        assert np.array_equal(t, j)


# the generator calls of the ResNet-20 / wide / fast runners at logN 16
# (models/resnet.py) and of the tests at logN 10
GEN_CALLS = [
    ("gen_keep_vec", (1 << 15, 128, 127, 0)),
    ("gen_keep_vec", (1 << 15, 128, 127, 1)),
    ("gen_keep_vec_sparse", (1 << 15, 32, 31, 2)),
    ("gen_keep_vec_sparse", (1 << 15, 16, 15, 3)),
    ("gen_keep_vec_sparse", (1 << 15, 8, 7, 4)),
    ("gen_keep_vec_stride", (1 << 15, 32, 15, 2, 0, True)),
    ("gen_keep_vec_stride", (512, 16, 7, 2, 1, True)),
    ("gen_comprs_sparse", (1 << 15, 32, 15, 1, 0, 0)),
    ("gen_comprs_sparse", (1 << 15, 16, 7, 2, 0, 0)),
    ("gen_comprs_sparse", (512, 16, 7, 0, 1, 0)),
    ("gen_comprs_full", (512, 16, 14, 0, 0)),
    ("gen_comprs_fast", (512, 16, 14, 0, 1)),
    ("gen_extend_full", (512, 16, 14, 0, 0)),
    ("gen_extend_fast", (512, 16, 14, 0, 1)),
    ("gen_extend_sparse", (512, 16, 7, 1, 0, 0)),
]


@pytest.mark.parametrize("name,args", GEN_CALLS,
                         ids=[f"{n}{a}" for n, a in GEN_CALLS])
def test_repack_generators_equal(name, args):
    _same_maps(getattr(rp, name)(*args), getattr(jrp, name)(*args))


def test_repack_mirrors_equal():
    rng = np.random.default_rng(3)
    v = rng.uniform(-1, 1, 512)
    for name, args in [("keep_vec", (16, 15, 0)),
                       ("keep_vec_sparse", (16, 15, 2)),
                       ("keep_vec_stride", (16, 7, 2, 1, True)),
                       ("comprs_vec_sparse", (16, 7, 1, 0, 0)),
                       ("comprs_full_fast", (16, 14, 0, 0)),
                       ("comprs_full", (16, 14, 0, 1))]:
        assert np.array_equal(getattr(rp, name)(v, *args),
                              getattr(jrp, name)(v, *args)), name
    maps = rp.gen_extend_full(512, 16, 14, 0, 0)
    assert np.array_equal(rp.apply_rot_maps(v, maps),
                          jrp.apply_rot_maps(v, maps))
    _same_maps(rp.invert_rot_maps(maps), jrp.invert_rot_maps(maps))


def test_repack_evaluators_bit_exact(pair):
    """keep_ctxt, ext_ctxt and ext_double_ctxt at the repack level, with
    the mask plaintexts cached on the mask's identity."""
    p = pair.t.params
    lvl = p.boot_layout["repack"]
    z = pair.rng.uniform(-1, 1, p.slots)
    jct, tct = pair.encrypt_slots(z, lvl)
    keep = rp.gen_keep_vec_sparse(p.slots, IN_WID, 15, 2)
    jout = jpipe.keep_ctxt(pair.j, jct, keep)
    tout = tpipe.keep_ctxt(pair.t, tct, keep)
    _same(tout, jout)
    np.testing.assert_allclose(pair.t.decrypt_decode_slots(tout).real,
                               z * keep, atol=1e-3)
    cached = len(pair.t._pt_cache)
    tpipe.keep_ctxt(pair.t, tct, keep)
    assert len(pair.t._pt_cache) == cached            # same array: a hit
    tpipe.keep_ctxt(pair.t, tct, keep.copy())
    assert len(pair.t._pt_cache) == cached + 1        # equal contents: a miss

    r_idx = rp.gen_extend_full(p.slots, IN_WID, 14, 0, 0)
    jout = jpipe.ext_ctxt(pair.j, jct, r_idx)
    tout = pair.run_port(lambda: tpipe.ext_ctxt(pair.t, tct, r_idx))
    _same(tout, jout)
    np.testing.assert_allclose(pair.t.decrypt_decode_slots(tout).real,
                               rp.apply_rot_maps(z, r_idx), atol=1e-3)

    m_idx, r_idx = rp.gen_comprs_fast(p.slots, IN_WID, 14, 0, 0)
    jout = jpipe.ext_double_ctxt(pair.j, jct, m_idx, r_idx)
    tout = pair.run_port(lambda: tpipe.ext_double_ctxt(pair.t, tct, m_idx,
                                                       r_idx))
    _same(tout, jout)
    np.testing.assert_allclose(pair.t.decrypt_decode_slots(tout).real,
                               rp.comprs_full_fast(z, IN_WID, 14, 0, 0),
                               atol=1e-3)


class _Stop(Exception):
    def __init__(self, ct):
        self.ct = ct


def _stop_after_conv(name, value):
    assert name == "conv"
    raise _Stop(value)


# kind → (ker_wid, real_ib, real_ob, norm, step, trans input)
MB = 4                                   # N / IN_WID² at logN 10
DISPATCH = {
    "Conv": (3, MB, MB, 1, 1, False),
    "StrConv": (3, MB, MB, 1, 1, False),
    "StrConv_fast": (3, MB, MB, 1, 1, False),
    "StrConv_odd": (3, MB, MB, 1, 2, False),          # X^offset premultiply
    "Conv_inside": (3, MB, MB, 1, 2, False),          # kernel dilated ×2
    "StrConv_inside": (3, MB, MB, 1, 2, False),       # in_step = step / 2
    "TransConv": (3, MB, MB // 4, 1, 1, True),
    "StrConv_sparse": (3, 2, 4, 2, 1, False),         # even/odd double conv
    "StrConv_sparse_full": (5, MB, MB, 1, 1, False),  # even raw: X^-shift
}


@pytest.mark.parametrize("kind", list(DISPATCH))
def test_kind_dispatch_conv_branch_bit_exact(pair, kind):
    ker_wid, ib, ob, norm, step, trans = DISPATCH[kind]
    raw = 6 if trans else IN_WID - ker_wid // 2
    img = pair.rng.uniform(-0.8, 0.8, raw * raw * ib)
    ker = pair.rng.uniform(-1, 1, ker_wid * ker_wid * ib * ob) / 4.0
    bn_a = pair.rng.uniform(0.8, 1.2, ob)
    bn_b = pair.rng.uniform(-0.2, 0.2, ob)
    in_norm = norm if kind != "StrConv_sparse" else 2
    inp = convops.prep_input(img, raw, IN_WID, pair.n, in_norm, trans=trans)
    assert np.array_equal(inp, jconv.prep_input(img, raw, IN_WID, pair.n,
                                                in_norm, trans=trans))
    jct, tct = pair.encrypt_coeffs(inp)
    args = (ker, bn_a, bn_b, 0.0, POW, IN_WID, raw, ker_wid, ib, ob, norm, 0,
            step, 2, 0, kind, None)
    with pytest.raises(_Stop) as jstop:
        jpipe.eval_conv_bn_relu(pair.j, {}, jct, *args,
                                debug_hook=_stop_after_conv)
    with pytest.raises(_Stop) as tstop:
        pair.run_port(lambda: tpipe.eval_conv_bn_relu(
            pair.t, {}, tct, *args, debug_hook=_stop_after_conv))
    _same(tstop.value.ct, jstop.value.ct)
    assert tstop.value.ct.level == 0
    assert tstop.value.ct.scale == 2.0 ** (55 - 8)    # boosted by 2^pow


def test_unknown_kind_and_odd_step_raise(pair):
    ct = pair.encrypt_coeffs(np.zeros(pair.n))[1]
    args = (np.zeros(9 * MB * MB), np.ones(MB), np.zeros(MB), 0.0, POW, IN_WID,
            15, 3, MB, MB, 1, 0)
    with pytest.raises(ValueError, match="unknown kind"):
        tpipe.eval_conv_bn_relu(pair.t, {}, ct, *args, 1, 2, 0, "Conv_dense",
                                None)
    with pytest.raises(ValueError, match="step must be even"):
        tpipe.eval_conv_bn_relu(pair.t, {}, ct, *args, 3, 2, 0,
                                "StrConv_inside", None)


def test_strconv_bn_relu_sparse_at_decrypt_level(pair):
    """The strided transition on the port alone (its own keys): the
    split-kernel double conv, the combined stride-2 ciphertext
    bootstrapped at log_sparse 1, the two-stage compression repack."""
    raw_in = IN_WID - KER // 2
    out_wid = IN_WID // 2
    raw_out = out_wid - KER // 2
    norm_in, ls_comb = 4, 1
    ib = MB // norm_in
    max_out = pair.n // (out_wid * out_wid)
    norm_out = 8
    ob = max_out // norm_out
    img = pair.rng.uniform(-0.8, 0.8, (raw_in, raw_in, ib))
    ker = pair.rng.uniform(-1, 1, (KER, KER, ib, ob)) / 4.0
    bn_a = pair.rng.uniform(0.8, 1.2, ob)
    bn_b = pair.rng.uniform(-0.2, 0.2, ob)
    tct = pair.encrypt_coeffs(
        convops.prep_input(img.ravel(), raw_in, IN_WID, pair.n, norm_in))[1]
    m_idx, r_idx = rp.gen_comprs_sparse(pair.n // 2, IN_WID, raw_out, ls_comb,
                                        0, 0)
    btps = {ls_comb: SplitBootstrapper(pair.t, log_sparse=ls_comb, **BOOT)}
    out = tpipe.eval_conv_bn_relu(
        pair.t, btps, tct, ker.ravel(), bn_a, bn_b, 0.0, POW, IN_WID, raw_out,
        KER, ib, ob, norm_out, 0, 1, 2, ls_comb, "StrConv_sparse",
        tpipe.LayerMaps(m_idx=m_idx, r_idx=r_idx))
    assert out.level >= 1
    got = convops.post_process(pair.t.decrypt_decode_coeffs(out), raw_out,
                               out_wid)
    got = got.reshape(raw_out, raw_out, max_out)[:, :, ::norm_out][:, :, :ob]
    full = convops.conv2d_same_np(img, ker) * bn_a + bn_b
    want = relu_np(full[0::2, 0::2][:raw_out, :raw_out])
    err = np.max(np.abs(got - want))
    assert err < 5e-2, f"stride phase y[2i,2j] err {err}"
