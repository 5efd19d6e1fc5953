"""One whole fused layer of the port against the JAX package (CPU, plain
versions of the kernels): conv + BN, CtoS with EvalMod, the minimax ReLU,
the keep-mask repack and StoC, kind ``Conv_sparse`` at log_sparse 2, at
logN 10 on ``mini_boot_params(10, n_relu=14)`` with the geometry of
``tests/test_pipeline.py``.  The port runs on its own switching keys,
each drawn from its own seed.  Its output ciphertext is bit-exact against
the JAX package's on those keys, with equal level and scale: the JAX side
takes minutes, so its output is recorded as digests in
``tests/golden/torch_jax_replays.json`` ("layer"), which the slow_e2e
replay here checks by running the JAX package's layer on the port's keys.
The port's output also meets the JAX test's bars against numpy conv +
exact ReLU.  The helpers are ``tests/test_torch_pipeline.py``'s.  The same
port layer runs again with spans recorded: bit-equal, its stage spans
those ``on_stage`` sees.  A second port layer on the same bootstrapper
runs under the port's ``DebugOracle``.
"""

import numpy as np
import pytest

from optimal_conv_tpu.ckks.bootstrap import SplitBootstrapper as JaxBoot
from optimal_conv_tpu.ops import pipeline as jpipe

from optimal_conv_tpu_torch.ckks.bootstrap import SplitBootstrapper
from optimal_conv_tpu_torch.ops import conv as convops
from optimal_conv_tpu_torch.ops import pipeline as tpipe
from optimal_conv_tpu_torch.ops.debug import DebugOracle
from optimal_conv_tpu_torch.ops import repack as rp
from optimal_conv_tpu_torch.ops.relu import relu_np
from optimal_conv_tpu_torch.utils import tracing

from .test_torch_pipeline import (BOOT, IN_WID, KER, MB, POW, SEED, Pair,
                                  _against_recording, _digest,
                                  _on_port_keys, _replay_entry, _to_jax)


LS = 2
# what the recording holds of the case; rng is Pair's, which the case
# fixture draws from first
CASE = dict(seed=SEED, rng=41, log_n=10, n_relu=14, boot=BOOT,
            double_hoist=True, kind="Conv_sparse", log_sparse=LS,
            in_wid=IN_WID, ker=KER, norm=4, pow=POW, level=1)


@pytest.fixture(scope="module")
def pair():
    return Pair()


@pytest.fixture(scope="module")
def tbt(pair):
    """The port's bootstrapper at log_sparse 2, double-hoisted as JAX's."""
    return {LS: SplitBootstrapper(pair.t, log_sparse=LS, double_hoist=True,
                                  **BOOT)}


@pytest.fixture(scope="module")
def case(pair):
    """One ResNet block-1 style layer, Conv_sparse at log_sparse 2: its
    input ciphertext (the port context's first encryption) and
    arguments."""
    raw = IN_WID - KER // 2
    norm, ls = CASE["norm"], LS
    ib = ob = MB // norm
    img = pair.rng.uniform(-0.8, 0.8, (raw, raw, ib))
    ker = pair.rng.uniform(-1, 1, (KER, KER, ib, ob)) / 4.0
    bn_a = pair.rng.uniform(0.8, 1.2, ob)
    bn_b = pair.rng.uniform(-0.2, 0.2, ob)
    tct = pair.t.encrypt(pair.t.encoder.encode_coeffs(
        convops.prep_input(img.ravel(), raw, IN_WID, pair.n, norm),
        pair.t.params.scale, CASE["level"]))
    mask = rp.gen_keep_vec_sparse(pair.n // 2, IN_WID, raw, ls)
    args = (ker.ravel(), bn_a, bn_b, 0.0, POW, IN_WID, raw, KER, ib, ob, norm,
            0, 1, 2, ls, "Conv_sparse")
    return dict(raw=raw, norm=norm, ob=ob, img=img, ker=ker, bn_a=bn_a,
                bn_b=bn_b, tct=tct, mask=mask, args=args)


def _port_layer(pair, tbt, c, **hooks):
    return tpipe.eval_conv_bn_relu(
        pair.t, tbt, c["tct"], *c["args"],
        tpipe.LayerMaps(ext_idx=[c["mask"], None]), **hooks)


def test_conv_bn_relu_sparse_bit_exact_and_bars(pair, tbt, case):
    """One ResNet block-1 style layer: Conv_sparse at log_sparse 2."""
    c = case
    seen = []
    tout = _port_layer(pair, tbt, c,
                       debug_hook=lambda name, _: seen.append(name))
    assert seen == ["conv", "ctos", "relu", "repack", "stoc"]
    _against_recording(layer=_replay_entry(CASE, pair.t, jout=tout))
    assert tout.level == 1

    raw, norm, ob = c["raw"], c["norm"], c["ob"]
    got = convops.post_process(pair.t.decrypt_decode_coeffs(tout), raw, IN_WID)
    got = got.reshape(raw, raw, MB)[:, :, ::norm][:, :, :ob]
    want = relu_np(convops.conv2d_same_np(c["img"], c["ker"]) * c["bn_a"]
                   + c["bn_b"])
    err = np.abs(got - want)
    assert err.max() < 5e-2, f"max err {err.max()}"
    assert np.mean(err < 2.5e-2) > 0.97


def test_layer_stage_spans_under_collect(pair, tbt, case):
    """The same layer with spans recorded (``utils/tracing.collect()``):
    its output is bit-equal to JAX's recorded one, as with recording off;
    its stage spans are, in order, the stages an ``on_stage`` callback
    sees, and cover at least 99% of the ``layer`` span."""
    seen = []
    tracing.clear()
    with tracing.collect():
        tout = _port_layer(pair, tbt, case,
                           on_stage=lambda name, _: seen.append(name))
    _against_recording(layer=_replay_entry(CASE, pair.t, jout=tout))
    recs = tracing.records()
    tracing.clear()
    layer = recs[-1]
    assert layer["name"] == "layer" and layer["parent"] == 0
    assert layer["attrs"] == {"kind": "Conv_sparse", "log_sparse": LS,
                              "step": 1, "halves": 1}
    top = [r for r in recs if r["parent"] == layer["id"]]
    split = {r["id"] for r in top if r["name"] in ("ctos", "stoc")}
    stages = [r["name"] for r in recs
              if r["parent"] == layer["id"] or r["parent"] in split]
    assert stages == seen
    assert [r["name"] for r in top] == ["conv", "ctos", "relu", "repack",
                                        "stoc"]
    covered = sum(r["t1"] - r["t0"] for r in top)
    assert covered >= 0.99 * (layer["t1"] - layer["t0"])
    assert sum(r["eval"][0] for r in recs) > 0


def test_debug_oracle_on_a_port_layer(pair, tbt):
    """One Conv_sparse layer at log_sparse 2 with the port's DebugOracle as
    its debug hook: every stage is decrypted and has a golden, each above
    the 4 bits of tests/test_debug_oracle.py."""
    raw = IN_WID - KER // 2
    norm = 4
    ib = ob = MB // norm
    n = pair.n
    img = pair.rng.uniform(-0.8, 0.8, (raw, raw, ib))
    ker = pair.rng.uniform(-1, 1, (KER, KER, ib, ob)) / 4.0
    bn_a = pair.rng.uniform(0.8, 1.2, ob)
    bn_b = pair.rng.uniform(-0.2, 0.2, ob)
    ct = pair.t.encrypt(pair.t.encoder.encode_coeffs(
        convops.prep_input(img.ravel(), raw, IN_WID, n, norm),
        pair.t.params.scale, 1))
    # the expected conv + BN on the whole padded grid, channels at stride
    # norm of each position's MB slots
    full = np.zeros((IN_WID, IN_WID, ib))
    full[:raw, :raw] = img
    conv = convops.conv2d_same_np(full, ker) * bn_a + bn_b
    cfs = np.zeros(n)
    for b in range(ob):
        cfs[b * norm::MB] = conv[..., b].ravel()
    maps = tpipe.LayerMaps(ext_idx=[rp.gen_keep_vec_sparse(n // 2, IN_WID,
                                                           raw, LS), None])
    oracle = DebugOracle(pair.t, IN_WID, raw, "Conv_sparse", POW, LS, cfs,
                         maps=maps)
    tpipe.eval_conv_bn_relu(pair.t, tbt, ct, ker.ravel(), bn_a, bn_b, 0.0, POW,
                            IN_WID, raw, KER, ib, ob, norm, 0, 1, 2, LS,
                            "Conv_sparse", maps, debug_hook=oracle)
    assert [s for s, _ in oracle.history] == ["conv", "ctos[0]", "relu[0]",
                                              "repack[0]", "stoc"]
    for stage, avg in oracle.history:
        assert avg is not None, f"stage {stage} had no golden"
        assert avg > 4.0, f"stage {stage} precision {avg} bits"


@pytest.mark.slow_e2e
def test_replay_jax_layer_on_the_port_keys(pair, tbt, case, tmp_path,
                                           monkeypatch):
    """The recording's source: the JAX package's layer on the port's
    switching keys (``interop.save_keys`` → its ``load_keys``; it makes
    none), from the port's input ciphertext, gives the recorded digests,
    and the port's layer the same."""
    tout = _port_layer(pair, tbt, case)
    monkeypatch.setenv("OPTCONV_DOUBLE_HOIST", "1")
    jbt = {LS: JaxBoot(pair.j, log_sparse=LS, **BOOT)}
    jout = _on_port_keys(pair.j, pair.t, str(tmp_path / "keys.npz"),
                         lambda: jpipe.eval_conv_bn_relu(
                             pair.j, jbt, _to_jax(case["tct"]),
                             *case["args"],
                             jpipe.LayerMaps(ext_idx=[case["mask"], None])))
    assert _digest(tout) == _digest(jout)
    _against_recording(layer=_replay_entry(CASE, pair.t, jout=jout))
