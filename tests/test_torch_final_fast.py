"""The ImageNet tail in its full-slot packing (``ImagenetFinalFastRunner``)
on the CPU, against the benchmark's plain PyTorch reference
(``portbench/reference/plain_torch.py``) on seeded weights, and the
recorder's ``transition`` span and ``repack.rotations`` counter.

The runner's real path runs at logN 9 (the benchmark kind's miniature,
``portbench/tests/configs/imagenet_final_fast_mini.json``: 2 → 4
channels, one layer a block): block 1 as an exact encryption of the
plain model's output, then the transition (both plain ``StrConv``
halves with real full-slot bootstraps and the single-stage ``ext_ctxt``
repack, and their sum), the block-2 ``Conv`` layer and the RMFC head,
each against the reference.  The span and the counter are read on an
image of each ImageNet runner on the same context, its bootstrapper and
ReLU stubbed, so that every conv, head and repack
runs for real; ``tests/test_torch_wide_fast.py`` holds the pack's rows
of every runner, this one's included (5 367 at logN 16).  The whole
mini image is ``slow_e2e``."""

import time

import numpy as np
import pytest
import torch

from optimal_conv_tpu_torch.models import imagenet as timg
from optimal_conv_tpu_torch.ops import conv as convops
from optimal_conv_tpu_torch.ops import pipeline
from optimal_conv_tpu_torch.utils import tracing

from portbench import common
from portbench.models import imagenet_final_fast
from portbench.tests.test_portbench_fast import _Family

torch.set_num_threads(1)

SEED = 2 ** 33 + 13
MINI = common.HERE / "tests" / "configs" / "imagenet_final_fast_mini.json"
BOOT = dict(k_range=12.0, sin_deg=31, double_angle=3)


@pytest.fixture(scope="module")
def mini():
    """The benchmark's final-fast kind at its miniature, built: the
    runner, seeded weights, calibrated inputs, the plain PyTorch
    reference."""
    m = imagenet_final_fast.Model(common.load_json(MINI), SEED, "cpu")
    m.build()
    return m


def test_transition_block2_and_head_equal_plain_torch(monkeypatch, mini):
    """Block 1 runs as an exact encryption of the plain model's output;
    then the real fused layer for both ``StrConv`` halves (conv,
    full-slot CtoS, EvalMod, ReLU, the pack_pos-0 / pack_pos-1
    ``ext_ctxt`` repacks, StoC), the runner's sum, the block-2 ``Conv``
    layer on that sum, and the RMFC head on its output, each read in
    its block's layout against the reference."""
    m = mini
    ctx = m.ctx
    x = m.image(1)
    _, acts, want_logits = m.reference(x)
    n0 = m.cfg["num_blc"][0]
    real, kinds, outs, ins = timg.eval_conv_bn_relu, [], [], []

    def layer(*args):
        kinds.append(args[18])
        ins.append(args[2])
        if len(kinds) <= n0:
            return ctx.encrypt(ctx.encoder.encode_coeffs(
                m.runner.pack(acts[len(kinds) - 1], 0), ctx.params.scale,
                convops.ECD_LEVEL))
        outs.append(real(*args))
        return outs[-1]
    monkeypatch.setattr(timg, "eval_conv_bn_relu", layer)
    logits = m.infer(x)
    assert kinds == ["Conv"] * n0 + ["StrConv"] * 2 + ["Conv"]
    # every fused layer lands at level 1
    assert [o.level for o in outs] == [1, 1, 1]
    calls = m.calls[n0:]
    # 5e-3 of 2^pow: about 5x the gaps of one fused layer at the mini
    # chain (its one bootstrap and ReLU: 9e-4 at logN 9 and 10), a fifth
    # of chip_smoke.py's bar for one fused layer (2e-2)
    for out, (li, sl, blk, ch) in zip(outs, calls):
        got = m.unpack(out, blk, ch)
        assert np.abs(got - acts[li][..., sl]).max() / 2.0 ** m.pows[li] \
            < 5e-3, li
    # the sum is what the block-2 layer received: both halves in place,
    # each zero at the other's channels, so it reads as the whole
    # transition output within decryption noise (~1e-6 of 2^pow)
    li = n0
    unit = 2.0 ** m.pows[li]
    total = m.unpack(ins[n0 + 2], 1, np.arange(acts[li].shape[-1]))
    assert np.abs(total - acts[li]).max() / unit < 5e-3
    for out, (_, sl, blk, ch) in zip(outs[:2], calls[:2]):
        np.testing.assert_allclose(total[..., sl], m.unpack(out, blk, ch),
                                   atol=1e-4 * unit)
    # the head: 0.022 of 2^pow, the limit of the benchmark's image cells;
    # here it sums three fused layers' errors through an FC of gain 8
    unit = 2.0 ** m.logit_pow
    assert np.abs(logits - want_logits).max() / unit < 0.022
    assert int(np.argmax(logits)) == int(np.argmax(want_logits))


# ---------------------------------------------------------------------------
# the span and the counter, on a mini image with the bootstrapper stubbed
# ---------------------------------------------------------------------------

def _stubbed_image(ctx, name):
    """One image through the runner `name` (num_blc (1, 1)) on `ctx`
    under ``collect()``, the bootstrapper and the ReLU stubbed, the
    runner's sums stamped: → (the runner, the spans of the image, the
    sums' ``time.time_ns()``)."""
    sums = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(timg, "BootstrapperFamily", _Family)
        mp.setattr(pipeline, "eval_relu", lambda ctx, ct, alpha: ct)
        add = ctx.add
        mp.setattr(ctx, "add", lambda a, b: sums.append(time.time_ns())
                   or add(a, b), raising=False)
        runner = getattr(timg, name)(ctx, 3, BOOT, (1, 1))
        b0, b1 = runner.real_batch
        shapes = [(b0, b0), (b0, b1), (b1, b1)]
        rng = np.random.default_rng(5)
        convs = [rng.uniform(-0.3, 0.3, (3, 3, i, o)) for i, o in shapes]
        tracing.clear()
        with tracing.collect():
            runner.infer_logits(
                rng.uniform(-1, 1, (14, 14, b0)), convs,
                [np.ones(o) for _, o in shapes],
                [np.zeros(o) for _, o in shapes],
                rng.normal(0, 0.3, (b1, 4)), np.zeros(4))
        recs = tracing.records()
        tracing.clear()
    root = [r for r in recs if r["name"] == "image" and not r["parent"]][-1]
    return runner, tracing.tree(recs, root["id"]), sums


@pytest.fixture(scope="module")
def stubbed(mini):
    """`_stubbed_image` on the miniature's context, made once a runner."""
    made = {}

    def image(name):
        if name not in made:
            made[name] = _stubbed_image(mini.ctx, name)
        return made[name]
    return image


def test_transition_span_holds_both_halves_and_their_sum(stubbed):
    """The final-fast image holds one ``transition`` span (kind
    "StrConv", halves 2) around the two ``StrConv`` layer spans and the
    sum: it ends after the second half's layer span."""
    _, spans, sums = stubbed("ImagenetFinalFastRunner")
    trans = [r for r in spans if r["name"] == "transition"]
    assert [r["attrs"] for r in trans] == [dict(kind="StrConv", halves=2)]
    inside = [r for r in spans if r["parent"] == trans[0]["id"]]
    assert [(r["name"], r["attrs"]["kind"]) for r in inside] == [
        ("layer", "StrConv")] * 2
    assert any(inside[-1]["t1"] <= t <= trans[0]["t1"] for t in sums)


def _repack_maps(runner) -> list:
    """The {rotation: mask} tables an image's repacks rotate by, from the
    runner's own tables: each transition call's two halves, both stages
    of a two-stage repack; the block layers' keep masks rotate nothing."""
    maps = runner.str_maps
    if isinstance(maps, list):          # final fast: one call a pack_pos
        return [t for lm in maps for t in (lm.r_idx, lm.r_idx_l)]
    # the sparse tail: two calls on the same two-stage maps
    return 2 * [maps.m_idx, maps.r_idx, maps.m_idx_l, maps.r_idx_l]


@pytest.mark.parametrize("name", ["ImagenetFinalFastRunner",
                                  "ImagenetTailRunner"])
def test_repack_rotations_equal_the_runners_maps(stubbed, name):
    """``repack.rotations`` moved inside the image root by Σ len(maps)
    over its repacks: the single-stage ``ext_ctxt`` of the final-fast
    transition, and both stages of the tail's ``ext_double_ctxt``."""
    runner, spans, _ = stubbed(name)
    root = [r for r in spans if not r["parent"]][0]
    want = sum(len(t) for t in _repack_maps(runner))
    assert want > 0
    assert root["counters"]["repack.rotations"] == want


@pytest.mark.slow_e2e
def test_final_fast_image_equals_plain_torch(mini):
    """The whole logN-9 miniature, encrypted end to end on the CPU (four
    fused-layer calls with real bootstraps and the head), against the
    plain PyTorch reference: every fused-layer call and the logits
    within the bar the benchmark's image cells hold (0.022 of 2^pow),
    and the argmax."""
    m = mini
    x = m.image(2)
    outs = []
    real = timg.eval_conv_bn_relu

    def keep(*args):
        outs.append(real(*args))
        return outs[-1]
    timg.eval_conv_bn_relu = keep
    try:
        logits = m.infer(x)
    finally:
        timg.eval_conv_bn_relu = real
    _, acts, want = m.reference(x)
    assert len(outs) == len(m.calls)
    for out, (li, sl, blk, ch) in zip(outs, m.calls):
        got = m.unpack(out, blk, ch)
        assert np.abs(got - acts[li][..., sl]).max() / 2.0 ** m.pows[li] \
            < 0.022, li
    assert np.abs(logits - want).max() / 2.0 ** m.logit_pow < 0.022
    assert int(np.argmax(logits)) == int(np.argmax(want))
