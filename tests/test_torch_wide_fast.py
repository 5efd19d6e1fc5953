"""The wide crop_fast runner (``WideFastResNetRunner``) at wide 3 on the
CPU, against the benchmark's plain PyTorch reference
(``portbench/reference/plain_torch.py``) on seeded weights, and the
recorder's ``transition`` span and ``conv.pack.keyswitches`` counter.

The runner's real path runs the ``StrConv_odd`` transition, both halves
with real bootstraps and their sum, on an exact encryption of the plain
model's block-1 output: at logN 9 (in_wids (16, 8, 4), real_batch
(2, 4, 8), every channel slot filled), and in ``slow_e2e`` at logN 10
(the ResNet-8 miniature of ``tests/test_torch_fast_resnet.py``'s
``wide3_d8``: real_batch (3, 6, 12), init_batch 2, a quarter of block
1's slots empty), where the two full-slot halves take 75-90 s on the
CPU.  The whole logN-10 image is ``slow_e2e`` too.  The counter is
held to the sum over an image's convs of (C − 1), C = max_batch / norm
the conv's plaintexts, which ``_pack_keyswitches`` derives from each
runner's geometry; at logN 16 that sum is what ``pack_ks.image`` reads
in each image cell of the benchmark."""

import numpy as np
import pytest
import torch

from optimal_conv_tpu_torch.ckks.context import CkksContext
from optimal_conv_tpu_torch.ckks.params import mini_boot_params
from optimal_conv_tpu_torch.models import imagenet as timg
from optimal_conv_tpu_torch.models import resnet as tres
from optimal_conv_tpu_torch.models.plain import NUM_BLOCKS, random_weights
from optimal_conv_tpu_torch.ops import conv as convops
from optimal_conv_tpu_torch.ops import pipeline
from optimal_conv_tpu_torch.utils import tracing

from portbench import common
from portbench.models import resnet_wide_fast
from portbench.tests.test_portbench_fast import _Family

torch.set_num_threads(1)

SEED = 2 ** 33 + 11
MINI = common.HERE / "tests" / "configs" / "resnet_wide_fast_mini.json"
BOOT = dict(k_range=12.0, sin_deg=31, double_angle=3)


# the logN-9 geometry: the miniature's grids, channels cut to the slots
LOG_N9 = dict(params=dict(preset="mini_boot_params", log_n=9, n_relu=14),
              in_ch=2, init_batch=1, real_batch=[2, 4, 8])


def _model(log_n: int = 10):
    """The benchmark's wide kind at a miniature, built: the runner,
    seeded weights, calibrated inputs, the plain PyTorch reference."""
    cfg = common.load_json(MINI)
    if log_n == 9:
        cfg.update(LOG_N9)
    m = resnet_wide_fast.Model(cfg, SEED, "cpu")
    m.build()
    return m


class _Stop(Exception):
    pass


@pytest.mark.parametrize("log_n", [
    9, pytest.param(10, marks=pytest.mark.slow_e2e)])
def test_wide3_transition_equals_plain_torch(monkeypatch, log_n):
    """Both ``StrConv_odd`` halves through the real fused layer (conv,
    full-slot CtoS, EvalMod, ReLU, the pack_pos-0 / pack_pos-2 repacks,
    StoC) and the runner's sum, each read in block 2's layout, against
    the plain model's transition output: the halves at their own layout
    channels, the sum at all of them.  Block 1 runs as exact encryptions
    of the plain model's activations; the runner stops at block 2."""
    m = _model(log_n)
    _, acts, _ = m.reference(m.image(1))
    n1 = NUM_BLOCKS[m.cfg["depth"]][0]
    real, kinds, halves = tres.eval_conv_bn_relu, [], []
    ctx = m.ctx

    def layer(*args):
        kind, ct_in = args[18], args[2]
        kinds.append(kind)
        if kind == "StrConv_odd":
            halves.append(real(*args))
            return halves[-1]
        if len(kinds) <= n1:
            return ctx.encrypt(ctx.encoder.encode_coeffs(
                m.runner.pack(acts[len(kinds) - 1], 0), ctx.params.scale,
                convops.ECD_LEVEL))
        raise _Stop(ct_in)
    monkeypatch.setattr(tres, "eval_conv_bn_relu", layer)
    with pytest.raises(_Stop) as stop:
        m.infer(m.image(1))
    assert kinds == ["Conv"] * n1 + ["StrConv_odd"] * 2 + ["Conv_inside"]
    li = n1
    want = acts[li]
    unit = 2.0 ** m.pows[li]
    co = want.shape[-1]
    got = [m.unpack(h, 1, np.arange(k, co, 2)) for k, h in enumerate(halves)]
    total = m.unpack(stop.value.args[0], 1, np.arange(co))
    # both halves land at level 1, as every fused layer does
    assert [h.level for h in halves] == [1, 1]
    # 5e-3 of 2^pow: about 5x the gaps measured at logN 9 and 10
    # (8.8e-4 to 9.0e-4, the mini chain's one bootstrap and ReLU), a
    # fifth of chip_smoke.py's bar for one fused layer (2e-2)
    for k in (0, 1):
        assert np.abs(got[k] - want[..., k::2]).max() / unit < 5e-3, k
    assert np.abs(total - want).max() / unit < 5e-3
    # the sum is the two halves added: each half reads as zero at the
    # other's channels, so only decryption noise (~1e-6 of 2^pow) differs
    np.testing.assert_allclose(total[..., 0::2], got[0], atol=1e-4 * unit)
    np.testing.assert_allclose(total[..., 1::2], got[1], atol=1e-4 * unit)


# ---------------------------------------------------------------------------
# the pack's key switches, from each runner's geometry
# ---------------------------------------------------------------------------

def _pack_keyswitches(n: int, convs: list) -> int:
    """Σ (C − 1) over convs [(in_wid, norm)]: C = max_batch / norm
    plaintexts a conv on the in_wid² grid, whose pack runs C − 1
    key-switch rows (stages of C/2, C/4, ..., 1)."""
    return sum(n // (w * w) // nm - 1 for w, nm in convs)


def _convs(kind: str, n: int, cfg: dict) -> list:
    """(in_wid, norm) of every conv of one image, the head's included,
    from the paper's geometry of each packing."""
    if kind == "tail":
        n0, n1 = cfg["num_blc"]
        # block 1 full on 16², two transition halves there at norm 1,
        # block 2 on 8² at norm 2, the RMFC head there at norm 1
        return [(16, 1)] * (n0 + 2) + [(8, 2)] * n1 + [(8, 1)]
    if kind == "final_fast":
        n0, n1 = cfg["num_blc"]
        # as the tail, but block 2 full on 8² at norm 1
        return [(16, 1)] * (n0 + 2) + [(8, 1)] * (n1 + 1)
    n1, n2, n3 = NUM_BLOCKS[cfg["depth"]]
    w0, w1, w2 = cfg["in_wids"]
    rb = cfg["real_batch"]
    if kind == "sparse":
        # each block on its own grid, norm max_batch / real_batch; a
        # StrConv_sparse transition splits its out-channels into two convs
        # at half the next block's norm on the block's own grid
        nm = [n // (w * w) // b for w, b in zip((w0, w1, w2), rb)]
        return ([(w0, nm[0])] * n1 + [(w0, nm[1] // 2)] * 2
                + [(w1, nm[1])] * n2 + [(w1, nm[2] // 2)] * 2
                + [(w2, nm[2])] * (n3 + 1))
    if kind == "fast":
        nm = [n // (w0 * w0) // b for b in rb]
        return ([(w0, nm[0])] * n1 + [(w0, nm[1])] * (1 + n2)
                + [(w0, nm[2])] * (1 + n3 + 1))
    # wide fast: norm (1, 2, 1) at wide 3, (2, 4, 2) at wide 2; the
    # StrConv_odd transition on the w0 grid, two halves at wide 3, one
    # interleaved conv at norm[0] / 2 at wide 2
    nm = tres.WideFastResNetRunner.NORMS[cfg["wide"]]
    odd = [(w0, nm[0])] * 2 if cfg["wide"] == 3 else [(w0, nm[0] // 2)]
    return ([(w0, nm[0])] * n1 + odd + [(w1, nm[1])] * n2
            + [(w1, nm[2])] * (1 + n3 + 1))


def test_pack_keyswitches_of_the_benchmark_cells():
    """At logN 16 the image cells' convs run 730 (ResNet-20 sparse), 3831
    (the tail), 732 (crop_fast), 2987 (wide 3) and 5367 (the final-fast
    tail) key-switch rows an image in their packs."""
    cells = {"resnet20_cifar10": "sparse", "imagenet_tail": "tail",
             "resnet20_cifar10_fast": "fast", "resnet20_wide3_fast": "wide",
             "imagenet_final_fast": "final_fast"}
    got = {}
    for name, kind in cells.items():
        cfg = common.load_json(common.HERE / "configs" / f"{name}.json")
        n = 1 << cfg["params"]["log_n"]
        got[name] = _pack_keyswitches(n, _convs(kind, n, cfg))
    assert got == {"resnet20_cifar10": 730, "imagenet_tail": 3831,
                   "resnet20_cifar10_fast": 732, "resnet20_wide3_fast": 2987,
                   "imagenet_final_fast": 5367}


MINI_CFG = dict(ker_wid=3, depth=8, in_wids=(16, 8, 4), fc_out=4,
                init_pow=4.0, mid_pow=4.0, final_pow=4.0)
# name: (kind, runner config, input channels)
MINIS = {
    "wide3": ("wide", dict(MINI_CFG, real_batch=(3, 6, 12), wide=3,
                           init_batch=2), 3),
    "wide2": ("wide", dict(MINI_CFG, real_batch=(2, 4, 8), wide=2,
                           init_batch=1), 2),
    "fast": ("fast", dict(MINI_CFG, real_batch=(1, 2, 4)), 1),
    "sparse": ("sparse", dict(MINI_CFG, real_batch=(1, 2, 4)), 1),
    "tail": ("tail", dict(num_blc=(1, 1)), 4),
    "final_fast": ("final_fast", dict(num_blc=(1, 1)), 4),
}


@pytest.fixture(scope="module")
def mini_ctx():
    return CkksContext(mini_boot_params(10, n_relu=14), "cpu", seed=SEED)


@pytest.mark.parametrize("name", list(MINIS))
def test_pack_counter_and_transition_span_on_a_mini_image(monkeypatch,
                                                          mini_ctx, name):
    """One mini image through each runner, the bootstrapper, the ReLU and
    the repacks stubbed so that every conv and head runs for real, under
    ``collect()``: the counter ``conv.pack.keyswitches`` moved inside the
    ``image`` root by the geometry's Σ (C − 1); a wide runner's image
    holds one ``transition`` span (kind StrConv_odd, halves 2 at wide 3
    and 1 at wide 2) around that many ``layer`` spans, the final-fast
    tail's one (kind StrConv, halves 2), the others none."""
    kind, cfg, in_ch = MINIS[name]
    monkeypatch.setattr(tres, "BootstrapperFamily", _Family)
    monkeypatch.setattr(timg, "BootstrapperFamily", _Family)
    monkeypatch.setattr(pipeline, "eval_relu", lambda ctx, ct, alpha: ct)
    for repack in ("keep_ctxt", "ext_ctxt", "ext_double_ctxt"):
        monkeypatch.setattr(pipeline, repack, lambda ctx, ct, *maps: ct)
    rng = np.random.default_rng(3)
    tracing.clear()
    if kind in ("tail", "final_fast"):
        cls = (timg.ImagenetTailRunner if kind == "tail"
               else timg.ImagenetFinalFastRunner)
        runner = cls(mini_ctx, 3, BOOT, cfg["num_blc"])
        b0, b1 = runner.real_batch
        n0, n1 = cfg["num_blc"]
        shapes = [(b0, b0)] * n0 + [(b0, b1)] + [(b1, b1)] * n1
        convs = [rng.uniform(-0.3, 0.3, (3, 3, i, o)) for i, o in shapes]
        with tracing.collect():
            runner.infer_logits(
                rng.uniform(-1, 1, (14, 14, in_ch)), convs,
                [np.ones(o) for _, o in shapes],
                [np.zeros(o) for _, o in shapes],
                rng.normal(0, 0.3, (b1, 4)), np.zeros(4))
    else:
        rcfg = tres.ResNetConfig(**cfg)
        cls = {"wide": tres.WideFastResNetRunner, "fast":
               tres.FastResNetRunner, "sparse": tres.ResNetRunner}[kind]
        runner = cls(mini_ctx, rcfg, BOOT)
        w = random_weights(3, rcfg.depth, rcfg.real_batch, fc_out=4,
                           in_ch=in_ch, seed=4, scale=0.7,
                           init_batch=cfg.get("init_batch"))
        raw0 = rcfg.raw_in_wids[0]
        with tracing.collect():
            runner.infer(rng.uniform(-1, 1, (raw0, raw0, in_ch)), w)
    recs = tracing.records()
    tracing.clear()
    root = [r for r in recs if r["name"] == "image" and not r["parent"]][-1]
    want = _pack_keyswitches(mini_ctx.params.n,
                             _convs(kind, mini_ctx.params.n, cfg))
    assert root["counters"]["conv.pack.keyswitches"] == want
    spans = tracing.tree(recs, root["id"])
    trans = [r for r in spans if r["name"] == "transition"]
    if kind not in ("wide", "final_fast"):
        assert trans == []
        return
    tkind = "StrConv_odd" if kind == "wide" else "StrConv"
    halves = 1 if cfg.get("wide") == 2 else 2
    assert [r["attrs"] for r in trans] == [dict(kind=tkind, halves=halves)]
    inside = [r for r in spans if r["parent"] == trans[0]["id"]]
    assert [(r["name"], r["attrs"]["kind"]) for r in inside] == [
        ("layer", tkind)] * halves


@pytest.mark.slow_e2e
def test_wide3_image_equals_plain_torch():
    """The whole wide-3 ResNet-8 miniature, encrypted end to end on the
    CPU (nine fused-layer calls with real bootstraps and the head),
    against the plain PyTorch reference: the logits within the bar the
    benchmark's image cells hold (0.022 of 2^pow), and the argmax."""
    m = _model()
    x = m.image(1)
    logits = m.infer(x)
    _, _, want = m.reference(x)
    assert np.abs(logits - want).max() / 2.0 ** m.logit_pow < 0.022
    assert int(np.argmax(logits)) == int(np.argmax(want))
