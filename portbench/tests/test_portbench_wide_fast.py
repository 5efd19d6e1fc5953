"""The wide crop_fast kind (``portbench/models/resnet_wide_fast.py``) on
the CPU: the harness's image runs at the program's miniature sizes
(ResNet-8 at wide 3, logN 10) with an exact stand-in for the fused layer
in the kind's layouts (a sound run is correct; a layer that returns its
input, a logit altered where it is produced, and either ``StrConv_odd``
half swapped for the other are not), the plain PyTorch reference against
the NumPy one on the wide plan, the control at the cell's own sizes, the
readers of the ``transition`` span and the pack's key-switch counter in
a traced pass, and on the card block 1 and both transition halves at
the cell's sizes."""

import importlib
import itertools
from types import SimpleNamespace

import numpy as np
import pytest

from portbench import common, control, run
from portbench.models import resnet_wide_fast
from portbench.reference import plain, plain_torch
from portbench.tests.test_portbench_fast import _Family

SEED = 2 ** 33 + 5
WIDE = "resnet20_wide3_fast.image"
MINI = "resnet_wide_fast_mini"


def _config(name: str) -> dict:
    path = common.HERE / "tests" / "configs" / f"{name}.json"
    if not path.is_file():
        path = common.HERE / "configs" / f"{name}.json"
    return common.load_json(path)


def _cell() -> dict:
    cell = common.cell(WIDE)
    cell["config"] = _config(MINI)
    return cell


def _model(cfg: dict, seed: int = SEED):
    kind = importlib.import_module(f"portbench.models.{cfg['model']}")
    return kind.Model(cfg, seed, "cpu")


def _exact_layer(cfg: dict, fault=None, swap=None):
    """A stand-in for the fused layer that is exact: decrypt, the plain
    conv + BN + ReLU, encrypt, each side in its block's layout.  The
    block is told by the grid and the step; a ``StrConv_odd`` half by
    its kernel, which has to be one out-channel half of the model's
    transition kernel, and its output lands at that half's layout
    channels.  With `swap` h, the call of half h returns the other
    half's output.  fault(i, ct_in, out) may replace the output of call
    i."""
    m = _model(cfg)
    n = m.n
    grids = [(b[0], b[3]) for b in m.blocks]
    odd_li = [li for li, (blk, _, _, stride) in enumerate(m.plan)
              if stride and blk == 0][0]
    odd = m.layers[odd_li]
    calls = []

    def layer(ctx, btps, ct_in, ker_in, bn_a, bn_b, alpha, pow_, in_wid,
              kp_wid, ker_wid, real_ib, real_ob, norm, pack_pos, step,
              n_iter, log_sparse, kind, maps, debug_hook=None, on_stage=None):
        blk = grids.index((in_wid, step))
        in_blk = out_blk = blk
        if kind == "StrConv_odd":
            out_blk = blk + 1
        elif kind == "StrConv_inside":
            in_blk = blk - 1
        ker = np.reshape(ker_in, (ker_wid, ker_wid, real_ib, real_ob))
        half = None
        if kind == "StrConv_odd":
            half = [h for h in (0, 1)
                    if np.array_equal(ker, odd["ker"][..., h::2])][0]
            if half == swap:
                half = 1 - half
                ker = odd["ker"][..., half::2]
                bn_a, bn_b = odd["a"][half::2], odd["b"][half::2]
        if kind == "StrConv_inside":
            # the interleaved kernel: the real input channels at even slots
            ker = ker[:, :, 0::2]
        w, nm, raw, st = m.blocks[in_blk]
        cfs = ctx.decrypt_decode_coeffs(ct_in)
        x = cfs[common.layout_index(n, w, nm, raw, ker.shape[2], st)]
        y = plain.relu(plain.conv_bn(x, ker, bn_a, bn_b, plain.rounder(None)))
        w, nm, raw, st = m.blocks[out_blk]
        if kind.startswith("Str"):
            y = y[0::2, 0::2][:raw, :raw]
        out = np.zeros(n)
        if half is None:
            out[common.layout_index(n, w, nm, raw, real_ob, st)] = y
        else:
            out[common.layout_index(n, w, nm, raw, 2 * real_ob,
                                    st)[..., half::2]] = y
        ct = ctx.encrypt(ctx.encoder.encode_coeffs(out, ctx.params.scale, 1))
        calls.append(kind)
        return fault(len(calls) - 1, ct_in, ct) if fault else ct
    return layer


def _image_run(monkeypatch, fault=None, logits_fault=None, swap=None,
               seconds=0.1) -> dict:
    from optimal_conv_tpu_torch.models import resnet as prog
    cell = _cell()
    monkeypatch.setattr(prog, "eval_conv_bn_relu",
                        _exact_layer(cell["config"], fault, swap))
    if logits_fault:
        real = prog.head_conv
        monkeypatch.setattr(prog, "head_conv",
                            lambda *a, **kw: logits_fault(real(*a, **kw)))
    rec = run.measure(cell, SEED, seconds, False, device="cpu")
    rec["correct"] = run.result(cell, rec, False, 1, "cpu")["correct"]
    return rec


def test_kind_calls_and_layouts():
    """Twenty calls for nineteen layers at published widths: the
    transition's two halves hold the even and the odd out-channels at
    block 2's layout channels of the same numbers; the three layouts are
    the runner's."""
    from optimal_conv_tpu_torch.ckks.params import boot_params
    from optimal_conv_tpu_torch.models import resnet as prog

    cfg = _config("resnet20_wide3_fast")
    m = _model(cfg)
    assert len(m.layers) == 19 and len(m.calls) == 20
    assert [(ci, co) for _, ci, co, _ in m.plan[:3]] == [(3, 16), (16, 48),
                                                          (48, 48)]
    halves = [c for c in m.calls if c[0] == 7]
    assert [(sl, blk, list(ch[:2])) for _, sl, blk, ch in halves] == [
        (slice(0, None, 2), 1, [0, 2]), (slice(1, None, 2), 1, [1, 3])]
    assert [m.layers[li].get("stride_phase") for li in (7, 13)] == [0, 0]
    # the runner's own layout: its constructor on a context stand-in with
    # the cell's ring (it builds host tables only)
    n = boot_params(16).n
    runner = prog.WideFastResNetRunner(
        SimpleNamespace(params=boot_params(16)),
        prog.ResNetConfig(depth=20, wide=3, real_batch=tuple(cfg["real_batch"]),
                          init_batch=cfg["init_batch"]))
    for blk, (in_wid, norm, raw, step) in enumerate(m.blocks):
        assert runner.layout(blk) == (in_wid, n // in_wid ** 2, step, norm)
        assert runner.raw_wid(blk) == raw


def test_image_sound_run_is_correct(monkeypatch):
    rec = _image_run(monkeypatch)
    assert rec["correct"] and rec["compared"]["gap"] < 1e-3


def test_image_layer_returning_its_input_is_not_correct(monkeypatch):
    """A step that returns its state unchanged: every seventh call from
    the third hands on its input."""
    rec = _image_run(monkeypatch, fault=lambda i, ct_in, out:
                     ct_in if i % 7 == 2 else out)
    assert not rec["correct"] and rec["failed"] >= 1


def test_image_answer_altered_is_not_correct(monkeypatch):
    """A logit altered where it is produced, by a tenth of 2^pow."""
    def alter(logits):
        logits = logits.copy()
        logits[1] += 0.1 * 2.0 ** 4
        return logits
    rec = _image_run(monkeypatch, logits_fault=alter)
    assert not rec["correct"] and rec["failed"] == rec["attempted"]


@pytest.mark.parametrize("half", [0, 1])
def test_transition_half_swapped_is_not_correct(monkeypatch, half):
    """The call of one ``StrConv_odd`` half returns the other half's
    output: its own channels are missing, the other's doubled."""
    rec = _image_run(monkeypatch, swap=half)
    assert not rec["correct"] and rec["failed"] == rec["attempted"]


@pytest.mark.parametrize("name", ["resnet20_wide3_fast", MINI])
def test_torch_reference_equals_the_numpy_one(name):
    """``plain_torch.forward`` against ``plain.forward`` on the wide
    plan's seeded weights and inputs: every pre-activation, activation
    and logit within 1e-12 of its largest magnitude."""
    m = _model(_config(name), 2 ** 33 + 7)
    for i in (0, 1):
        x = m.image(i)
        got = plain_torch.forward(m.layers, x, m.fc_w, m.fc_b)
        want = plain.forward(m.layers, x, m.fc_w, m.fc_b)
        for g_list, w_list in zip(got[:2], want[:2]):
            assert len(g_list) == len(w_list) == len(m.layers)
            for g, w in zip(g_list, w_list):
                assert g.shape == w.shape
                assert np.abs(g - w).max() <= 1e-12 * np.abs(w).max()
        assert np.abs(got[2] - want[2]).max() <= 1e-12 * np.abs(want[2]).max()


def test_outputs_depend_on_the_image():
    """As for the other image cells: every fused layer's outputs of two
    seeded inputs differ by over five times the cell's limit."""
    m = _model(_config("resnet20_wide3_fast"), 2 ** 33 + 1)
    limit = common.load_json(common.HERE / "limits" / f"{WIDE}.json")["gap"]
    outs = [m.reference(m.image(i)) for i in (1, 2, 3)]
    for (_, a1, _), (_, a2, _) in itertools.combinations(outs, 2):
        layers = max(np.abs(a1[li][..., sl] - a2[li][..., sl]).max()
                     / 2.0 ** m.pows[li] for li, sl, _, _ in m.calls)
        assert layers > 5 * limit


def test_control_fails_the_cell():
    """The reference in the precision below the configuration's, in the
    program's place at the cell's own sizes, comes out not correct."""
    out = control.result(common.cell(WIDE), 2 ** 33 + 31, 0.5, "cpu")
    assert out["correct"] is False, out["compared"]
    assert out["attempted"] >= 1


def test_transition_and_pack_readers_in_the_traced_pass(monkeypatch):
    """The traced pass through the real fused layer at the mini (the
    bootstrapper and the ReLU stubbed; spans recorded under
    ``collect()`` where the card's run has the profiler):
    ``odd_transition_ms.image`` reads the one ``transition`` span, which
    holds both halves' layer spans; ``pack_ks.image`` reads the sum over
    every conv of the image, the head's included, of its plaintexts less
    one."""
    import time

    from optimal_conv_tpu_torch.models import resnet as prog
    from optimal_conv_tpu_torch.ops import pipeline
    from optimal_conv_tpu_torch.utils import tracing

    from portbench import trace as tr

    def window(fn, sync, marks=None):
        t0 = time.time_ns()
        with tracing.collect():
            out = fn()
        return out, tr.reduce_events([], t0, time.time_ns(), marks)
    monkeypatch.setattr(tr, "device_window", window)
    monkeypatch.setattr(prog, "BootstrapperFamily", _Family)
    monkeypatch.setattr(pipeline, "eval_relu", lambda ctx, ct, alpha: ct)
    cell = _cell()
    tracing.clear()
    rec = run.measure(cell, SEED, 0.1, True, device="cpu")
    metrics = run.read_per_layer(cell, rec)
    recs = tracing.records()
    tracing.clear()
    root = [r for r in recs if r["name"] == "image" and not r["parent"]][-1]
    spans = tracing.tree(recs, root["id"])
    trans = [r for r in spans if r["name"] == "transition"]
    assert [r["attrs"] for r in trans] == [dict(kind="StrConv_odd", halves=2)]
    inside = [r for r in spans if r["parent"] == trans[0]["id"]]
    assert [(r["name"], r["attrs"]["kind"]) for r in inside] == [
        ("layer", "StrConv_odd")] * 2
    assert metrics["odd_transition_ms.image"]["value"] == pytest.approx(
        (trans[0]["t1"] - trans[0]["t0"]) / 1e6)
    # C = max_batch / norm plaintexts a conv (logN 10: the 16² grid has
    # 4 slots a position, the 8² grid 16; norms 1, 2, 1 by block)
    n1, n2, n3 = cell["config"]["blocks"]
    cs = [4] * n1 + [4, 4] + [8] * n2 + [16] + [16] * n3 + [16]
    assert metrics["pack_ks.image"]["value"] == sum(c - 1 for c in cs)
    assert metrics["low_half_ms.image"]["value"] > 0


@pytest.mark.cuda
def test_block1_and_transition_halves_on_the_card(card):
    """The kind's fused layers at the cell's sizes on the card, from the
    first through both ``StrConv_odd`` halves, read through the kind's
    ``unpack``, within the cell's limit of the PyTorch reference."""
    from optimal_conv_tpu_torch.models import resnet as prog

    class Stop(Exception):
        pass
    cell = common.cell(WIDE)
    m = resnet_wide_fast.Model(cell["config"], 6000002201, card)
    m.build()
    calls = m.calls[: [c[0] for c in m.calls].index(7) + 2]
    real, outs = prog.eval_conv_bn_relu, []

    def upto(*a, **kw):
        outs.append(real(*a, **kw))
        if len(outs) == len(calls):
            raise Stop
        return outs[-1]
    prog.eval_conv_bn_relu = upto
    try:
        with pytest.raises(Stop):
            m.infer(m.image(1))
    finally:
        prog.eval_conv_bn_relu = real
    _, acts, _ = m.reference(m.image(1))
    for out, (li, sl, blk, ch) in zip(outs, calls):
        got = m.unpack(out, blk, ch)
        gap = np.abs(got - acts[li][..., sl]).max() / 2.0 ** m.pows[li]
        assert gap <= cell["limits"]["gap"], (li, gap)
