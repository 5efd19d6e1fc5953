"""The crop_fast kind (``portbench/models/resnet_fast.py``) beside the
crop_sparse one, on the CPU: the harness's image runs at the program's
miniature sizes (ResNet-8, logN 10) with an exact stand-in for the fused
layer in each kind's layout (a sound run is correct; a layer that returns
its input and a logit altered where it is produced are not), the plain
PyTorch reference against the NumPy one, the control at the cell's own
sizes, the spans of each CtoS half that ``low_half_ms.image`` reads, and
on the card the kind's first two layers at the cell's sizes."""

import importlib
import itertools

import numpy as np
import pytest

from portbench import common, control, run
from portbench.models import resnet_fast
from portbench.reference import plain, plain_torch

SEED = 2 ** 33 + 5
# each mini beside the cell whose manifest entries it borrows
MINIS = {"resnet_mini": "resnet20_cifar10.image",
         "resnet_fast_mini": "resnet20_cifar10_fast.image"}
FAST = "resnet20_cifar10_fast.image"


def _config(name: str) -> dict:
    path = common.HERE / "tests" / "configs" / f"{name}.json"
    if not path.is_file():
        path = common.HERE / "configs" / f"{name}.json"
    return common.load_json(path)


def _cell(mini: str) -> dict:
    cell = common.cell(MINIS[mini])
    cell["config"] = _config(mini)
    return cell


def _model(cfg: dict, seed: int = SEED):
    kind = importlib.import_module(f"portbench.models.{cfg['model']}")
    return kind.Model(cfg, seed, "cpu")


def _exact_layer(cfg: dict, fault=None):
    """A stand-in for the fused layer that is exact: decrypt, the plain
    conv + BN + ReLU, encrypt, each side in its block's layout at its
    step (the crop_sparse kind's blocks are one grid each at step 1; the
    crop_fast kind's share one grid, the block told by its step).
    fault(i, ct_in, out) may replace the output of call i."""
    m = _model(cfg)
    n = m.n
    blocks = [tuple(b) + (1,) * (4 - len(b)) for b in m.blocks]
    fast = cfg["model"] == "resnet_fast"
    calls = []

    def layer(ctx, btps, ct_in, ker_in, bn_a, bn_b, alpha, pow_, in_wid,
              kp_wid, ker_wid, real_ib, real_ob, norm, pack_pos, step,
              n_iter, log_sparse, kind, maps, debug_hook=None, on_stage=None):
        strided = kind.startswith("Str")
        if fast:
            out_blk = [b[3] for b in blocks].index(step)
            in_blk = out_blk - strided
        else:
            in_blk = [b[0] for b in blocks].index(in_wid)
            out_blk = in_blk + strided
        ker = np.reshape(ker_in, (ker_wid, ker_wid, real_ib, real_ob))
        if kind == "StrConv_inside":
            # the interleaved kernel: the real input channels at even slots
            ker = ker[:, :, 0::2]
        w, nm, raw, st = blocks[in_blk]
        cfs = ctx.decrypt_decode_coeffs(ct_in)
        x = cfs[common.layout_index(n, w, nm, raw, ker.shape[2], st)]
        y = plain.relu(plain.conv_bn(x, ker, bn_a, bn_b, plain.rounder(None)))
        w, nm, raw, st = blocks[out_blk]
        if strided:
            y = y[0::2, 0::2][:raw, :raw]
        out = np.zeros(n)
        out[common.layout_index(n, w, nm, raw, real_ob, st)] = y
        ct = ctx.encrypt(ctx.encoder.encode_coeffs(out, ctx.params.scale, 1))
        calls.append(kind)
        return fault(len(calls) - 1, ct_in, ct) if fault else ct
    return layer


def _image_run(monkeypatch, mini, fault=None, logits_fault=None,
               seconds=0.1) -> dict:
    from optimal_conv_tpu_torch.models import resnet as prog
    cell = _cell(mini)
    monkeypatch.setattr(prog, "eval_conv_bn_relu",
                        _exact_layer(cell["config"], fault))
    if logits_fault:
        # both kinds' heads end in the module's head_conv
        real = prog.head_conv
        monkeypatch.setattr(prog, "head_conv",
                            lambda *a, **kw: logits_fault(real(*a, **kw)))
    rec = run.measure(cell, SEED, seconds, False, device="cpu")
    rec["correct"] = run.result(cell, rec, False, 1, "cpu")["correct"]
    return rec


@pytest.mark.parametrize("mini", list(MINIS))
def test_image_sound_run_is_correct(monkeypatch, mini):
    rec = _image_run(monkeypatch, mini)
    assert rec["correct"] and rec["compared"]["gap"] < 1e-3


@pytest.mark.parametrize("mini", list(MINIS))
def test_image_layer_returning_its_input_is_not_correct(monkeypatch, mini):
    """A step that returns its state unchanged: layer 2 of every image
    hands on its input."""
    rec = _image_run(monkeypatch, mini, fault=lambda i, ct_in, out:
                     ct_in if i % 7 == 2 else out)
    assert not rec["correct"] and rec["failed"] >= 1


@pytest.mark.parametrize("mini", list(MINIS))
def test_image_answer_altered_is_not_correct(monkeypatch, mini):
    """A logit altered where it is produced, by a tenth of 2^pow."""
    def alter(logits):
        logits = logits.copy()
        logits[1] += 0.1 * 2.0 ** 4
        return logits
    rec = _image_run(monkeypatch, mini, logits_fault=alter)
    assert not rec["correct"] and rec["failed"] == rec["attempted"]


@pytest.mark.parametrize("name", ["resnet20_cifar10_fast", "resnet_fast_mini"])
def test_torch_reference_equals_the_numpy_one(name):
    """``plain_torch.forward`` against ``plain.forward`` on the kind's
    seeded weights and inputs: every pre-activation, activation and
    logit within 1e-12 of its largest magnitude."""
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


@pytest.mark.parametrize("seed", [0, 2 ** 33 + 1])
def test_outputs_depend_on_the_image(seed):
    """As for the crop_sparse cell: every fused layer's outputs of two
    seeded inputs differ by over five times the cell's limit."""
    m = _model(_config("resnet20_cifar10_fast"), seed)
    limit = common.load_json(common.HERE / "limits" / f"{FAST}.json")["gap"]
    outs = [m.reference(m.image(i)) for i in (1, 2, 3)]
    for (_, a1, _), (_, a2, _) in itertools.combinations(outs, 2):
        layers = max(np.abs(a1[li][..., sl] - a2[li][..., sl]).max()
                     / 2.0 ** m.pows[li] for li, sl, _, _ in m.calls)
        assert layers > 5 * limit


def test_control_fails_the_cell():
    """The reference in the precision below the configuration's, in the
    program's place at the cell's own sizes, comes out not correct."""
    out = control.result(common.cell(FAST), 31, 0.5, "cpu")
    assert out["correct"] is False, out["compared"]
    assert out["attempted"] >= 1


class _Halves:
    """Stands in for a bootstrapper: CtoS hands on a fresh encryption at
    the top level, two halves at log_sparse 0 and one above, StoC one at
    level 1; so the fused layer's own stages and repacks run on it."""

    def __init__(self, ctx, ls):
        self.ctx, self.ls = ctx, ls

    def _fresh(self, level):
        p = self.ctx.params
        return self.ctx.encrypt(self.ctx.encoder.encode_coeffs(
            np.zeros(p.n), p.scale, level))

    def ctos(self, ct, on_stage=None):
        top = self.ctx.params.max_level
        return self._fresh(top), self._fresh(top) if self.ls == 0 else None

    def stoc(self, up, low, on_stage=None):
        return self._fresh(1)


class _Family(dict):
    def __init__(self, ctx, *_):
        super().__init__()
        self.ctx = ctx

    def __missing__(self, ls):
        return self.setdefault(ls, _Halves(self.ctx, ls))


@pytest.mark.parametrize("mini,halves", [("resnet_fast_mini", 2),
                                         ("resnet_mini", 1)])
def test_low_half_spans_in_the_traced_pass(monkeypatch, mini, halves):
    """The traced pass through the real fused layer (the bootstrapper and
    the ReLU stubbed; spans recorded under ``collect()`` where the card's
    run has the profiler): ``low_half_ms.image`` reads a positive value
    where every layer has two halves and None where each has one; each
    layer keeps its five stage spans, and its relu and repack stages
    hold one span a half."""
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
    cell = _cell(mini)
    tracing.clear()
    rec = run.measure(cell, SEED, 0.1, True, device="cpu")
    metrics = run.read_per_layer(cell, rec)
    recs = tracing.records()
    tracing.clear()
    root = [r for r in recs if r["name"] == "image" and not r["parent"]][-1]
    spans = tracing.tree(recs, root["id"])
    layers = [r for r in spans if r["name"] == "layer"]
    assert len(layers) == len(_model(cell["config"]).calls)
    for lay in layers:
        assert lay["attrs"]["halves"] == halves
        top = {r["name"]: r for r in spans if r["parent"] == lay["id"]}
        assert list(top) == ["conv", "ctos", "relu", "repack", "stoc"]
        for stage in ("relu", "repack"):
            kids = [r for r in spans if r["parent"] == top[stage]["id"]]
            assert [(r["name"], r["attrs"]["ul"]) for r in kids] == [
                (f"{stage}.half", ul) for ul in range(halves)]
    if halves == 2:
        assert metrics["low_half_ms.image"]["value"] > 0
    else:
        assert "low_half_ms.image" not in metrics
        read = run.read_per_layer(dict(cell, per_layer=[dict(
            name="low_half_ms.image", unit="ms")]), rec)
        assert read == {}


@pytest.mark.cuda
def test_first_two_layers_on_the_card(card):
    """The kind's first two fused layers at the cell's sizes on the card,
    read through the kind's ``unpack``, within the cell's limit of the
    PyTorch reference."""
    from optimal_conv_tpu_torch.models import resnet as prog

    class Stop(Exception):
        pass
    cell = common.cell(FAST)
    m = resnet_fast.Model(cell["config"], 6000001801, card)
    m.build()
    real, outs = prog.eval_conv_bn_relu, []

    def two(*a, **kw):
        outs.append(real(*a, **kw))
        if len(outs) == 2:
            raise Stop
        return outs[-1]
    prog.eval_conv_bn_relu = two
    try:
        with pytest.raises(Stop):
            m.infer(m.image(1))
    finally:
        prog.eval_conv_bn_relu = real
    _, acts, _ = m.reference(m.image(1))
    for out, (li, sl, blk, ch) in zip(outs, m.calls):
        got = m.unpack(out, blk, ch)
        gap = np.abs(got - acts[li][..., sl]).max() / 2.0 ** m.pows[li]
        assert gap <= cell["limits"]["gap"], (li, gap)
