"""The final-fast ImageNet kind (``portbench/models/imagenet_final_fast.py``)
on the CPU: its calls against the runner's ``transition_channels``, the
harness's image run on the program at the miniature (logN 9: 2 → 4
channels, one layer a block) and with an exact stand-in for the fused
layer in the kind's layouts (a sound run is correct; a transition half
that returns the other half's output, a transition that keeps the even
samples, and a logit altered where it is produced are not), the plain
PyTorch reference against the NumPy one, the control at the cell's own
sizes, and the readers of the ``transition`` span and the
``repack.rotations`` counter in a traced pass."""

import importlib
import itertools
from types import SimpleNamespace

import numpy as np
import pytest

from portbench import common, control, run
from portbench.reference import plain, plain_torch
from portbench.tests.test_portbench_fast import _Family

SEED = 2 ** 33 + 5
CELL = "imagenet_final_fast.image"
MINI = "imagenet_final_fast_mini"


def _config(name: str) -> dict:
    path = common.HERE / "tests" / "configs" / f"{name}.json"
    if not path.is_file():
        path = common.HERE / "configs" / f"{name}.json"
    return common.load_json(path)


def _cell() -> dict:
    cell = common.cell(CELL)
    cell["config"] = _config(MINI)
    return cell


def _model(cfg: dict, seed: int = SEED):
    kind = importlib.import_module(f"portbench.models.{cfg['model']}")
    return kind.Model(cfg, seed, "cpu")


@pytest.mark.parametrize("name", ["imagenet_final_fast", MINI])
def test_kind_calls_match_the_runner(name):
    """Eight calls for seven layers at published widths (four at the
    mini): the transition's half h holds the out-channels
    [h·b1/2, (h+1)·b1/2) at the runner's ``transition_channels(h)``; the
    blocks are the runner's layouts, and the stride phase its own."""
    from optimal_conv_tpu_torch.ckks import params as prm
    from optimal_conv_tpu_torch.models import imagenet as prog

    cfg = _config(name)
    m = _model(cfg)
    n0, n1 = cfg["num_blc"]
    assert len(m.layers) == n0 + 1 + n1 and len(m.calls) == n0 + 2 + n1
    pc = dict(cfg["params"])
    params = getattr(prm, pc.pop("preset"))(**pc)
    # the runner's constructor on a context stand-in with the cell's ring
    # (it builds host tables only)
    runner = prog.ImagenetFinalFastRunner(SimpleNamespace(params=params), 3,
                                          cfg["boot_kwargs"], (n0, n1))
    assert tuple(cfg["real_batch"]) == runner.real_batch
    b1 = runner.real_batch[1]
    halves = [c for c in m.calls if c[0] == n0]
    assert len(halves) == 2
    for h, (_, sl, blk, ch) in enumerate(halves):
        assert blk == 1
        assert np.array_equal(ch, runner.transition_channels(h))
        assert np.array_equal(np.arange(b1)[sl], ch)
    assert m.layers[n0]["stride_phase"] == runner.stride_phase == 1
    for blk, (in_wid, norm, raw) in enumerate(m.blocks):
        assert runner.layout(blk) == (in_wid, params.n // in_wid ** 2, 1,
                                      norm)
        assert runner.raw_wid(blk) == raw


def test_kind_builds_and_its_check_is_correct_on_the_program():
    """The harness's image run on the real program at the miniature: the
    runner built from the kind, input 0 warming, the window's images
    and the check against ``plain_torch`` (~1.5 min on the CPU)."""
    cell = _cell()
    rec = run.measure(cell, SEED, 0.1, False, device="cpu")
    out = run.result(cell, rec, False, 1, "cpu")
    assert out["correct"] and rec["attempted"] >= 1, out["compared"]
    # the program's one full-slot bootstrap a layer at the mini chain:
    # 2e-3 of 2^pow, against the cell's limit
    assert rec["compared"]["gap"] < cell["limits"]["gap"] / 4


def _exact_layer(cfg: dict, fault=None, swap=None, phase=None):
    """A stand-in for the fused layer that is exact: decrypt, the plain
    conv + BN + ReLU, encrypt, each side in its block's layout (block 1
    on the 16² grid, block 2 on the 8² grid).  A ``StrConv`` call (half
    pack_pos) keeps y[p::2, p::2] (p the kind's stride phase, or
    `phase`) at that half's channels of block 2.  With `swap` h, the
    call of half h returns the other half's output.  fault(i, ct_in,
    out) may replace the output of call i."""
    m = _model(cfg)
    n = m.n
    n0 = cfg["num_blc"][0]
    trans = m.layers[n0]
    p = m.layers[n0]["stride_phase"] if phase is None else phase
    calls = []

    def layer(ctx, btps, ct_in, ker_in, bn_a, bn_b, alpha, pow_, in_wid,
              kp_wid, ker_wid, real_ib, real_ob, norm, pack_pos, step,
              n_iter, log_sparse, kind, maps, debug_hook=None, on_stage=None):
        in_blk = [b[0] for b in m.blocks].index(in_wid)
        ker = np.reshape(ker_in, (ker_wid, ker_wid, real_ib, real_ob))
        half = None
        if kind == "StrConv":
            half = pack_pos if swap != pack_pos else 1 - pack_pos
            sl = m.calls[n0 + half][1]
            ker, bn_a, bn_b = (trans["ker"][..., sl], trans["a"][sl],
                               trans["b"][sl])
        w, nm, raw = m.blocks[in_blk]
        cfs = ctx.decrypt_decode_coeffs(ct_in)
        x = cfs[common.layout_index(n, w, nm, raw, real_ib)]
        y = plain.relu(plain.conv_bn(x, ker, bn_a, bn_b, plain.rounder(None)))
        out_blk = in_blk + (half is not None)
        w, nm, raw = m.blocks[out_blk]
        ch = np.arange(y.shape[-1])
        if half is not None:
            y = y[p::2, p::2][:raw, :raw]
            ch = m.calls[n0 + half][3]
        out = np.zeros(n)
        out[common.layout_index(n, w, nm, raw, int(ch.max()) + 1)[..., ch]] = y
        ct = ctx.encrypt(ctx.encoder.encode_coeffs(out, ctx.params.scale, 1))
        calls.append(kind)
        return fault(len(calls) - 1, ct_in, ct) if fault else ct
    return layer


def _image_run(monkeypatch, logits_fault=None, **stand_in) -> dict:
    from optimal_conv_tpu_torch.models import imagenet as prog
    cell = _cell()
    monkeypatch.setattr(prog, "eval_conv_bn_relu",
                        _exact_layer(cell["config"], **stand_in))
    if logits_fault:
        real = prog.ImagenetFinalFastRunner.logits_head
        monkeypatch.setattr(prog.ImagenetFinalFastRunner, "logits_head",
                            lambda self, *a: logits_fault(real(self, *a)))
    rec = run.measure(cell, SEED, 0.1, False, device="cpu")
    rec["correct"] = run.result(cell, rec, False, 1, "cpu")["correct"]
    return rec


def test_image_sound_run_is_correct(monkeypatch):
    rec = _image_run(monkeypatch)
    assert rec["correct"] and rec["compared"]["gap"] < 1e-3


@pytest.mark.parametrize("half", [0, 1])
def test_transition_half_swapped_is_not_correct(monkeypatch, half):
    """The call of one ``StrConv`` half returns the other half's output:
    its own channels are missing, the other's doubled."""
    rec = _image_run(monkeypatch, swap=half)
    assert not rec["correct"] and rec["failed"] == rec["attempted"]


def test_stride_phase_read_as_zero_is_not_correct(monkeypatch):
    """The transition keeps y[2i, 2j], the sparse tail's samples, where
    the plain model keeps y[2i+1, 2j+1]."""
    rec = _image_run(monkeypatch, phase=0)
    assert not rec["correct"] and rec["failed"] == rec["attempted"]


def test_image_answer_altered_is_not_correct(monkeypatch):
    """A logit altered where it is produced, by a tenth of 2^pow."""
    def alter(logits):
        logits = logits.copy()
        logits[1] += 0.1 * 2.0 ** 4
        return logits
    rec = _image_run(monkeypatch, logits_fault=alter)
    assert not rec["correct"] and rec["failed"] == rec["attempted"]


@pytest.mark.parametrize("name", ["imagenet_final_fast", MINI])
def test_torch_reference_equals_the_numpy_one(name):
    """``plain_torch.forward`` against ``plain.forward`` on the kind's
    seeded weights and inputs, stride phase 1: every pre-activation,
    activation and logit within 1e-12 of its largest magnitude."""
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
    m = _model(_config("imagenet_final_fast"), 2 ** 33 + 1)
    limit = common.load_json(common.HERE / "limits" / f"{CELL}.json")["gap"]
    outs = [m.reference(m.image(i)) for i in (1, 2, 3)]
    for (_, a1, _), (_, a2, _) in itertools.combinations(outs, 2):
        layers = max(np.abs(a1[li][..., sl] - a2[li][..., sl]).max()
                     / 2.0 ** m.pows[li] for li, sl, _, _ in m.calls)
        assert layers > 5 * limit


def test_control_fails_the_cell():
    """The reference in the precision below the configuration's, in the
    program's place at the cell's own sizes, comes out not correct."""
    out = control.result(common.cell(CELL), 2 ** 33 + 31, 0.5, "cpu")
    assert out["correct"] is False, out["compared"]
    assert out["attempted"] >= 1


def test_transition_and_repack_readers_in_the_traced_pass(monkeypatch):
    """The traced pass through the real fused layer at the mini (the
    bootstrapper and the ReLU stubbed; spans recorded under
    ``collect()`` where the card's run has the profiler):
    ``strconv_transition_ms.image`` reads the one ``transition`` span,
    which holds both halves' layer spans; ``repack_rots.image`` reads
    the rotations of both halves' single-stage repacks in both calls;
    ``pack_ks.image`` the sum over every conv of its plaintexts less
    one."""
    import time

    from optimal_conv_tpu_torch.models import imagenet as prog
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
    assert [r["attrs"] for r in trans] == [dict(kind="StrConv", halves=2)]
    inside = [r for r in spans if r["parent"] == trans[0]["id"]]
    assert [(r["name"], r["attrs"]["kind"]) for r in inside] == [
        ("layer", "StrConv")] * 2
    assert metrics["strconv_transition_ms.image"]["value"] == pytest.approx(
        (trans[0]["t1"] - trans[0]["t0"]) / 1e6)
    from optimal_conv_tpu_torch.ckks import params as prm
    pc = dict(cell["config"]["params"])
    params = getattr(prm, pc.pop("preset"))(**pc)
    maps = prog.ImagenetFinalFastRunner(SimpleNamespace(params=params), 3,
                                        {}, (1, 1)).str_maps
    assert metrics["repack_rots.image"]["value"] == sum(
        len(lm.r_idx) + len(lm.r_idx_l) for lm in maps)
    # C = max_batch / norm plaintexts a conv (logN 9: 2 slots a position
    # on the 16² grid, 8 on the 8² grid; norm 1)
    n0, n1 = cell["config"]["num_blc"]
    cs = [2] * (n0 + 2) + [8] * (n1 + 1)
    assert metrics["pack_ks.image"]["value"] == sum(c - 1 for c in cs)
    assert metrics["low_half_ms.image"]["value"] > 0
