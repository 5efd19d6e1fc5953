"""The harness end to end on the CPU at the program's miniature sizes
(ResNet-8, logN 10): the last line's shape, the modules the run loads,
and runs with the timed path broken underneath, which have to come out
not correct.  The look for a card is skipped: ``run.measure`` is called
with device "cpu"."""

import json
import subprocess
import sys

import numpy as np
import pytest

from portbench import common, run
from portbench.reference import plain

MINI = common.HERE / "tests" / "configs" / "resnet_mini.json"
SEED = 2 ** 33 + 5


def _cell(entry: str) -> dict:
    bench = common.manifest()
    real = {"image": "resnet20_cifar10.image", "conv": "resnet20_cifar10.conv"}
    cell = common.cell(real[entry], bench)
    cell["config"] = common.load_json(MINI)
    return cell


def test_result_line_shape():
    cell = _cell("conv")
    rec = run.measure(cell, SEED, 1.0, False, device="cpu")
    out = json.loads(json.dumps(run.result(cell, rec, False, 1, "cpu")))
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(out)[-1] == "compared"
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] >= 1
    assert set(out["metrics"]) == {"conv_ms_p95", "peak_gib", "setup_s"}
    for m in out["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] >= 0
    assert set(out["device"]) == {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    assert out["compared"]["conv_gap"]["limit"] == cell["limits"]["conv_gap"]


def test_runs_load_neither_jax_nor_the_jax_package():
    """A dry run's process holds no top-level jax, jaxlib, flax or
    optimal_conv_tpu module (names compared whole)."""
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import torch; torch.set_num_threads(1)\n"
            "from portbench import run, control\n"
            "from portbench.tests import test_portbench_run as t\n"
            "run.measure(t._cell('conv'), 3, 0.5, False, device='cpu')\n"
            "control.result(t._cell('image'), 3, 0.1, 'cpu')\n"
            "print(run.banned_modules())" % str(common.ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    assert out[-1] == "[]"
    assert run.BANNED >= {"jax", "optimal_conv_tpu"}
    assert "optimal_conv_tpu_torch" not in run.BANNED


def test_conv_answer_altered_is_not_correct(monkeypatch):
    """The conv's output off by a thousandth where it is produced."""
    from optimal_conv_tpu_torch.ops import conv as convops
    real = convops.eval_conv_bn

    def altered(*args, **kw):
        out = real(*args, **kw)
        return out.with_scale(out.scale * 1.001)
    monkeypatch.setattr(convops, "eval_conv_bn", altered)
    cell = _cell("conv")
    rec = run.measure(cell, SEED, 0.5, False, device="cpu")
    assert rec["failed"] == rec["attempted"] > 0
    assert not run.result(cell, rec, False, 1, "cpu")["correct"]


def _exact_layer(cfg: dict, fault=None):
    """A stand-in for the fused layer that is exact: decrypt, the plain
    conv + BN + ReLU in the runner's layout, encrypt.  fault(i, ct_in,
    out) may replace the output of call i."""
    n = 1 << cfg["params"]["log_n"]
    k = cfg["ker_wid"]
    blocks = [(w, n // (w * w) // b, w - k // 2)
              for w, b in zip(cfg["in_wids"], cfg["real_batch"])]
    calls = []

    def layer(ctx, btps, ct_in, ker_in, bn_a, bn_b, alpha, pow_, in_wid,
              kp_wid, ker_wid, real_ib, real_ob, norm, pack_pos, step,
              n_iter, log_sparse, kind, maps, debug_hook=None, on_stage=None):
        blk = cfg["in_wids"].index(in_wid)
        w, nm, raw = blocks[blk]
        cfs = ctx.decrypt_decode_coeffs(ct_in)
        x = cfs[common.layout_index(n, w, nm, raw, real_ib)]
        ker = np.reshape(ker_in, (ker_wid, ker_wid, real_ib, real_ob))
        y = plain.relu(plain.conv_bn(x, ker, bn_a, bn_b, plain.rounder(None)))
        if kind.startswith("Str"):
            blk += 1
            y = y[0::2, 0::2][: blocks[blk][2], : blocks[blk][2]]
        w, nm, raw = blocks[blk]
        out = np.zeros(n)
        out[common.layout_index(n, w, nm, raw, real_ob)] = y
        ct = ctx.encrypt(ctx.encoder.encode_coeffs(out, ctx.params.scale, 1))
        calls.append(kind)
        return fault(len(calls) - 1, ct_in, ct) if fault else ct
    return layer


def _image_run(monkeypatch, fault=None, logits_fault=None,
               seconds=0.1) -> dict:
    from optimal_conv_tpu_torch.models import resnet as prog
    cell = _cell("image")
    monkeypatch.setattr(prog, "eval_conv_bn_relu",
                        _exact_layer(cell["config"], fault))
    if logits_fault:
        real = prog.fc_conv
        monkeypatch.setattr(prog, "fc_conv",
                            lambda *a, **kw: logits_fault(real(*a, **kw)))
    rec = run.measure(cell, SEED, seconds, False, device="cpu")
    rec["correct"] = run.result(cell, rec, False, 1, "cpu")["correct"]
    return rec


def test_image_sound_run_is_correct(monkeypatch):
    rec = _image_run(monkeypatch)
    assert rec["correct"] and rec["compared"]["gap"] < 1e-3


def test_image_layer_returning_its_input_is_not_correct(monkeypatch):
    """A step that returns its state unchanged: layer 2 of every image
    hands on its input."""
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


@pytest.mark.cuda
def test_control_on_the_card_at_the_cells_sizes(card):
    """The control of every cell on the card's generator, three seeds,
    through the harness's own check."""
    from portbench import control
    for w in ("resnet20_cifar10.image", "resnet20_cifar10.conv",
              "imagenet_tail.image"):
        for seed in (41, 42, 43):
            out = control.result(common.cell(w), seed, 1.0, card)
            assert out["correct"] is False, (w, seed, out["compared"])


def test_image_stale_answer_is_not_correct(monkeypatch):
    """An answer altered where it is produced: from the window's second
    image on, the runner computes on the first window image's input, so
    every later image gets another image's layers and logits."""
    from optimal_conv_tpu_torch.models import resnet as prog
    real, seen = prog.ResNetRunner.infer, []

    def stale(self, x, *a, **kw):
        seen.append(x)
        return real(self, seen[1] if len(seen) > 2 else x, *a, **kw)
    monkeypatch.setattr(prog.ResNetRunner, "infer", stale)
    rec = _image_run(monkeypatch, seconds=1.5)
    assert rec["attempted"] >= 2
    assert not rec["correct"] and rec["failed"] == rec["attempted"] - 1


def test_setup_leaves_out_the_reference(monkeypatch):
    """The plain reference's seconds in set-up (the inputs' scale, the
    conv requests' client features) are not counted in ``setup_s``."""
    import time
    real = plain.forward

    def slow(*a, **kw):
        time.sleep(0.5)
        return real(*a, **kw)
    monkeypatch.setattr(plain, "forward", slow)
    cell = _cell("conv")
    t0 = time.perf_counter()
    rec = run.measure(cell, SEED, 0.2, False, device="cpu", t_start=t0)
    calls = 4 + cell["traffic"]["inputs_per_layer"]   # calibrate, client
    assert rec["setup_s"] + calls * 0.5 <= time.perf_counter() - t0
    assert run.result(cell, rec, False, 1, "cpu")["correct"]
