"""The port's span recorder and counters (``utils/tracing.py``), on the CPU.

* Spans nest: each record names its parent and its root, the root's
  counters are the ones that moved inside it, ``self_ns`` is a span's
  time outside its children, ``seq`` numbers a root's spans of a name.
* Off (no ``collect()``, no profiler) nothing is recorded while the
  counters still count; a torch profiler turns recording on.
* The buffer keeps the newest ``CAPACITY`` records.
* ``stages`` cuts stage spans at its marks and calls its hooks either
  way; an exception inside a span leaves no span open.
* Evaluator calls are tallied once at the outermost call, in the
  innermost open span; a kernel wrapper's launch likewise, by kernel;
  ``counters()`` reads every ``KernelStats``.
* One conv + BN request is a root ``conv_bn`` with its kernel encoding,
  its bias encoding and its pack as children.
"""

import contextlib

import numpy as np
import pytest
import torch

from optimal_conv_tpu_torch.ckks.context import EVALUATOR_OPS, CkksContext
from optimal_conv_tpu_torch.ckks.params import CkksParams, tiny_params
from optimal_conv_tpu_torch.core import cuda_lib
from optimal_conv_tpu_torch.ops import conv as convops
from optimal_conv_tpu_torch.utils import tracing

CPU = torch.device("cpu")
torch.set_num_threads(1)


class Clock:
    """A clock the test sets: every read returns `t`."""

    def __init__(self):
        self.t = 0

    def __call__(self):
        return self.t


@pytest.fixture
def clock(monkeypatch):
    c = Clock()
    monkeypatch.setattr(tracing, "_now", c)
    monkeypatch.setattr(tracing, "_ns", c)
    tracing.clear()
    yield c
    tracing.clear()


def _by_name(recs):
    return {r["name"]: r for r in recs}


def test_nesting_root_ids_and_self_time(clock):
    with tracing.collect():
        clock.t = 100
        with tracing.span("image", kind="x"):
            clock.t = 110
            with tracing.span("layer"):
                clock.t = 120
                with tracing.span("encode"):
                    clock.t = 150
                    tracing.count("test.nested")
                clock.t = 200
            clock.t = 210
            with tracing.span("layer"):
                clock.t = 260
            clock.t = 300
        with tracing.span("image"):
            clock.t = 310
    recs = tracing.records()
    assert [r["name"] for r in recs] == ["encode", "layer", "layer", "image",
                                         "image"]
    enc, lay0, lay1, img, img2 = recs
    assert img["parent"] == 0 and img["root"] == img["id"]
    assert lay0["parent"] == img["id"] and enc["parent"] == lay0["id"]
    assert {r["root"] for r in recs[:4]} == {img["id"]}
    assert img2["root"] == img2["id"] != img["id"]
    assert (img["t0"], img["t1"]) == (100, 300) and img["attrs"] == {
        "kind": "x"}
    assert (lay0["seq"], lay1["seq"], img["seq"]) == (0, 1, 0)
    own = tracing.self_ns(recs)
    assert own[img["id"]] == 200 - 90 - 50
    assert own[lay0["id"]] == 90 - 30 and own[enc["id"]] == 30
    # the root carries the counters that moved inside it; others do not
    assert img["counters"] == {"test.nested": 1}
    assert "counters" not in lay0 and img2["counters"] == {}
    assert tracing.tree(recs, img["id"]) == recs[:4]
    assert tracing.outermost(recs, ("layer", "encode")) == [lay0, lay1]


def test_off_records_nothing_but_counters_count(clock):
    assert not tracing.recording()
    before = tracing.counters().get("test.off", 0)
    with tracing.span("image"):
        tracing.count("test.off", 2)
        with tracing.stages("layer", None) as mark:
            mark("conv")
    assert tracing.span("x") is tracing.span("y")     # one shared no-op
    assert tracing.stamp() == 0
    assert tracing.records() == []
    assert tracing.counters()["test.off"] == before + 2


def test_profiler_turns_recording_on():
    tracing.clear()
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]):
        assert tracing.recording()
        with tracing.span("image"):
            pass
    assert not tracing.recording()
    assert [r["name"] for r in tracing.records()] == ["image"]
    tracing.clear()


def test_buffer_keeps_the_newest(clock):
    with tracing.collect():
        for i in range(tracing.CAPACITY + 5):
            with tracing.span("s", i=i):
                pass
    recs = tracing.records()
    assert len(recs) == tracing.CAPACITY
    assert recs[0]["attrs"]["i"] == 5 and recs[-1]["attrs"]["i"] == (
        tracing.CAPACITY + 4)
    tracing.clear()
    assert tracing.records() == []


def test_stages_cut_at_marks_and_call_hooks(clock):
    seen, hooked = [], []
    with tracing.collect():
        clock.t = 0
        with tracing.stages("layer", lambda n, v: seen.append((n, v)),
                            None, kind="k") as mark:
            clock.t = 10
            mark("conv", 1)
            clock.t = 15
            with tracing.stages(None, lambda n, _: hooked.append(n)) as sub:
                clock.t = 20
                sub("ctos.lt0")
                clock.t = 30
                sub("ctos.evalmod")
                clock.t = 31
            clock.t = 35
            mark("ctos", 2)
            clock.t = 50
            mark("stoc", 3)
            clock.t = 51
    recs = tracing.records()
    assert [r["name"] for r in recs] == ["conv", "ctos.lt0", "ctos.evalmod",
                                         "ctos", "stoc", "layer"]
    assert seen == [("conv", 1), ("ctos", 2), ("stoc", 3)]
    assert hooked == ["ctos.lt0", "ctos.evalmod"]
    r = _by_name(recs)
    assert (r["layer"]["t0"], r["layer"]["t1"]) == (0, 51)
    assert r["layer"]["attrs"] == {"kind": "k"}
    assert (r["conv"]["t0"], r["conv"]["t1"]) == (0, 10)
    assert (r["ctos"]["t0"], r["ctos"]["t1"]) == (10, 35)
    # a nested block's first stage starts at the block's start
    assert (r["ctos.lt0"]["t0"], r["ctos.lt0"]["t1"]) == (15, 20)
    assert r["ctos.lt0"]["parent"] == r["ctos"]["id"]
    assert (r["stoc"]["t0"], r["stoc"]["t1"]) == (35, 50)
    assert {x["parent"] for x in (r["conv"], r["ctos"], r["stoc"])} == {
        r["layer"]["id"]}


def test_exception_leaves_no_span_open(clock):
    class Stop(Exception):
        pass

    def hook(name, _):
        if name == "conv":
            raise Stop

    with tracing.collect():
        with pytest.raises(Stop):
            with tracing.span("image"):
                with tracing.stages("layer", hook) as mark:
                    with tracing.span("encode"):
                        tracing.span("left open").__enter__()
                    mark("conv")
        with tracing.span("next"):
            pass
    recs = _by_name(tracing.records())
    assert set(recs) == {"encode", "conv", "layer", "image", "next"}
    assert recs["next"]["parent"] == 0
    assert tracing._open == []


def test_evaluator_calls_counted_at_the_outermost(clock):
    calls = []

    @tracing.evaluator_op
    def inner():
        calls.append("inner")
        clock.t += 5

    @tracing.evaluator_op
    def outer():
        clock.t += 1
        inner()
        inner()

    outer()                                   # off: no tally anywhere
    with tracing.collect():
        with tracing.span("image"):
            outer()
            with tracing.span("layer"):
                inner()
            outer()
    r = _by_name(tracing.records())
    assert r["image"]["eval"] == [2, 22] and r["layer"]["eval"] == [1, 5]
    assert len(calls) == 7
    # the context's public ops are wrapped once, overrides in subclasses too
    for name in EVALUATOR_OPS:
        assert getattr(CkksContext, name).evaluator_op, name

    class Sub(CkksContext):
        def add(self, a, b):
            return super().add(a, b)
    assert Sub.add.evaluator_op and Sub.add is not CkksContext.add


def test_kernel_launches_tallied_by_kernel(clock):
    stats = cuda_lib.KernelStats("test_k")
    # a second private counter: the kernels' module-global ones are read
    # by other tests (tests/test_torch_modmath.py counts mont_mul's at 0)
    other = cuda_lib.KernelStats("test_k2")
    with tracing.collect():
        with tracing.span("image"):
            clock.t = 1000
            t0 = tracing.stamp()
            clock.t = 1007
            stats.launched(6, t0)
            stats.launched(2, t0)
            other.launched(3, tracing.stamp())
    r = _by_name(tracing.records())
    assert r["image"]["kernels"]["test_k"] == [2, 14, 8]
    assert r["image"]["kernels"]["test_k2"] == [1, 0, 3]
    assert stats.by_rows == {6: 1, 2: 1}
    c = tracing.counters()
    assert (c["kernel.test_k.launches"], c["kernel.test_k.rows"]) == (2, 8)
    assert c["kernel.test_k.plain_calls"] == 0
    stats.launched(1)                        # off: counted, no tally
    assert stats.launches == 3


def test_conv_request_is_a_conv_bn_root():
    """A conv + BN call with no span open is a root ``conv_bn``: its kernel
    encoding (one batched pass, no ``encode`` a kernel plaintext: the
    counter ``encode.kernel.pts`` counts them), the bias's encoding and
    the pack under it; the pack's Galois keys counted as made."""
    p = CkksParams(log_n=10, logq=(60, 45), logp=(61,), log_scale=30, h=64)
    ctx = CkksContext(p, CPU, seed=3)
    in_wid, ker_wid, norm = 8, 3, 2
    nch = p.n // (in_wid * in_wid) // norm
    rng = np.random.default_rng(1)
    raw = in_wid - ker_wid // 2
    img = rng.uniform(-1, 1, (raw, raw, nch))
    ker = rng.uniform(-1, 1, (ker_wid, ker_wid, nch, nch)) / 9
    ct = ctx.encrypt(ctx.encoder.encode_coeffs(
        convops.prep_input(img.ravel(), raw, in_wid, p.n, norm), p.scale, 1))
    tracing.clear()
    with tracing.collect():
        out = convops.eval_conv_bn(ctx, ct, ker.ravel(), np.ones(nch),
                                   np.zeros(nch), in_wid, ker_wid, nch, nch,
                                   norm, float(1 << 30))
    recs = tracing.records()
    root = recs[-1]
    assert root["name"] == "conv_bn" and root["parent"] == 0
    kids = [r["name"] for r in recs if r["parent"] == root["id"]]
    assert kids == ["encode.kernel", "encode", "pack"]
    kernel = _by_name(recs)["encode.kernel"]
    assert not [r for r in recs if r["parent"] == kernel["id"]]
    assert root["counters"]["encode.kernel.pts"] == nch
    assert "encode.kernel.host_pts" not in root["counters"]
    assert root["counters"]["keys.made"] == len(
        convops._pack_steps(p.log_n, p.n // (in_wid * in_wid), norm))
    assert sum(r["eval"][0] for r in recs) > 0
    got = convops.post_process(ctx.decrypt_decode_coeffs(out), raw, in_wid)
    want = convops.conv2d_same_np(img, ker)
    np.testing.assert_allclose(
        got.reshape(raw, raw, -1)[:, :, ::norm][:, :, :nch], want, atol=2e-3)
    tracing.clear()


def test_bootstrapper_family_has_no_build_seconds():
    from optimal_conv_tpu_torch.ckks.bootstrap import BootstrapperFamily
    fam = BootstrapperFamily(CkksContext(tiny_params(log_n=8, levels=1), CPU))
    assert not hasattr(fam, "build_seconds")
    assert not hasattr(cuda_lib, "build_seconds")


def test_evaluator_results_equal_on_and_off():
    """Recording changes no result: ops on two contexts of one seed give
    the same residues with the recorder on and off."""
    p = tiny_params(log_n=8, levels=3)
    outs = []
    for on in (False, True):
        ctx = CkksContext(p, CPU, seed=5)
        a = ctx.encrypt(ctx.encoder.encode_slots(
            np.random.default_rng(2).uniform(-1, 1, p.slots), p.scale,
            p.max_level))
        with (tracing.collect() if on else contextlib.nullcontext()):
            outs.append(ctx.rescale(ctx.mul_ct(ctx.rotate(a, 3), a)))
    assert torch.equal(outs[0].c0, outs[1].c0)
    assert torch.equal(outs[0].c1, outs[1].c1)
    tracing.clear()


class _Halves:
    """Stands in for a bootstrapper: CtoS hands on a fresh encryption at
    the top level, as two halves at log_sparse 0 and as one above; StoC
    one at level 1."""

    def __init__(self, ctx, log_sparse):
        self.ctx, self.ls = ctx, log_sparse

    def _fresh(self, level):
        p = self.ctx.params
        return self.ctx.encrypt(self.ctx.encoder.encode_slots(
            np.full(p.slots, 0.5), p.scale, level))

    def ctos(self, ct, on_stage=None):
        top = self.ctx.params.max_level
        return self._fresh(top), self._fresh(top) if self.ls == 0 else None

    def stoc(self, up, low, on_stage=None):
        return self._fresh(1)


@pytest.mark.parametrize("log_sparse,halves", [(0, 2), (2, 1)])
def test_fused_layer_spans_each_half(monkeypatch, log_sparse, halves):
    """A fused layer's span carries its step and the CtoS halves that go
    on; inside its relu and repack stages each half is a span
    ``relu.half`` / ``repack.half`` with its ``ul``; the stage spans are
    the five they were.  The conv and the ReLU are stubbed: the spans
    are the point, not the numbers."""
    from optimal_conv_tpu_torch.ops import pipeline
    monkeypatch.setattr(pipeline.convops, "eval_conv_bn",
                        lambda ctx, ct, *a, **kw: ct)
    monkeypatch.setattr(pipeline, "eval_relu", lambda ctx, ct, alpha: ct)
    p = tiny_params(log_n=8, levels=3)
    ctx = CkksContext(p, CPU, seed=4)
    ct = ctx.encrypt(ctx.encoder.encode_coeffs(np.zeros(p.n), p.scale, 1))
    masks = [np.ones(p.slots), np.zeros(p.slots)]
    tracing.clear()
    with tracing.collect():
        pipeline.eval_conv_bn_relu(
            ctx, {log_sparse: _Halves(ctx, log_sparse)}, ct, np.zeros(9),
            np.ones(1), np.zeros(1), 0.0, 4.0, 8, 7, 3, 1, 1, 1, 0, 2, 2,
            log_sparse, "Conv_inside", pipeline.LayerMaps(ext_idx=masks))
    recs = tracing.records()
    tracing.clear()
    layer = recs[-1]
    assert layer["name"] == "layer"
    assert layer["attrs"] == {"kind": "Conv_inside", "log_sparse": log_sparse,
                              "step": 2, "halves": halves}
    top = {r["name"]: r for r in recs if r["parent"] == layer["id"]}
    assert list(top) == ["conv", "ctos", "relu", "repack", "stoc"]
    for stage in ("relu", "repack"):
        kids = [r for r in recs if r["parent"] == top[stage]["id"]]
        assert [r["name"] for r in kids] == [f"{stage}.half"] * halves
        assert [r["attrs"]["ul"] for r in kids] == list(range(halves))
        assert all(r["eval"][0] > 0 for r in kids)
