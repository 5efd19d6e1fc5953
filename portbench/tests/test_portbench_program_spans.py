"""The readers of the program's own spans and counters
(``optimal_conv_tpu_torch/utils/tracing.py``), on spans made up in the
recorder through ``collect()`` on a clock the test sets."""

import importlib.util
import sys

import pytest

from optimal_conv_tpu_torch.utils import tracing

from portbench import common

NEW = ("encode_ms.image", "poly_ms.image", "evaluator_share.image",
       "wrapper_us.image", "key_draws.image", "boot_build_s.image")


def reader(name):
    path = common.HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class Clock:
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


def _image(clock, t0, made=0):
    """One made-up image from t0 (ns): encrypt with its encode, two fused
    layers (a conv stage holding a kernel encoding of two encodes, EvalMod
    in the ctos stage, the ReLU), a head with one encode; evaluator calls
    and K1 launches tallied in the stages."""
    op = tracing.evaluator_op(lambda dt: setattr(clock, "t", clock.t + dt))
    clock.t = t0
    with tracing.span("image"):
        with tracing.span("encrypt"):
            with tracing.span("encode"):
                clock.t += 1_000_000                       # 1 ms
        for _ in range(2):
            with tracing.stages("layer", None) as mark:
                with tracing.span("encode.kernel"):
                    for _ in range(2):
                        with tracing.span("encode"):
                            clock.t += 2_000_000           # 2 ms each
                op(500_000)
                mark("conv")
                with tracing.stages(None, None) as sub:
                    op(1_000_000)
                    sub("ctos.lt0")
                    clock.t += 3_000_000
                    sub("ctos.evalmod")                    # 3 ms
                mark("ctos")
                t = tracing.stamp()
                clock.t += 4_000_000                       # 4 ms
                op(0)
                tracing.kernel_call("mont_mul", 6, t)
                mark("relu")
        for _ in range(made):
            tracing.count("keys.made")
        tracing.count("keys.d1_drawn")
        with tracing.span("head"):
            with tracing.span("encode"):
                clock.t += 5_000_000                       # 5 ms
        clock.t += 1_000_000


def test_readers_on_made_up_images(clock):
    with tracing.collect():
        _image(clock, 0, made=4)
        _image(clock, 10**9, made=2)         # the newest image is read
    img = tracing.records()[-1]
    assert img["name"] == "image"
    span_ns = img["t1"] - img["t0"]
    rec = dict(kind="image")
    # outermost encodes: 1 + 2 x (2 + 2) + 5 ms
    assert reader("encode_ms.image")(rec) == pytest.approx(14.0)
    # EvalMod 3 ms + ReLU 4 ms a layer
    assert reader("poly_ms.image")(rec) == pytest.approx(7.0)
    # evaluator time: 2 x (0.5 + 1 + 0) ms of the image
    assert reader("evaluator_share.image")(rec) == pytest.approx(
        100.0 * 3_000_000 / span_ns)
    # two K1 launches of 4 ms each
    assert reader("wrapper_us.image")(rec) == pytest.approx(4000.0)
    assert reader("key_draws.image")(rec) == 3
    tracing.count("boot.build_s", 0.25)
    assert reader("boot_build_s.image")(rec) == tracing.counters()[
        "boot.build_s"]


def test_readers_find_nothing_to_read(clock, monkeypatch):
    """No image span (or a conv cell): nothing; the program without the
    recorder (an older commit): nothing, and no error."""
    for name in NEW:
        assert reader(name)(dict(kind="conv")) is None
    for name in NEW[:-1]:
        assert reader(name)(dict(kind="image")) is None
    with tracing.collect():
        with tracing.span("image"):
            clock.t = 10
    assert reader("wrapper_us.image")(dict(kind="image")) is None
    import optimal_conv_tpu_torch.utils as utils
    monkeypatch.delattr(utils, "tracing")
    monkeypatch.setitem(sys.modules, "optimal_conv_tpu_torch.utils.tracing",
                        None)
    for name in NEW:
        assert reader(name)(dict(kind="image")) is None


def test_new_entries_have_readers_and_cells():
    bench = common.manifest()
    entries = {m["name"]: m for m in bench["per_layer"]}
    cells = {w["name"] for w in bench["workloads"]}
    for name in NEW:
        m = entries[name]
        assert (common.HERE / "metrics" / f"{name}.py").is_file()
        assert m["workloads"] and set(m["workloads"]) <= cells
        assert m["source"] in ("program_span", "program_counter")
