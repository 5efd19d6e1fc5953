"""The reader of ``graph_share.image``, on counters made up in the
program's recorder (``optimal_conv_tpu_torch/utils/tracing.py``) through
``collect()``."""

import importlib.util
import sys

import pytest

from optimal_conv_tpu_torch.utils import tracing

from portbench import common


def reader(name):
    path = common.HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@pytest.fixture
def fresh():
    tracing.clear()
    yield
    tracing.clear()


def test_graph_share_reads_the_image_counters(fresh, monkeypatch):
    """graph_share.image: replays over the polynomial evaluations of the
    newest image, from the counters that moved inside it; nothing where
    the image counted neither (the program before the graphs), in a conv
    cell, or without the recorder."""
    read = reader("graph_share.image")
    with tracing.collect():
        with tracing.span("image"):
            tracing.count("graph.eager")
        with tracing.span("image"):
            tracing.count("graph.replays", 3)
            tracing.count("graph.eager")
    assert read(dict(kind="image")) == pytest.approx(75.0)
    assert read(dict(kind="conv")) is None
    with tracing.collect():
        with tracing.span("image"):
            tracing.count("keys.hit")
    assert read(dict(kind="image")) is None
    monkeypatch.setitem(sys.modules, "optimal_conv_tpu_torch.utils.tracing",
                        None)
    import optimal_conv_tpu_torch.utils as utils
    monkeypatch.delattr(utils, "tracing")
    assert read(dict(kind="image")) is None
