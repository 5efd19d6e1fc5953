"""Inputs and weights come from the seed alone: the same seed gives the
same ones, another seed others; seeds past 32 bits work."""

import numpy as np
import pytest

from portbench import common
from portbench.models import imagenet_tail, resnet_sparse

BIG = 2 ** 33 + 12345


def _cfg(name):
    return common.load_json(common.HERE / "configs" / f"{name}.json")


@pytest.mark.parametrize("seed", [0, 7, BIG])
def test_inputs_repeat_by_seed(seed):
    a = common.uniform_input((5, 5, 3), seed, 4)
    b = common.uniform_input((5, 5, 3), seed, 4)
    assert np.array_equal(a, b)
    assert not np.array_equal(a, common.uniform_input((5, 5, 3), seed + 1, 4))
    assert not np.array_equal(a, common.uniform_input((5, 5, 3), seed, 5))
    assert np.abs(a).max() <= 1.0


@pytest.mark.parametrize("seed", [3, BIG])
def test_weights_repeat_by_seed(seed):
    cfg = _cfg("resnet20_cifar10")
    shapes = [(3, 3, 16), (3, 16, 32)]
    a = common.draw_weights(shapes, cfg, seed, "cpu")
    b = common.draw_weights(shapes, cfg, seed, "cpu")
    c = common.draw_weights(shapes, cfg, seed + 1, "cpu")
    assert np.array_equal(a[0][1]["ker"], b[0][1]["ker"])
    assert np.array_equal(a[1], b[1]) and np.array_equal(a[2], b[2])
    assert not np.array_equal(a[0][1]["ker"], c[0][1]["ker"])
    lo, hi = cfg["weights"]["bn_a"]
    assert lo <= a[0][0]["a"].min() and a[0][0]["a"].max() <= hi
    assert a[0][1]["ker"].shape == (3, 3, 16, 32)


@pytest.mark.parametrize("kind,name", [(resnet_sparse, "resnet20_cifar10"),
                                       (imagenet_tail, "imagenet_tail")])
def test_model_inputs_in_the_bootstrapper_range(kind, name):
    """The same seed gives the same model inputs; every layer's plain
    |pre-activation| stays inside the bootstrapper's range (under 2^pow)
    on the inputs a run sends."""
    m = kind.Model(_cfg(name), BIG, "cpu")
    m2 = kind.Model(_cfg(name), BIG, "cpu")
    assert np.array_equal(m.image(3), m2.image(3))
    for i in range(3):
        pres, _, _ = m.reference(m.image(i))
        peak = max(np.abs(p).max() / 2.0 ** w for p, w in zip(pres, m.pows))
        assert 0.1 < peak < 0.7, (i, peak)
    assert len(m.calls) == (19 if name == "resnet20_cifar10" else 8)
