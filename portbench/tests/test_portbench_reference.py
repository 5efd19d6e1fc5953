"""The plain reference and the yardstick: independent of the program,
frozen numbers recomputed, inputs that the output depends on, and the
control (the reference in the precision below the configuration's) not
correct in every cell."""

import ast
import itertools
import json
import subprocess
import sys

import numpy as np
import pytest

from portbench import common, control
from portbench.models import imagenet_tail, resnet_sparse

PROGRAM = {"optimal_conv_tpu_torch", "optimal_conv_tpu", "jax", "jaxlib",
           "flax"}


def test_reference_imports_nothing_of_the_program():
    for path in (common.HERE / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            assert not {n.split(".")[0] for n in names} & PROGRAM, path
    code = ("import sys, numpy as np; sys.path.insert(0, %r)\n"
            "from portbench.reference import plain\n"
            "lay = [dict(ker=np.ones((3, 3, 2, 2)), a=np.ones(2), b=np.zeros(2))]\n"
            "plain.forward(lay, np.ones((4, 4, 2)), np.ones((2, 3)), np.zeros(3),"
            " 'bfloat16')\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))"
            % str(common.ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True).stdout
    assert not set(json.loads(out.replace("'", '"'))) & PROGRAM


@pytest.mark.parametrize("log_n", [10, 16])
def test_ntt_row_bound_from_n(log_n):
    ys = common.yardstick()
    n = 1 << log_n
    rate = 64 * 132 * 1.98e9                 # int32 slots a second
    for inverse, slots in ((False, 20), (True, 19)):
        want = max(16 * n / 3.35e12, n / 2 * log_n * slots / rate)
        assert common.ntt_row_seconds(ys, log_n, inverse) == pytest.approx(
            want, rel=1e-12)
    # at logN 16 a row is bound by its butterflies, not its bytes
    if log_n == 16:
        assert common.ntt_row_seconds(ys, 16, False) == pytest.approx(
            32768 * 16 * 20 / rate)
    assert common.modmul_per_s(ys) == pytest.approx(rate / 17)


def test_modmul_work_from_counters():
    counters = {"ntt_fwd": {2: 3}, "ntt_inv": {1: 1}, "mont_mul": {4: 5},
                "mxu_fwd": {1: 2}, "d1_regen": {6: 9}}
    n = 1 << 16
    want = (6 + 1 + 2) * (n // 2) * 16 + 20 * n
    assert common.modmul_work(counters, 16) == want


def _model(name, seed):
    cfg = common.load_json(common.HERE / "configs" / f"{name}.json")
    kind = resnet_sparse if cfg["model"] == "resnet_sparse" else imagenet_tail
    return kind.Model(cfg, seed, "cpu")


@pytest.mark.parametrize("seed", [0, 2 ** 33 + 1])
@pytest.mark.parametrize("name", ["resnet20_cifar10", "imagenet_tail"])
def test_outputs_depend_on_the_image(name, seed):
    """What the image cells compare for each image depends on the image:
    every image keeps all its fused layers' outputs, and those of any two
    seeded inputs differ by over five times the limit (``random_weights``'
    plain logits lie 7.1e-11 apart).  The ImageNet tail's logits alone
    differ by more than the limit; ResNet-20's do not (a deep random ReLU
    stack draws the logits of unrelated inputs together), which is why
    each image's layers are compared beside its logits."""
    m = _model(name, seed)
    limit = common.load_json(
        common.HERE / "limits" / f"{name}.image.json")["gap"]
    outs = [m.reference(m.image(i)) for i in (1, 2, 3)]
    for (_, a1, l1), (_, a2, l2) in itertools.combinations(outs, 2):
        layers = max(np.abs(a1[li][..., sl] - a2[li][..., sl]).max()
                     / 2.0 ** m.pows[li] for li, sl, _, _ in m.calls)
        assert layers > 5 * limit
        if name == "imagenet_tail":
            assert np.abs(l1 - l2).max() / 2.0 ** m.logit_pow > limit


@pytest.mark.parametrize("workload,seeds", [
    ("resnet20_cifar10.image", [31, 32, 33]),
    ("resnet20_cifar10.conv", [31, 32, 33]),
    ("imagenet_tail.image", [31])])
def test_control_fails_every_cell(workload, seeds):
    """The reference in the precision below the configuration's, put in
    the program's place at the cell's own sizes and driven through the
    harness's set-up, window and check, comes out not correct."""
    cell = common.cell(workload)
    for seed in seeds:
        out = control.result(cell, seed, 0.5, "cpu")
        assert out["correct"] is False, (seed, out["compared"])
        assert out["attempted"] >= 1
