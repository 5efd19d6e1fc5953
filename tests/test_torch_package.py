"""Package boundaries of the port: no JAX, explicit devices, and the CPU
path of the CUDA wrappers."""

import ast
import inspect
import os
import re
import subprocess
import sys

import pytest
import torch

from optimal_conv_tpu_torch.ckks.context import CkksContext
from optimal_conv_tpu_torch.ckks.params import tiny_params
from optimal_conv_tpu_torch.core import cuda_lib, ntt_kernel
from optimal_conv_tpu_torch.core.ntt import NttContext
from optimal_conv_tpu_torch.device import resolve_device

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODULES = ["optimal_conv_tpu_torch", "optimal_conv_tpu_torch.cli",
           "optimal_conv_tpu_torch.interop", "optimal_conv_tpu_torch.device",
           "optimal_conv_tpu_torch.ops.conv",
           "optimal_conv_tpu_torch.ops.relu",
           "optimal_conv_tpu_torch.ops.pipeline",
           "optimal_conv_tpu_torch.ops.repack",
           "optimal_conv_tpu_torch.ops.baseline",
           "optimal_conv_tpu_torch.compare",
           "optimal_conv_tpu_torch.ckks.polyeval",
           "optimal_conv_tpu_torch.ckks.bootstrap",
           "optimal_conv_tpu_torch.ckks.dft",
           "optimal_conv_tpu_torch.utils.mont_bench",
           "optimal_conv_tpu_torch.utils.bl_range",
           "optimal_conv_tpu_torch.models.resnet",
           "optimal_conv_tpu_torch.models.imagenet",
           "optimal_conv_tpu_torch.utils.timing",
           "optimal_conv_tpu_torch.core.rns",
           "optimal_conv_tpu_torch.core.threefry",
           "optimal_conv_tpu_torch.core.d1_kernel",
           "optimal_conv_tpu_torch.parallel.sharding",
           "optimal_conv_tpu_torch.parallel.limbs",
           "optimal_conv_tpu_torch.parallel.coeffs"]

# The suite runs in several pytest workers at once; PyTorch's intra-op
# threads on top of them oversubscribe the cores (a 4 s test took 490 s
# under six workers), so each worker keeps one.
torch.set_num_threads(1)


def test_import_pulls_in_no_jax():
    code = (
        "import importlib, sys\n"
        f"for m in {MODULES!r}: importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'optimal_conv_tpu', 'triton')]\n"
        "from optimal_conv_tpu_torch.core import cuda_lib\n"
        "print(bad, cuda_lib._lib is None)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[] True", out.stdout


def _py_files():
    pkg = os.path.join(ROOT, "optimal_conv_tpu_torch")
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for base, _, names in os.walk(pkg):
        out += [os.path.join(base, n) for n in names if n.endswith(".py")]
    return out


def test_no_module_of_the_port_names_jax_or_reads_the_environment():
    """Every source file of the port and ``chip_smoke.py``: no import of
    jax or of the JAX package, and no ``os.environ`` in the modules of the
    bootstrapper and the fused layer (their options are arguments)."""
    files = _py_files()
    assert len(files) > 25
    for path in files:
        tree = ast.parse(open(path).read())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for name in names:
                assert name.split(".")[0] not in ("jax", "jaxlib",
                                                  "optimal_conv_tpu"), \
                    f"{path} imports {name}"
    for rel in ("ckks/bootstrap.py", "ckks/dft.py", "ops/pipeline.py",
                "ops/repack.py"):
        src = open(os.path.join(ROOT, "optimal_conv_tpu_torch", rel)).read()
        assert "environ" not in src and "getenv" not in src, rel


@pytest.mark.parametrize("name", ["ckks.dft", "ops.repack", "models.plain"])
def test_copied_numpy_module_equals_its_original(name):
    """``ckks/dft.py``, ``ops/repack.py`` and ``models/plain.py`` are copies
    of the JAX package's numpy-only modules: the same functions and classes
    with the same source, but for the paths of the Go sources in comments
    and docstrings."""
    import importlib

    ours = importlib.import_module(f"optimal_conv_tpu_torch.{name}")
    theirs = importlib.import_module(f"optimal_conv_tpu.{name}")

    def functions(mod):
        """{name: function or class}, the cached ones by what they wrap."""
        fns = {k: getattr(v, "__wrapped__", v) for k, v in vars(mod).items()}
        return {k: f for k, f in fns.items()
                if (inspect.isfunction(f) or inspect.isclass(f))
                and f.__module__ == mod.__name__}

    a, b = functions(ours), functions(theirs)
    assert sorted(a) == sorted(b) and len(a) >= 7
    for k in a:
        # the original cites the Go sources by an absolute path
        assert inspect.getsource(a[k]) == \
            re.sub(r"/\w+/reference/", "", inspect.getsource(b[k])), k


def test_cuda_request_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    with pytest.raises(RuntimeError):
        CkksContext(tiny_params(10, 1), "cuda")
    assert resolve_device("cpu") == torch.device("cpu")


def test_cpu_tensor_takes_plain_ntt():
    p = tiny_params(10, 1)
    ctx = NttContext(p.moduli, p.log_n, torch.device("cpu"))
    a = torch.arange(2 * p.n, dtype=torch.int64).reshape(2, p.n)
    fwd, inv = ntt_kernel.STATS_FWD, ntt_kernel.STATS_INV
    calls = fwd.plain_calls, inv.plain_calls
    assert torch.equal(ctx.intt(ctx.ntt(a)), a)
    assert fwd.launches == inv.launches == 0
    assert (fwd.plain_calls, inv.plain_calls) == (calls[0] + 1, calls[1] + 1)
    with pytest.raises(ValueError):
        ntt_kernel.ntt_cuda(a, torch.zeros(2, dtype=torch.int32), ctx.q_vec,
                            ctx.qinv_vec, ctx.psi_br, ctx.n_inv, p.log_n, False)
    assert cuda_lib._lib is None


def test_cli_conv_on_cpu(capsys):
    """`conv 3 0 1 --no-bl` through the CLI entry point, on the CPU plain
    path: the paper's method alone, logN=16 on the fork chain, precision
    printed like the reference's.  Every option of the JAX CLI is ported:
    nothing is left waiting."""
    from optimal_conv_tpu_torch import cli

    assert cli.main(["conv", "3", "0", "1", "--no-bl", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "logN=16" in out and "Conv (with BN) done" in out
    assert "Ours start." in out and "Base Line start." not in out
    avg = float(out.split("prec (log2): avg")[1].split()[0])
    assert avg > 24.0, out
    assert " bits: " in out                 # the cumulative distribution
    assert not hasattr(cli, "MISSING")
    for flag in ("--fast", "--no-bl", "--debug", "cf100"):
        assert flag in cli.__doc__


def test_cli_conv_relu_needs_its_device(monkeypatch):
    """convReLU is wired to the fused layer; without a card and without
    ``--device cpu`` it fails at once instead of moving to the CPU."""
    from optimal_conv_tpu_torch import cli

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        cli.main(["convReLU", "3", "0", "1"])
    with pytest.raises(SystemExit, match="kernel width"):
        cli.main(["convReLU", "4", "0", "1", "--device", "cpu"])
