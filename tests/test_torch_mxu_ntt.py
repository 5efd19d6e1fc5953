"""The port's four-step matrix NTT and its per-call route against the
JAX package (CPU).

Exact equality throughout: the port's tables against JAX's
``MxuNttTables`` (its signed int8 planes + 128 are the port's unsigned
ones), the plain matrix transforms against JAX's ``_mxu_fwd`` /
``_mxu_inv`` and against the port's butterfly, the route of a call
against JAX's ``_resolved_backend``, and a context on the matrix route
(or JAX's "auto" rule) against the butterfly context of the same seed,
residue for residue.
"""

import numpy as np
import pytest
import torch

from optimal_conv_tpu.core import modmath as jmm
from optimal_conv_tpu.core import mxu_ntt as jmxu
from optimal_conv_tpu.core import ntt as jntt

from optimal_conv_tpu_torch import cli
from optimal_conv_tpu_torch.ckks import context as tcontext
from optimal_conv_tpu_torch.ckks.context import CkksContext
from optimal_conv_tpu_torch.ckks.params import boot_params, tiny_params
from optimal_conv_tpu_torch.core import cuda_lib, mxu_kernel
from optimal_conv_tpu_torch.core import mxu_ntt as tmxu
from optimal_conv_tpu_torch.core import ntt as tntt
from optimal_conv_tpu_torch.core import ntt_kernel
from optimal_conv_tpu_torch.parallel import sharding as shd
from optimal_conv_tpu_torch.parallel.coeffs import CoeffShardedContext

CPU = torch.device("cpu")
# the moduli of tests/test_mxu_ntt.py: byte widths 8, 6, 4, 7, 8
SIZES = [60, 45, 30, 55, 61]

# The suite runs in several pytest workers at once; PyTorch's intra-op
# threads on top of them oversubscribe the cores (a 4 s test took 490 s
# under six workers), so each worker keeps one.
torch.set_num_threads(1)


def _rand(mods, n, rng, lead=()):
    return np.stack([rng.integers(0, q, size=lead + (n,), dtype=np.uint64)
                     for q in mods], axis=-2)


def _t(x):
    return torch.from_numpy(np.array(x, copy=True).view(np.int64))


def _u(t):
    return t.numpy().view(np.uint64)


@pytest.fixture(scope="module", params=[10, 12], ids=["logN10", "logN12"])
def both(request):
    """(log_n, moduli, JAX NttContext, JAX MxuNttTables, the port's
    NttContext on the matrix route)."""
    log_n = request.param
    mods = jmm.gen_ntt_primes(log_n, SIZES)
    jctx = jntt.NttContext(mods, log_n)
    return (log_n, mods, jctx, jmxu.MxuNttTables(mods, log_n, jctx.psi),
            tntt.NttContext(mods, log_n, CPU, backend="mxu"))


def test_tables_equal_jax(both):
    """Every table: the planes byte for byte (JAX's int8 planes hold
    byte − 128), the Montgomery twiddles, the recombination constants and
    the byte widths."""
    log_n, mods, _, jt, tctx = both
    tt = tctx.mxu_tables()
    assert (tt.A, tt.B) == (jt.A, jt.B)
    for mine, theirs in ((tt.w1, jt.w1_b), (tt.w2, jt.w2_b),
                         (tt.iv2, jt.iv2_b), (tt.iv1, jt.iv1_b)):
        want = (theirs.astype(np.int16) + 128).astype(np.uint8)
        assert mine.dtype == torch.uint8
        assert np.array_equal(mine.numpy(), want)
    assert np.array_equal(_u(tt.t_mont), jt.t_mont)
    assert np.array_equal(_u(tt.it_mont), jt.it_mont)
    for mine, theirs in ((tt.r1, jt.r1), (tt.c40, jt.c40), (tt.c80, jt.c80)):
        assert np.array_equal(_u(mine), theirs.reshape(-1))
    assert tt.nbytes == jt.nbytes == [8, 6, 4, 7, 8]


def test_plain_equals_jax_and_butterfly(both):
    """The plain forward and inverse, each row at its own byte width and
    at JAX's uniform 8 planes, against JAX's ``_mxu_fwd`` / ``_mxu_inv``
    and the port's butterfly; the round trip gives the input back."""
    log_n, mods, jctx, jt, tctx = both
    idx = tuple(range(len(mods)))
    a = _rand(mods, 1 << log_n, np.random.default_rng(0))
    q, qinv = jctx.tabs(idx)[:2]
    g = jt.group(idx)
    want = np.asarray(jmxu._mxu_fwd(a, g[0], g[1], g[2], g[3], g[4], g[10],
                                    g[11], g[12], q, qinv, log_n, log_n - 8))
    tt = tctx.mxu_tables()
    got = tmxu.mxu_fwd_plain(_t(a), idx, tt)
    assert np.array_equal(_u(got), want)
    assert np.array_equal(_u(tmxu.mxu_fwd_plain(_t(a), idx, tt, nb=8)), want)
    butterfly = tntt.NttContext(mods, log_n, CPU)
    assert torch.equal(got, butterfly.ntt(_t(a), idx))
    assert torch.equal(tctx.ntt(_t(a), idx), got)
    back = np.asarray(jmxu._mxu_inv(want, g[5], g[6], g[7], g[8], g[9], g[10],
                                    g[11], g[12], q, qinv, log_n, log_n - 8))
    assert np.array_equal(back, a)
    for nb in (None, 8):
        assert np.array_equal(_u(tmxu.mxu_inv_plain(got, idx, tt, nb=nb)), a)
    assert torch.equal(tctx.intt(got, idx), butterfly.intt(got, idx))


def test_batched_subset():
    """Limbs (3, 1) of a batch of two (``idx`` not starting at 0), as
    tests/test_mxu_ntt.py's subset case, both ways; a byte width below a
    limb's own is refused."""
    log_n = 10
    mods = jmm.gen_ntt_primes(log_n, [60, 45, 30, 55])
    jctx = jntt.NttContext(mods, log_n)
    jt = jmxu.MxuNttTables(mods, log_n, jctx.psi)
    idx = (3, 1)
    rng = np.random.default_rng(1)
    a = np.stack([_rand([mods[i] for i in idx], 1 << log_n, rng)
                  for _ in range(2)])
    q, qinv = jctx.tabs(idx)[:2]
    g = jt.group(idx)
    want = np.asarray(jmxu._mxu_fwd(a, g[0], g[1], g[2], g[3], g[4], g[10],
                                    g[11], g[12], q, qinv, log_n, log_n - 8))
    tctx = tntt.NttContext(mods, log_n, CPU, backend="mxu")
    got = tctx.ntt(_t(a), idx)
    assert np.array_equal(_u(got), want)
    back = np.asarray(jmxu._mxu_inv(want, g[5], g[6], g[7], g[8], g[9], g[10],
                                    g[11], g[12], q, qinv, log_n, log_n - 8))
    assert np.array_equal(_u(tctx.intt(got, idx)), back)
    assert np.array_equal(back, a)
    with pytest.raises(ValueError):
        tmxu.mxu_fwd_plain(_t(a), idx, tctx.mxu_tables(), nb=6)


def _jax_route(backend: str, log_n: int, limbs: int) -> str:
    """JAX's rule (``NttContext._resolved_backend``) on a bare context: its
    tables at logN 16 are not needed to ask it."""
    ctx = jntt.NttContext.__new__(jntt.NttContext)
    ctx.backend, ctx.log_n = backend, log_n
    got = ctx._resolved_backend(tuple(range(limbs)))
    return "mxu" if got in ("mxu", "mxu_scan") else "butterfly"


@pytest.fixture(scope="module")
def chain_contexts():
    """The port's NttContext on 13 limbs of the fork chain, by (backend,
    log_n)."""
    mods = boot_params(16).moduli[:13]
    return {(b, ln): tntt.NttContext(mods, ln, CPU, backend=b)
            for b in tntt.BACKENDS for ln in (12, 14, 16)}


@pytest.mark.parametrize("log_n", [12, 14, 16])
@pytest.mark.parametrize("backend,jax_backend",
                         [("auto", "auto"), ("mxu", "mxu"),
                          ("butterfly", "xla")])
def test_route_equals_jax(chain_contexts, log_n, backend, jax_backend):
    """Each call's route for 1, 12 and 13 limbs: the butterfly stands for
    JAX's xla / xla_loop schedules."""
    ctx = chain_contexts[(backend, log_n)]
    for limbs in (1, 12, 13):
        assert ctx.resolved_backend(tuple(range(limbs))) == _jax_route(
            jax_backend, log_n, limbs), (limbs, log_n)


def _flow(ctx):
    """encrypt at the top level → mul_ct → rescale → rotate → rescale."""
    p = ctx.params
    rng = np.random.default_rng(5)
    n = p.slots
    x = rng.uniform(-1, 1, n) + 1j * rng.uniform(-1, 1, n)
    y = rng.uniform(-1, 1, n)
    lv = p.max_level
    a = ctx.encrypt(ctx.encoder.encode_slots(x, p.scale, lv))
    b = ctx.encrypt(ctx.encoder.encode_slots(y, p.scale, lv))
    out = ctx.rescale(ctx.rotate(ctx.rescale(ctx.mul_ct(a, b)), 3))
    return out


@pytest.mark.parametrize("backend", ["mxu", "auto"])
def test_context_route_equals_butterfly(monkeypatch, backend):
    """A context at logN 10 on 13 + 2 limbs, every NTT on the matrix route
    ("mxu") or routed per call by JAX's rule ("auto", its logN threshold
    lowered to 10 so that calls over at most 12 limbs take the matrix
    route and wider ones the butterfly): every residue of
    encrypt → mul_ct → rescale → rotate → rescale equals the butterfly
    context's of the same seed."""
    p = tiny_params(10, levels=12)
    want = _flow(CkksContext(p, CPU, seed=3))
    if backend == "auto":
        monkeypatch.setattr(tntt, "MXU_MIN_LOG_N", 10)
    for s in (mxu_kernel.STATS_FWD, mxu_kernel.STATS_INV,
              ntt_kernel.STATS_FWD, ntt_kernel.STATS_INV):
        s.reset()
    got = _flow(CkksContext(p, CPU, seed=3, ntt_backend=backend))
    assert (got.level, got.scale) == (want.level, want.scale)
    assert torch.equal(got.c0, want.c0) and torch.equal(got.c1, want.c1)
    mxu_calls = (mxu_kernel.STATS_FWD.plain_calls
                 + mxu_kernel.STATS_INV.plain_calls)
    butterfly_calls = (ntt_kernel.STATS_FWD.plain_calls
                       + ntt_kernel.STATS_INV.plain_calls)
    assert mxu_calls > 0
    assert (butterfly_calls > 0) == (backend == "auto")


def test_routes_refused():
    """An unknown route, the sp context's matrix route (its NTT runs on
    column shards), a ring the matrix route does not take, and the
    kernel's wrapper on a CPU tensor (it never builds there)."""
    p = tiny_params(10, levels=2)
    with pytest.raises(ValueError, match="backend"):
        CkksContext(p, CPU, ntt_backend="pallas")
    mesh = shd.build_mesh((1, 1), sp=2)
    for backend in ("mxu", "auto"):
        with pytest.raises(ValueError, match="sp context"):
            CoeffShardedContext(p, CPU, mesh, ntt_backend=backend)
    mods = jmm.gen_ntt_primes(8, [40])
    ctx = tntt.NttContext(mods, 8, CPU, backend="mxu")
    with pytest.raises(ValueError, match="log_n"):
        ctx.ntt(torch.zeros((1, 256), dtype=torch.int64))
    ctx10 = tntt.NttContext(jmm.gen_ntt_primes(10, [40]), 10, CPU,
                            backend="mxu")
    with pytest.raises(ValueError, match="CUDA"):
        mxu_kernel.mxu_cuda(torch.zeros((1, 1024), dtype=torch.int64), (0,),
                            ctx10.mxu_tables(), False)
    assert cuda_lib._lib is None


@pytest.mark.parametrize("argv,want", [
    (["conv", "3", "0", "1", "--ntt", "mxu"], "mxu"),
    (["convReLU", "3", "0", "1", "--no-bl", "--ntt", "auto"], "auto"),
    (["resnet", "3", "8", "1", "1", "--ntt", "butterfly"], "butterfly"),
    (["conv", "3", "0", "1"], "butterfly")])
def test_cli_ntt_flag(monkeypatch, argv, want):
    """``--ntt`` reaches every context a command makes (the baseline's
    and the paper's), as OPTCONV_NTT_BACKEND does in the JAX CLI."""
    seen = []

    class Stop(Exception):
        pass

    def fake(*a, **k):
        seen.append(k.get("ntt_backend", "butterfly"))
        raise Stop

    monkeypatch.setattr(tcontext, "CkksContext", fake)
    with pytest.raises(Stop):
        cli.main(argv + ["--device", "cpu"])
    assert seen == [want]
    with pytest.raises(SystemExit, match="--ntt"):
        cli.main(["conv", "3", "0", "1", "--ntt", "xla"])
