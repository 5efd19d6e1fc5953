"""The port's polynomial evaluation and minimax ReLU (CPU, plain versions).

Against the JAX package, bit for bit: the same input ciphertext and the
JAX context's relinearisation keys at every level go through
``evaluate_poly`` (tight and not) and ``evaluate_chebyshev`` in both
packages.  The result's residues are compared with ``np.array_equal``
and, for every intermediate ciphertext either evaluator produced, its
operation, level and scale with ``==``: one different rounding of a
scale gives a different integer constant while the decrypted values
still look right.

At decrypt level, the port alone: ``eval_relu`` on a 45-bit chain with
the bars of the JAX package's own test, and on the production chain's
eleven 30-bit ReLU levels at logN 10.
"""

import numpy as np
import pytest
import torch

from optimal_conv_tpu.ckks import polyeval as jpoly
from optimal_conv_tpu.ckks.context import CkksContext as JaxContext
from optimal_conv_tpu.ckks.params import CkksParams as JaxParams
from optimal_conv_tpu.ops import relu as jrelu

from optimal_conv_tpu_torch import interop
from optimal_conv_tpu_torch.ckks import polyeval as tpoly
from optimal_conv_tpu_torch.ckks.context import CkksContext
from optimal_conv_tpu_torch.ckks.params import CkksParams, boot_params
from optimal_conv_tpu_torch.ckks.types import Ciphertext
from optimal_conv_tpu_torch.ops import relu as trelu

CPU = torch.device("cpu")
# just long enough: a degree-15 Chebyshev fit takes four levels for the
# powers and one more for either the domain map or the leaf constants
SPEC = dict(log_n=8, logq=(50,) + (30,) * 5, logp=(55, 55), log_scale=30, h=32)
SEED = 33

# The suite runs in several pytest workers at once; PyTorch's intra-op
# threads on top of them oversubscribe the cores (a 4 s test took 490 s
# under six workers), so each worker keeps one.
torch.set_num_threads(1)


class Recorder:
    """A context that notes (method, level, scale) of every ciphertext
    its evaluator methods return."""

    def __init__(self, ctx):
        self._ctx = ctx
        self.log = []

    def __getattr__(self, name):
        attr = getattr(self._ctx, name)
        if not callable(attr):
            return attr

        def call(*args, **kw):
            out = attr(*args, **kw)
            if hasattr(out, "c0"):
                self.log.append((name, out.level, out.scale))
            return out

        return call


@pytest.fixture(scope="module")
def pair():
    jctx = JaxContext(JaxParams(**SPEC), seed=SEED)
    tctx = CkksContext(CkksParams(**SPEC), CPU, seed=SEED)
    return jctx, tctx


def _inputs(jctx, tctx, x, level):
    scale = jctx.params.scale
    jct = jctx.encrypt(jctx.encoder.encode_slots(x, scale, level))
    tct = interop.ciphertext_from_arrays(tctx, np.asarray(jct.c0),
                                         np.asarray(jct.c1), level, jct.scale)
    return jct, tct


def _both(pair, x, level, jfn, tfn):
    """Run jfn on the JAX context, carry its keys across, run tfn on the
    port; → (port result, JAX result), after comparing the two logs."""
    jctx, tctx = pair
    jct, tct = _inputs(jctx, tctx, x, level)
    jrec, trec = Recorder(jctx), Recorder(tctx)
    want = jfn(jrec, jct)
    interop.load_switching_keys(tctx, {
        key: (np.asarray(swk.d0), np.asarray(jctx.swk_d1(swk)))
        for key, swk in jctx._swk_cache.d.items()})
    got = tfn(trec, tct)
    assert trec.log == jrec.log and len(trec.log) > 5
    assert got.level == want.level and got.scale == want.scale
    assert np.array_equal(interop.to_numpy(got.c0), np.asarray(want.c0))
    assert np.array_equal(interop.to_numpy(got.c1), np.asarray(want.c1))
    return got, want


@pytest.mark.parametrize("tight", [False, True])
def test_evaluate_poly_sign1_bit_exact(pair, tight):
    x = np.random.default_rng(1).uniform(-1, 1, 128)
    got, _ = _both(
        pair, x, 5,
        lambda c, ct: jpoly.evaluate_poly(c, ct, jrelu.SIGN_POLY_1, tight=tight),
        lambda c, ct: tpoly.evaluate_poly(c, ct, trelu.SIGN_POLY_1, tight=tight))
    assert got.level == 5 - 3 - (0 if tight else 1)
    # the values: 2e-3, the bar of the JAX package's degree-7 test
    want = np.polyval(trelu.SIGN_POLY_1[::-1], x)
    np.testing.assert_allclose(pair[1].decrypt_decode_slots(got).real, want,
                               atol=2e-3)


def test_evaluate_poly_general_and_scale_target_bit_exact(pair):
    """A dense degree-6 polynomial with a constant term, toward a scale
    that is not the parameter scale."""
    coeffs = np.random.default_rng(2).uniform(-1, 1, 7)
    x = np.random.default_rng(3).uniform(-0.9, 0.9, 128)
    target = 2.0**30 * 1.37
    got, _ = _both(
        pair, x, 5,
        lambda c, ct: jpoly.evaluate_poly(c, ct, coeffs, target),
        lambda c, ct: tpoly.evaluate_poly(c, ct, coeffs, target))
    assert got.scale == target
    np.testing.assert_allclose(pair[1].decrypt_decode_slots(got).real,
                               np.polyval(coeffs[::-1], x), atol=2e-3)


@pytest.mark.parametrize("tight,a,b", [(False, -1.0, 1.0), (True, -2.0, 2.0)])
def test_evaluate_chebyshev_deg15_bit_exact(pair, tight, a, b):
    """On [-1, 1] the input is T_1 itself; on [-2, 2] the domain map takes
    a level of its own, and the tight form gives it back at the leaves."""
    f = lambda t: np.sin(1.5 * t)                              # noqa: E731
    cheb = np.polynomial.chebyshev.Chebyshev.interpolate(f, 15, domain=[a, b])
    x = np.random.default_rng(4).uniform(a, b, 128)
    got, _ = _both(
        pair, x, 5,
        lambda c, ct: jpoly.evaluate_chebyshev(c, ct, cheb.coef, a, b,
                                               tight=tight),
        lambda c, ct: tpoly.evaluate_chebyshev(c, ct, cheb.coef, a, b,
                                               tight=tight))
    assert got.level == 0
    if not tight:
        # 5e-3, the bar of the JAX package's Chebyshev test; the tight
        # form on 30-bit primes has no headroom for its leaf constants
        # and is held bit for bit only
        np.testing.assert_allclose(pair[1].decrypt_decode_slots(got).real, f(x),
                                   atol=5e-3)


def test_to_level_scale_bit_exact(pair):
    x = np.random.default_rng(5).uniform(-1, 1, 128)
    _, tctx = pair
    jct, tct = _inputs(*pair, x, 5)
    want = jpoly.to_level_scale(pair[0], jct, 2, 2.0**29)
    got = tpoly.to_level_scale(tctx, tct, 2, 2.0**29)
    assert (got.level, got.scale) == (want.level, want.scale) == (2, 2.0**29)
    assert np.array_equal(interop.to_numpy(got.c0), np.asarray(want.c0))
    assert tpoly.to_level_scale(tctx, got, 2, 2.0**29) is got
    with pytest.raises(ValueError):
        tpoly.to_level_scale(tctx, got, 2, 2.0**28)


def test_relu_tables_and_mirrors_match_jax():
    for name in ("SIGN_POLY_1", "SIGN_POLY_2", "SIGN_POLY_3"):
        assert np.array_equal(getattr(trelu, name), getattr(jrelu, name))
    x = np.linspace(-1, 1, 1001)
    assert np.array_equal(trelu.sign_composite_np(x), jrelu.sign_composite_np(x))
    for alpha in (0.0, 0.1):
        assert np.array_equal(trelu.relu_np(x, alpha), jrelu.relu_np(x, alpha))


def _relu_errors(ctx, level, alpha=0.0, seed=11):
    p = ctx.params
    x = np.random.default_rng(seed).uniform(-1, 1, p.slots)
    ct = ctx.encrypt(ctx.encoder.encode_slots(x, p.scale, level))
    out = trelu.eval_relu(ctx, ct, alpha=alpha)
    err = np.abs(ctx.decrypt_decode_slots(out).real - trelu.relu_np(x, alpha))
    return out, err.max(), err[np.abs(x) > 0.05].max()


def test_eval_relu_tight_45bit_chain():
    """The bars of the JAX package's own tight ReLU test on the same
    chain: 11 levels, scale within a bit of 2^30, 2e-2 everywhere, 5e-3
    where |x| > 0.05."""
    p = CkksParams(log_n=9, logq=(50,) + (45,) * 12, logp=(55, 55),
                   log_scale=30, h=64)
    ctx = CkksContext(p, CPU, seed=6)
    out, worst, interior = _relu_errors(ctx, p.max_level)
    assert out.level == p.max_level - 11
    assert abs(np.log2(out.scale) - p.log_scale) < 1.01
    assert worst < 2e-2 and interior < 5e-3


@pytest.mark.parametrize("alpha", [0.0, 0.1])
def test_eval_relu_production_chain_logn10(alpha):
    """The fork's chain from level 15: the layout allots the ReLU exactly
    eleven 30-bit levels, so it runs tight and lands on the repack level
    4.  The same bars hold there (measured 9.0e-4 / 7.8e-4 at alpha 0)."""
    p = boot_params(10)
    ctx = Recorder(CkksContext(p, CPU, seed=6))
    out, worst, interior = _relu_errors(ctx, p.boot_layout["relu"][1] - 1, alpha)
    # tight on 30-bit primes: no leaf constant is encoded at scale ~1 on a
    # power that already sits at its target level; each goes in at about
    # the next prime's size and is rescaled away
    consts = [scale for name, _, scale in ctx.log if name == "mul_const"]
    assert len(consts) == 15 and min(consts) > 2.0**58
    assert [name for name, _, _ in ctx.log].count("mul_ct") == 20
    assert isinstance(out, Ciphertext) and out.level == p.boot_layout["repack"]
    assert abs(np.log2(out.scale) - p.log_scale) < 1.01
    assert worst < 2e-2 and interior < 5e-3
