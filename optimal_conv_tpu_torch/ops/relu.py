"""Minimax-composite ReLU on ciphertexts.

Counterpart of ``optimal_conv_tpu/ops/relu.py``: the sign function is
approximated by the composite of three odd minimax polynomials
(deg 7 ∘ deg 7 ∘ deg 13, coefficients from the paper's alpha=10 minimax
tables), then
    leakyReLU(x) = x · (b·sign(x) + a),  a = (α+1)/2, b = (1−α)/2,
with the deg-13 coefficients pre-multiplied by b and the constant a
added before the final ct×ct product.

Input domain: |x| ≤ 1 (the caller rescales by 2^-pow beforehand — the
conv stage sets out_scale = q0/2^(pow+8) so values arrive in [-1, 1]).
"""

from __future__ import annotations

import numpy as np

from ..ckks.context import CkksContext
from ..ckks.types import Ciphertext
from ..ckks.polyeval import evaluate_poly

# minimax sign-composite coefficients (odd polynomials; alpha=10 minimax
# tables), the same constants as the JAX package's
SIGN_POLY_1 = np.array([0.0, 10.8541842577442, 0.0, -62.2833925211098,
                        0.0, 114.369227820443, 0.0, -62.8023496973074])
SIGN_POLY_2 = np.array([0.0, 4.13976170985111, 0.0, -5.84997640211679,
                        0.0, 2.94376255659280, 0.0, -0.454530437460152])
SIGN_POLY_3 = np.array([0.0, 3.29956739043733, 0.0, -7.84227260291355,
                        0.0, 12.8907764115564, 0.0, -12.4917112584486,
                        0.0, 6.94167991428074, 0.0, -2.04298067399942,
                        0.0, 0.246407138926031])


def sign_composite_np(x: np.ndarray) -> np.ndarray:
    """Plaintext mirror of the three-stage sign approximation."""
    y = np.polyval(SIGN_POLY_1[::-1], x)
    y = np.polyval(SIGN_POLY_2[::-1], y)
    return np.polyval(SIGN_POLY_3[::-1], y)


def relu_np(x: np.ndarray, alpha: float = 0.0) -> np.ndarray:
    """The exact leaky ReLU, in numpy."""
    return np.maximum(0, x) + np.minimum(0, x * alpha)


def relu_key(ct: Ciphertext, alpha: float, tight: bool | None) -> tuple:
    """What decides ``eval_relu``'s launches on one context: the input's
    level, scale and shape, alpha and tight."""
    return ("relu", ct.level, ct.scale, tuple(ct.c0.shape), alpha, tight)


def eval_relu(ctx: CkksContext, ct: Ciphertext, alpha: float = 0.0,
              tight: bool | None = None) -> Ciphertext:
    """leakyReLU(ct) = ct·(b·s(ct) + a); output scale ≈ params scale.
    On the card a CUDA graph of its key replays it (``ckks/graphs.py``).

    tight (depth-optimal) evaluation spends depth(deg) levels per
    composite — 11 total (3+3+4+1) instead of 14, the fork chain's
    ReLU budget (11×30b, ref_bootstrap_params.json[6].relu_b_qi).  It
    works at ANY prime/scale margin: polyeval recurses below deg-4 in
    tight mode so no cached power is constant-multiplied at its own
    level.  Auto (tight=None): chains whose boot_layout allots exactly
    11 relu levels run tight; layout-less chains fall back to the
    legacy margin heuristic (≥12 bits over the working scale)."""
    return ctx._graphs.run(relu_key(ct, alpha, tight), ct,
                           lambda c: _relu(ctx, c, alpha, tight))


def _relu(ctx: CkksContext, ct: Ciphertext, alpha: float,
          tight: bool | None) -> Ciphertext:
    a_const = (alpha + 1) / 2.0
    b_const = (1 - alpha) / 2.0
    p = ctx.params
    scale = p.scale
    depth_total = 3 + 3 + 4 + 1
    if tight is None:
        if p.boot_layout is not None:
            lo_r, hi_r = p.boot_layout["relu"]
            tight = (hi_r - lo_r) == depth_total
        else:
            lo = max(ct.level - depth_total, 0)
            tight = all(np.log2(p.q_moduli[l]) - p.log_scale >= 12.0
                        for l in range(lo, ct.level + 1))
    s = evaluate_poly(ctx, ct, SIGN_POLY_1, scale, tight=tight)
    s = evaluate_poly(ctx, s, SIGN_POLY_2, scale, tight=tight)
    s = evaluate_poly(ctx, s, SIGN_POLY_3 * b_const, scale, tight=tight)
    s = ctx.add_const(s, a_const)
    x = ctx.drop_level(ct, ct.level - s.level)
    prod = ctx.mul_ct(s, x)
    # boost BEFORE the rescale (see PowerBasis docstring): keeps the
    # fixed rescale rounding noise relative to ≈Δ, not Δ²/q
    boost = int(round(np.log2(
        scale * p.q_moduli[prod.level] / prod.scale)))
    if boost >= 1:
        prod = ctx.mul_scalar_int(prod, 1 << boost) \
                  .with_scale(prod.scale * (1 << boost))
    return ctx.rescale(prod)
