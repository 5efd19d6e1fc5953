"""Homomorphic polynomial evaluation: power-basis and Chebyshev BSGS.

Counterpart of ``optimal_conv_tpu/ckks/polyeval.py``: Paterson–Stockmeyer
evaluation with explicit scale targeting, the facility the minimax ReLU
consumes, plus a Chebyshev-basis variant for the bootstrapper's EvalMod
sine/cosine approximation.

Scale management: every branch is evaluated toward an explicit
(level, scale) target; alignment folds into the per-term constant
multiplication (value·c at constant-scale S·q_ℓ/s_i, then rescale), so
additions always see exactly matching scales.  All of it is Python
floats and ``int(round(...))``, written term for term as in the JAX
module, so both packages derive the same integer constants and the same
levels and scales.  Nothing here touches a tensor: the work on the
device is the context's.
"""

from __future__ import annotations

import numpy as np
from numpy.polynomial import chebyshev as C

from .context import CkksContext
from .types import Ciphertext


def _depth_of(deg: int) -> int:
    d = 0
    while (1 << d) < deg + 1:
        d += 1
    return d


def to_level_scale(ctx: CkksContext, ct: Ciphertext, level: int,
                   scale: float) -> Ciphertext:
    """Bring ct to exactly (level, scale), consuming level gap ≥ 1."""
    if ct.level == level and abs(ct.scale / scale - 1) < 1e-12:
        return ct
    if ct.level <= level:
        raise ValueError(f"level {ct.level} cannot be brought to {level}")
    ct = ctx.drop_level(ct, ct.level - (level + 1))
    return ctx.set_scale(ct, scale)


class PowerBasis:
    """Cache of ct powers x^i, built with immediate rescale after each mul.

    When the chain's primes are wider than the working scale (the
    depth-optimal "tight" layout: e.g. 45-bit relu primes at scale
    2^30), each rescale would shrink the power's scale by q/Δ; a free
    integer multiply by 2^k BEFORE the rescale holds the post-rescale
    scale at ≈Δ.  The boost must precede the rescale: rescale rounding
    noise is fixed in coefficient units, so rescaling down to Δ²/q ≈
    2^15 first and boosting after would lock in ~2^-12 relative error
    (measured: 4e-3 per power), while boosting first keeps it ~2^-27."""

    def __init__(self, ctx: CkksContext, ct: Ciphertext):
        self.ctx = ctx
        self.pows: dict[int, Ciphertext] = {1: ct}

    def get(self, i: int) -> Ciphertext:
        if i in self.pows:
            return self.pows[i]
        half = 1 << (_depth_of(i) - 1)
        if half == i:
            half = i // 2
        a = self.get(half)
        b = self.get(i - half)
        lvl = min(a.level, b.level)
        a = self.ctx.drop_level(a, a.level - lvl)
        b = self.ctx.drop_level(b, b.level - lvl)
        prod = self.ctx.mul_ct(a, b)
        p = self.ctx.params
        boost = int(round(np.log2(
            p.scale * p.q_moduli[lvl] / prod.scale)))
        if boost >= 1:
            prod = self.ctx.mul_scalar_int(prod, 1 << boost) \
                       .with_scale(prod.scale * (1 << boost))
        out = self.ctx.rescale(prod)
        self.pows[i] = out
        return out


def evaluate_poly(ctx: CkksContext, ct: Ciphertext, coeffs: np.ndarray,
                  target_scale: float | None = None,
                  tight: bool = False) -> Ciphertext:
    """p(ct) for power-basis coefficients [c0, c1, ...] (real).

    Output lands at ct.level − depth(deg) − 1 with scale target_scale
    (default: the context's parameter scale).

    tight=True targets the optimal ct.level − depth(deg): the top baby
    power then sits AT the target level and its constant multiplies
    can't burn a rescale — they encode at cs = S/pow.scale, which only
    has usable precision when the chain primes exceed the working scale
    by ≥ ~2^12 (the 45-bit-primes-at-2^30-scale relu layout).  Callers
    must check that margin (ops.relu does).
    """
    coeffs = np.asarray(coeffs, dtype=np.float64)
    deg = len(coeffs) - 1
    while deg > 0 and coeffs[deg] == 0:
        deg -= 1
    coeffs = coeffs[: deg + 1]
    S = ctx.params.scale if target_scale is None else target_scale
    basis = PowerBasis(ctx, ct)
    # make sure the deepest power exists so levels are known
    if deg >= 2:
        basis.get(1 << (_depth_of(deg) - 1))
    target_level = ct.level - _depth_of(deg) - (0 if tight else 1)
    # tight: recurse below deg-4 so no power is ever constant-multiplied
    # at its own level (x^{m-1} lands at the x^m giant's level; a
    # headroom-less const-mul encodes at cs≈1 and loses everything —
    # only x itself, always one level above every target, goes direct)
    out, c0 = _eval_rec(ctx, _Pow(basis), coeffs, target_level, S,
                        min_direct=2 if tight else 4)
    if out is None:
        raise ValueError("constant polynomial")
    return ctx.add_const(out, c0) if c0 != 0.0 else out


class _Pow:
    """Adapter giving PowerBasis/ChebBasis a common .get for the recursion."""

    def __init__(self, basis):
        self.basis = basis

    def get(self, i):
        return self.basis.get(i)


def _eval_rec(ctx, basis, coeffs: np.ndarray, tl: int, S: float,
              split=None, min_direct: int = 4):
    """Evaluate coeffs toward (tl, S).  Returns (ct|None, pending_const):
    the true value is ct + pending_const (constant not yet added)."""
    split = _split if split is None else split
    deg = len(coeffs) - 1
    while deg > 0 and coeffs[deg] == 0:
        deg -= 1
    coeffs = coeffs[: deg + 1]
    if deg < min_direct:
        return _eval_direct(ctx, basis, coeffs, tl, S)
    m = 1 << (_depth_of(deg) - 1)
    qq, rr = split(coeffs, m)
    pw = basis.get(m)
    pw_lvl = tl + 1
    pw_at = ctx.drop_level(pw, pw.level - pw_lvl)
    sq = S * ctx.params.q_moduli[pw_lvl] / pw_at.scale
    qc, qc0 = _eval_rec(ctx, basis, qq, pw_lvl, sq, split, min_direct)
    rc, rc0 = _eval_rec(ctx, basis, rr, tl, S, split, min_direct)
    if qc is None and qc0 == 0.0:
        return rc, rc0
    if qc is not None:
        if qc0 != 0.0:
            qc = ctx.add_const(qc, qc0)
        prod = ctx.rescale(ctx.mul_ct(qc, pw_at)).with_scale(S)
    else:
        # constant × x^m
        cs = S * ctx.params.q_moduli[pw_lvl] / pw_at.scale
        prod = ctx.rescale(ctx.mul_const(pw_at, qc0, cs)).with_scale(S)
    if rc is not None:
        return ctx.add(prod, rc), rc0
    return prod, rc0


def _split(coeffs: np.ndarray, m: int):
    """coeffs = qq·basis_m + rr.  Power basis: plain split."""
    return coeffs[m:], coeffs[:m]


def _eval_direct(ctx, basis, coeffs: np.ndarray, tl: int, S: float):
    terms = []
    for i in range(1, len(coeffs)):
        if coeffs[i] == 0.0:
            continue
        pw = basis.get(i)
        if pw.level > tl:
            pw = ctx.drop_level(pw, pw.level - (tl + 1))
            cs = S * ctx.params.q_moduli[tl + 1] / pw.scale
            t = ctx.rescale(ctx.mul_const(pw, float(coeffs[i]), cs)) \
                   .with_scale(S)
        else:
            # tight layout: the power already lives at the target level —
            # constant multiply with no rescale (cs = S/pow.scale; the
            # chain must provide cs >> 1 for precision, see evaluate_poly)
            if pw.level != tl:
                raise ValueError(f"power {i} at level {pw.level} is below "
                                 f"the target level {tl}")
            cs = S / pw.scale
            t = ctx.mul_const(pw, float(coeffs[i]), cs).with_scale(S)
        terms.append(t)
    c0 = float(coeffs[0]) if len(coeffs) else 0.0
    if not terms:
        return None, c0
    out = terms[0]
    for t in terms[1:]:
        out = ctx.add(out, t)
    return out, c0


# ---------------------------------------------------------------------------
# Chebyshev basis (EvalMod)
# ---------------------------------------------------------------------------

class ChebBasis:
    """Cache of T_i(u) for u = (2x - (a+b))/(b-a), via product identities."""

    def __init__(self, ctx: CkksContext, ct: Ciphertext, a: float, b: float):
        self.ctx = ctx
        if a == -1.0 and b == 1.0:
            t1 = ct  # identity domain map — no level consumed
        else:
            # T1 = (2x - (a+b)) / (b-a): one mul_const+rescale, one add_const
            cs = ctx.params.q_moduli[ct.level]  # encode at the level prime
            t1 = ctx.rescale(ctx.mul_const(ct, 2.0 / (b - a), float(cs)))
            t1 = ctx.add_const(t1, -(a + b) / (b - a))
        self.pows: dict[int, Ciphertext] = {1: t1}

    def get(self, i: int) -> Ciphertext:
        if i in self.pows:
            return self.pows[i]
        ctx = self.ctx
        if i % 2 == 0:
            # T_{2k} = 2 T_k^2 - 1
            tk = self.get(i // 2)
            sq = ctx.rescale(ctx.mul_ct(tk, tk))
            out = ctx.add_const(ctx.mul_scalar_int(sq, 2), -1.0)
        else:
            # T_{i} = 2 T_a T_b - T_{|a-b|},  a+b = i
            a_i = (i + 1) // 2
            b_i = i - a_i
            ta, tb = self.get(a_i), self.get(b_i)
            lvl = min(ta.level, tb.level)
            ta = ctx.drop_level(ta, ta.level - lvl)
            tb = ctx.drop_level(tb, tb.level - lvl)
            prod = ctx.rescale(ctx.mul_ct(ta, tb))
            prod = ctx.mul_scalar_int(prod, 2)
            tc = self.get(abs(a_i - b_i))
            tc = to_level_scale(ctx, tc, prod.level, prod.scale) \
                if (tc.level, tc.scale) != (prod.level, prod.scale) else tc
            out = ctx.sub(prod, tc)
        self.pows[i] = out
        return out


def _cheb_split(coeffs: np.ndarray, m: int):
    tm = np.zeros(m + 1)
    tm[m] = 1.0
    qq, rr = C.chebdiv(coeffs, tm)
    return qq, rr


def evaluate_chebyshev(ctx: CkksContext, ct: Ciphertext, cheb_coeffs: np.ndarray,
                       a: float, b: float,
                       target_scale: float | None = None,
                       tight: bool = False) -> Ciphertext:
    """Σ c_i·T_i(u(ct)) with u mapping [a,b]→[-1,1] (Chebyshev basis BSGS).

    tight=True consumes exactly depth(deg) levels (see evaluate_poly) —
    the EvalMod budget of the fork's chain (8 = 6 + 2 double-angles
    for its deg-63 cosine, ref_bootstrap_params.json[6].sine_qi)."""
    coeffs = np.asarray(cheb_coeffs, dtype=np.float64)
    deg = len(coeffs) - 1
    while deg > 0 and coeffs[deg] == 0:
        deg -= 1
    coeffs = coeffs[: deg + 1]
    S = ctx.params.scale if target_scale is None else target_scale
    basis = ChebBasis(ctx, ct, a, b)
    if deg >= 2:
        basis.get(1 << (_depth_of(deg) - 1))
    target_level = basis.pows[1].level - _depth_of(deg) - (0 if tight else 1)
    out, c0 = _eval_rec(ctx, basis, coeffs, target_level, S, _cheb_split,
                        min_direct=2 if tight else 4)
    if out is None:
        raise ValueError("constant polynomial")
    return ctx.add_const(out, c0) if c0 != 0.0 else out
