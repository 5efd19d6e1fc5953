"""Split CKKS bootstrapping: ModRaise → SubSum → CtoS → EvalMod ∥ … ∥ StoC.

Counterpart of ``optimal_conv_tpu/ckks/bootstrap.py``: the Go fork's
modified bootstrapper with the split halves ``BootstrappConv_CtoS`` /
``BootstrappConv_StoC`` (eval.go:450,543) that expose the slots-domain
midpoint, so that the ReLU and the repacking run between the halves, and
the sparse-slot family (one bootstrapper per log_sparse, selected by the
conv pipeline, main.go:480-505).

Layout contract (matches the fork's debug oracles ``debugCtoS`` /
``debugStoC``, eval.go:610-722):
  * full pack (log_sparse=0): CtoS returns TWO ciphertexts; slots of
    ct_up[i] = coeffs[brv(i)], ct_low[i] = coeffs[brv(i)+N/2].
  * sparse (log_sparse≥1): the ciphertext's coefficients live at stride
    2^ls (subring); CtoS returns ONE ciphertext whose slot view holds
    [c'_lo[brv], c'_hi[brv]] tiled with period 2·n_sub.
EvalMod (cosine Chebyshev + double-angle, payload/q0 folded into the
CtoS diagonals and the output scale reinterpretation) runs inside the
CtoS half, so both halves' outputs are plain message slots.

Level walk (boot_params chain): mod_raise→L; CtoS groups consume 3
levels (+1 fold for sparse); EvalMod 9; ReLU region 14 (30-bit primes);
repack 1 (45b); StoC 3 (45b) → level 1 = conv's ECD level.

Every float that reaches a plaintext or a scale is computed term for
term as the JAX package computes it, so that on the same keys the
residues, levels and scales of the two packages are equal.  The JAX
package's per-level compiled closures are plain functions that take the
level; its profiling marks, its cache-prewarm planning and its bounded
residency of bootstrappers are not ported.
"""

from __future__ import annotations

import functools
import time
from math import comb

import numpy as np
import torch

from ..core import modmath as mm
from ..core import ntt as nttmod
from ..utils import tracing
from . import dft
from .context import CkksContext
from .polyeval import _depth_of as _depth_of_deg
from .polyeval import evaluate_chebyshev, evaluate_poly
from .types import Ciphertext

# Form of the BSGS transforms when the caller does not choose: the
# single-hoisted one.  On an H100, for the four CtoS transforms of the
# fork's chain at logN 16, it needs 3% less device time and 16% fewer
# plaintext bytes than the double-hoisted form in every run, and the
# wall times of the two lie within the host's spread, the host being
# what binds (``chip_smoke.py`` ``hoisting_ab``; the figures are in
# PERF.md).  The JAX package's default is the double form; the parity
# tests name the form on both sides.
DOUBLE_HOIST_DEFAULT = False


# ---------------------------------------------------------------------------
# ModRaise
# ---------------------------------------------------------------------------

def mod_raise(ctx: CkksContext, ct: Ciphertext) -> Ciphertext:
    """Level 0 → max level: centered lift of each residue poly mod q0 (a
    sharded context broadcasts limb 0 from its owner, and each rank lifts
    to its own limbs)."""
    p = ctx.params
    if ct.level != 0:
        raise ValueError(f"mod_raise needs a level-0 ciphertext, got {ct.level}")
    lmax = p.max_level
    idx = ctx.q_rows(lmax)
    q0 = p.q_moduli[0]
    ext = ctx.tables.extender((0,), idx)
    q = ctx.ntt.tabs(idx)[0]
    key = ("modraise_q0",)
    q0_mod = ctx._pt_cache.get(key)
    if q0_mod is None:
        q0_mod = torch.tensor([q0 % p.moduli[i] for i in idx],
                              dtype=torch.int64, device=ctx.device)[:, None]
        ctx._pt_cache[key] = q0_mod
    half = q0 // 2

    def lift(cc):                                      # [1, N] mod q0
        e = ext.extend(cc)                             # [lmax+1, N]
        return ctx.ntt.ntt(mm.centred_sub(e, cc, half, q0_mod, q), idx)

    cc = ctx._limb_coeffs(ct.c0, ct.c1, 0)
    return Ciphertext(lift(cc[0]), lift(cc[1]), level=lmax, scale=ct.scale)


# ---------------------------------------------------------------------------
# BSGS linear transform
# ---------------------------------------------------------------------------

def _bsgs_bs(keys) -> int:
    """Baby-step modulus for a BSGS split of the diagonal index set.

    The split is g,r = divmod(k, bs): balanced (√#keys babies) ONLY if
    bs divides the lattice the keys live on.  Grouped DFT stages have
    indices that are all multiples of a large stride (the stage's
    butterfly half-length), so a naive power-of-two bs makes r ≡ 0 for
    every key: 1 baby, #keys giants, and each giant pays a full
    non-hoisted keyswitch plus its own switching key.  Scaling bs by
    gcd(keys) restores the √-balanced split on the stride lattice; for
    dense key sets (gcd = 1) this is the classic split unchanged."""
    ks = sorted(set(keys))
    nz = [k for k in ks if k]
    if not nz:
        return 1
    stride = int(np.gcd.reduce(nz))
    n_eff = len(nz)
    return stride * (1 << max((int(np.ceil(np.sqrt(n_eff))) - 1)
                              .bit_length(), 0))


class LinearTransform:
    """One-level BSGS diagonal transform, plaintexts precomputed.

    diags: {k: complex vector over the full slot view}; applied at
    `level` with plaintext scale `pt_scale` (default: the level's prime,
    so the ciphertext scale is preserved after the rescale).

    rescale=False leaves the product at `level` with scale
    ct.scale·pt_scale: the fork's StoC packs TWO DFT matrices onto one
    60-bit level, each at scale 2^30
    (ref_bootstrap_params.json[6].stc_scaling = [[Δ],[Δ,Δ]]): the first
    applies un-rescaled, the second's rescale clears both.

    double_hoist (Bossuat et al. 2021): the baby rotations skip their
    mod-downs (``ctx.rotate_hoisted_lazy``); each giant's inner sum
    multiplies the QP-basis key-switch accumulators by QP-encoded
    plaintexts and divides by P once per GIANT.  Its cost is the P rows
    of every plaintext and inner products over l+1+P limbs; the
    single-hoisted form pays two mod-downs a baby instead.  None takes
    ``DOUBLE_HOIST_DEFAULT``."""

    def __init__(self, ctx: CkksContext, diags: dict[int, np.ndarray],
                 level: int, pt_scale: float | None = None,
                 rescale: bool = True, double_hoist: bool | None = None):
        self.ctx = ctx
        self.level = level
        self.rescale = rescale
        self.dh = DOUBLE_HOIST_DEFAULT if double_hoist is None else double_hoist
        p = ctx.params
        n = p.slots
        if not diags:
            raise ValueError("LinearTransform needs at least one diagonal")
        self.pt_scale = float(p.q_moduli[level]) if pt_scale is None else pt_scale
        keys = sorted(k % n for k in diags)
        self.bs = _bsgs_bs(keys)
        # summed in the dict's insertion order, as the JAX package does:
        # float addition is not associative
        norm = {}
        for k, v in diags.items():
            kk = k % n
            norm[kk] = norm.get(kk, 0) + v
        plan: dict[int, dict[int, torch.Tensor]] = {}
        for kk, v in norm.items():
            g, r = divmod(kk, self.bs)
            # double-hoist: plaintexts carry the P-limb residues too (the
            # inner products run in the QP basis)
            pt = ctx.encoder.encode_slots(np.roll(v, g * self.bs),
                                          self.pt_scale, level, qp=self.dh)
            plan.setdefault(g * self.bs, {})[r] = pt.poly
        self.babies = sorted({r for d in plan.values() for r in d})
        # one stacked plaintext tensor a giant; `sel` indexes the giant's
        # baby subset into the ONE stacked rotation tensor built per
        # apply, as a device index tensor made here, or None where the
        # giant uses every baby in order (no gather then)
        bidx = {r: i for i, r in enumerate(self.babies)}
        nb = len(self.babies)
        self.stacked = []
        for g, terms in sorted(plan.items()):
            sel = np.array([bidx[r] for r in sorted(terms)], dtype=np.int64)
            ident = len(sel) == nb and np.array_equal(sel, np.arange(nb))
            self.stacked.append(
                (g, sel, torch.stack([terms[r] for r in sorted(terms)]),
                 None if ident else torch.from_numpy(sel).to(ctx.device)))

    def giants(self) -> list[int]:
        return [g for g, _, _, _ in self.stacked if g]

    def plaintext_bytes(self) -> int:
        return sum(pts.numel() * pts.element_size()
                   for _, _, pts, _ in self.stacked)

    def __call__(self, ct: Ciphertext) -> Ciphertext:
        """BSGS apply: hoisted baby rotations, then per giant one inner
        sum Σ_r rot_r(ct)·pt_{g,r}, the giant rotation with a lazy key
        switch folded into QP-basis running sums, and one division by P
        at the end."""
        ctx = self.ctx
        if ct.level != self.level:
            raise ValueError(f"transform of level {self.level} applied at "
                             f"level {ct.level}")
        if self.dh:
            lazy = ctx.rotate_hoisted_lazy(ct, self.babies)
            stacks = tuple(torch.stack([lazy[r][i] for r in self.babies])
                           for i in range(3))
            inner = _inner_dh
        else:
            rots = ctx.rotate_hoisted(ct, self.babies)
            stacks = (torch.stack([rots[r].c0 for r in self.babies]),
                      torch.stack([rots[r].c1 for r in self.babies]))
            inner = _inner
        p = ctx.params
        scale = ct.scale * self.pt_scale
        nq, nqp = len(ctx.q_rows(self.level)), len(ctx.qp_rows(self.level))
        g0 = None
        aq0 = ap0 = ap1 = None
        for g, _, pts, sel in self.stacked:
            i0, i1 = inner(ctx, self.level, stacks, sel, pts)
            if g == 0:
                g0 = (i0, i1)
                continue
            if aq0 is None:
                aq0 = i0.new_zeros((nq, p.n))
                ap0 = i0.new_zeros((nqp, p.n))
                ap1 = i0.new_zeros((nqp, p.n))
            gg = nttmod.rot_to_galois(g, p.log_n)
            aq0, ap0, ap1 = ctx.galois_acc(i0, i1, gg, self.level,
                                           aq0, ap0, ap1)
        if aq0 is None:                      # single giant at shift 0
            o0, o1 = g0
        else:
            z = aq0.new_zeros((nq, p.n))
            g0c0, g0c1 = g0 if g0 is not None else (z, z)
            o0, o1 = ctx.ks_finish(g0c0, g0c1, aq0, ap0, ap1, self.level)
        out = Ciphertext(o0, o1, level=self.level, scale=scale)
        return ctx.rescale(out) if self.rescale else out


def _inner(ctx: CkksContext, level: int, stacks, sel, pts):
    """One giant's inner sum, single-hoisted:
    (Σ_r c0_r·pt_r, Σ_r c1_r·pt_r) on Q_level (JAX: ``_build_inner``)."""
    q, qinv = ctx.ntt.tabs(ctx.q_rows(level))[:2]
    c0s, c1s = stacks if sel is None else (s.index_select(0, sel)
                                           for s in stacks)
    return (mm.sum_mod(mm.mont_mul(c0s, pts, q, qinv), q),
            mm.sum_mod(mm.mont_mul(c1s, pts, q, qinv), q))


def _inner_dh(ctx: CkksContext, level: int, stacks, sel, pts):
    """One giant's inner sum, double-hoisted, with its mod-down:

        (Σ_r φ_r(c0)·pt_r  +  (Σ_r acc0_r·pt_r)/P,   (Σ_r acc1_r·pt_r)/P)

    stacks = (c0 on Q [nb, l+1, N], acc0 and acc1 on QP [nb, l+1+P, N]);
    pts is QP-encoded, its first l+1 rows (a sharded context's Q rows)
    being the Q encoding.  The
    mod-down after the plaintext product differs from the product of the
    mod-down by less than |pt| a coefficient, far below the key-switch
    noise (JAX: ``_build_inner_dh``)."""
    q_rows = ctx.q_rows(level)
    q, qinv = ctx.ntt.tabs(q_rows)[:2]
    qq, qqinv = ctx.ntt.tabs(ctx.qp_rows(level))[:2]
    nq = len(q_rows)
    c0s, a0s, a1s = stacks if sel is None else (s.index_select(0, sel)
                                                for s in stacks)
    sq = mm.sum_mod(mm.mont_mul(c0s, pts[:, :nq], q, qinv), q)
    s0 = mm.sum_mod(mm.mont_mul(a0s, pts, qq, qqinv), qq)
    s1 = mm.sum_mod(mm.mont_mul(a1s, pts, qq, qqinv), qq)
    md0, md1 = ctx._mod_down_many((s0, s1), level)
    return mm.add_mod(sq, md0, q), md1


# ---------------------------------------------------------------------------
# EvalMod cosine approximation
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def fit_cos_poly(sin_deg: int, k_range: float, double_angle: int,
                 method: str = "cheby", msg_ratio_bits: int = 8,
                 payload_bits: int = 1) -> np.ndarray:
    """Chebyshev-basis coefficients approximating
    cos(2πK/2^r · y − π/2^{r+1}) on y ∈ [-1, 1], the double-angle seed
    of EvalMod (fork: ckks/bettersine, ReLUEvalModuli).

    method='cheby' (production default): plain Chebyshev interpolation
    over the full domain.  At the production configuration (deg 63,
    K=25, r=2, msg_ratio 2^-8) the composite error after the double
    angles is 2^-25.4 over the valid input set, 12 bits BELOW the
    2^-13.3 sine floor (θ−sinθ distortion) that both this and the fork's
    bettersine (ArcSineDeg 0) sit at, so the simpler fit loses nothing.

    method='minimax': Lawson-iterated least squares restricted to the
    valid input set ∪_i [i/K ± ε], ε = 2^{payload_bits-msg_ratio_bits}/K,
    the Han–Ki-style interval fit.  Composite error 2^-33.6 at the same
    degree: +8 bits of headroom that only matter in arcsine mode
    (arcsine_deg > 0 removes the sine floor).  Degree cannot drop:
    deg 47 reaches only 2^-8.7 and deg 31 diverges after the double
    angles, so the fork's deg-63 choice is tight either way.
    """
    r = double_angle
    freq = 2 * np.pi * k_range / (1 << r)
    phi = np.pi / 2 / (1 << r)

    def g(y):
        return np.cos(freq * y - phi)

    if method == "cheby":
        return np.polynomial.chebyshev.Chebyshev.interpolate(
            g, sin_deg, domain=[-1.0, 1.0]).coef
    if method != "minimax":
        raise ValueError(f"sin_method={method!r}: use cheby|minimax")
    kk = int(k_range)
    eps = 2.0 ** (payload_bits - msg_ratio_bits) / k_range
    grid = [np.linspace(i / k_range - eps, i / k_range + eps, 501)
            for i in range(-kk + 1, kk)]
    u = np.concatenate(grid)
    v = np.polynomial.chebyshev.chebvander(u, sin_deg)
    t = g(u)
    w = np.ones(len(u))
    for _ in range(40):                       # Lawson → near-minimax on U
        sol, *_ = np.linalg.lstsq(v * w[:, None], t * w, rcond=None)
        e = np.abs(v @ sol - t)
        w *= np.sqrt(e + 1e-300)
        w /= w.max()
    return sol


# ---------------------------------------------------------------------------
# Split bootstrapper
# ---------------------------------------------------------------------------

class SplitBootstrapper:
    """One instance per log_sparse (the fork's btp..btp5 family)."""

    def __init__(self, ctx: CkksContext, log_sparse: int = 0,
                 k_range: float = 25.0,
                 sin_deg: int = 63, double_angle: int = 2,
                 msg_ratio_bits: int = 8, stoc_level: int | None = None,
                 arcsine_deg: int = 0, sin_method: str = "cheby",
                 double_hoist: bool | None = None):
        """stoc_level: top level of the StoC transforms.  Default (None)
        uses the chain layout's dedicated low StoC levels: the split
        pipeline order (…ReLU → repack → StoC → conv).  The baseline
        ("BL") path instead bootstraps FULLY and applies ReLU after, so
        it sets stoc_level just below EvalMod, leaving the ReLU budget
        under the refreshed ciphertext (the fork's Bootstrapp,
        test_BL.go:133).

        double_hoist: the form of every BSGS transform (see
        ``LinearTransform``)."""
        self.ctx = ctx
        self.ls = log_sparse
        p = ctx.params
        self.q0 = p.q_moduli[0]
        # incoming scale: conv sets out_scale = 2^(round(log2 q0)-pow-8),
        # then the pipeline boosts by 2^pow → Δ0 = 2^(round(log2 q0)-8)
        self.delta0 = float(2 ** (round(np.log2(self.q0)) - msg_ratio_bits))
        self.k_range = k_range
        self.double_angle = double_angle
        lay = p.boot_layout
        if lay is None:
            raise ValueError("params not bootstrappable")
        self.log_nsub = p.log_slots - log_sparse
        n_sub = 1 << self.log_nsub
        reps = p.slots // n_sub
        lmax = p.max_level
        dh = double_hoist

        # delta_m: EvalMod working scale ≈ the evalmod-region primes
        self.delta_m = float(p.q_moduli[lay["evalmod"][1] - 1])

        # group counts come from the chain layout: CtoS levels (minus one
        # for the sparse fold), StoC levels
        n_ctos_levels = lay["ctos"][1] - lay["ctos"][0]
        n_stoc_levels = lay["stoc"][1] - lay["stoc"][0]
        # stoc_groups > levels ⟹ the top StoC level carries two DFT
        # matrices (fork chain: 3 matrices over 2 sixty-bit levels)
        self.stoc_groups = lay.get("stoc_groups", n_stoc_levels)
        ctos_groups = n_ctos_levels - (1 if log_sparse > 0 else 0)
        # EvalMod runs tight (depth(deg)+r levels, no slack rescale) iff
        # the chain's evalmod region is sized for it: the fork chain's 8
        # levels = depth(63)+2
        n_mod = lay["evalmod"][1] - lay["evalmod"][0]
        # arcsine_deg > 0: apply an odd arcsin(t) series after the
        # double-angle sine, undoing the sin distortion so the payload
        # may sit closer to q0 (smaller msg_ratio_bits) than the fork's
        # 2^-8 sine floor (Lattigo ArcSineDeg; the fork pins it to 0).
        # Costs depth(arcsine_deg)+1 extra evalmod levels.
        self.arcsine_deg = arcsine_deg
        extra = _depth_of_deg(arcsine_deg) + 1 if arcsine_deg else 0
        need = _depth_of_deg(sin_deg) + double_angle + extra
        self.em_tight = (n_mod == _depth_of_deg(sin_deg) + double_angle)
        if n_mod < need:
            raise ValueError(f"{n_mod} EvalMod levels, {need} needed for "
                             f"sin_deg {sin_deg}, double_angle {double_angle}, "
                             f"arcsine_deg {arcsine_deg}")
        if arcsine_deg:
            # asin(t) = Σ_k (2k)! / (4^k (k!)² (2k+1)) · t^{2k+1}
            ac = np.zeros(arcsine_deg + 1)
            for k in range(0, (arcsine_deg - 1) // 2 + 1):
                ac[2 * k + 1] = comb(2 * k, k) / (4.0 ** k * (2 * k + 1))
            self._asin_coeffs = ac

        # ---- CtoS groups (inverse DFT stages, bit-rev output) ----------
        enc_st = [dft.tile(s, reps)
                  for s in dft.encode_stages(self.log_nsub)]
        groups = dft.group_stages(enc_st, ctos_groups, p.slots)
        self.ctos_lt: list[LinearTransform] = []
        lvl = lmax
        for gi, gdiags in enumerate(groups):
            last = gi == len(groups) - 1
            if last and log_sparse == 0:
                # fold λ = Δ0/(2·K·q0) (the 1/2 is the conj-split) and the
                # Δm scale switch into the last group
                lam = self.delta0 / (2.0 * k_range * self.q0)
                gdiags = {k: v * lam for k, v in gdiags.items()}
                sc = p.q_moduli[lvl] * self.delta_m / self.delta0
                self.ctos_lt.append(LinearTransform(ctx, gdiags, lvl, sc,
                                                    double_hoist=dh))
            else:
                self.ctos_lt.append(LinearTransform(ctx, gdiags, lvl,
                                                    double_hoist=dh))
            lvl -= 1

        if log_sparse > 0:
            # fold level: y = A⊙x + B⊙conj(x), with λ folded in
            lam = self.delta0 / (k_range * self.q0 * (1 << log_sparse))
            per = np.zeros(2 * n_sub)
            per[:n_sub] = 1.0
            m_lo = np.tile(per, p.slots // (2 * n_sub))
            m_hi = 1.0 - m_lo
            self.fold_a = (m_lo - 1j * m_hi) / 2.0 * lam
            self.fold_b = (m_lo + 1j * m_hi) / 2.0 * lam
            self.fold_level = lvl
            sc = p.q_moduli[lvl] * self.delta_m / self.delta0
            self.fold_a_pt = ctx.encoder.encode_slots(self.fold_a, sc, lvl)
            self.fold_b_pt = ctx.encoder.encode_slots(self.fold_b, sc, lvl)
            lvl -= 1
        self.post_ctos_level = lvl

        # ---- EvalMod: cosine chebyshev + double angle ------------------
        self.sin_cheb = fit_cos_poly(sin_deg, k_range, double_angle,
                                     method=sin_method,
                                     msg_ratio_bits=msg_ratio_bits)

        # ---- StoC groups (forward DFT stages, bit-rev input) -----------
        dec_st = [dft.tile(s, reps) for s in dft.decode_stages(self.log_nsub)]
        if log_sparse > 0:
            # prepend unfold F: x = d0⊙y + d1⊙rot(y, n_sub)
            d0 = np.tile(np.concatenate([np.ones(n_sub), 1j * np.ones(n_sub)]),
                         reps // 2)
            d1 = np.tile(np.concatenate([1j * np.ones(n_sub), np.ones(n_sub)]),
                         reps // 2)
            dec_st = [{0: d0, n_sub: d1}] + dec_st
        s_groups = dft.group_stages(dec_st, self.stoc_groups, p.slots)
        st_lvl = (lay["stoc"][1] - 1) if stoc_level is None else stoc_level
        self.stoc_lt: list[LinearTransform] = []
        double_top = self.stoc_groups - (lay["stoc"][1] - lay["stoc"][0]) \
            if stoc_level is None else 0
        for gi, gdiags in enumerate(s_groups):
            if gi < double_top:
                # two matrices share the top level: first at √q without
                # rescale, partner's rescale clears the product scale
                sq = float(np.sqrt(p.q_moduli[st_lvl]))
                self.stoc_lt.append(LinearTransform(ctx, gdiags, st_lvl,
                                                    pt_scale=sq,
                                                    rescale=False,
                                                    double_hoist=dh))
                continue
            if gi == double_top and double_top > 0:
                sq = float(p.q_moduli[st_lvl]) / float(
                    np.sqrt(p.q_moduli[st_lvl]))
                self.stoc_lt.append(LinearTransform(ctx, gdiags, st_lvl,
                                                    pt_scale=sq,
                                                    double_hoist=dh))
            else:
                self.stoc_lt.append(LinearTransform(ctx, gdiags, st_lvl,
                                                    double_hoist=dh))
            st_lvl -= 1
        self.post_stoc_level = st_lvl

    def plaintext_bytes(self) -> int:
        """Device bytes of the DFT (and fold) plaintexts."""
        n = sum(lt.plaintext_bytes() for lt in self.ctos_lt + self.stoc_lt)
        if self.ls > 0:
            n += 2 * self.fold_a_pt.poly.numel() * 8
        return n

    # ------------------------------------------------------------------

    def ctos(self, ct: Ciphertext, on_stage=None):
        """(ct level 0, scale Δ0) → slot-domain message ciphertext(s).

        Returns (ct_up, ct_low) for full pack, (ct, None) for sparse.
        Output values are the plaintext coefficients (÷2^pow still
        applied by caller convention), at the ReLU region's scale.
        on_stage(name, value), when given, is called after the raise and
        SubSum, after each transform and after EvalMod; while spans are
        recorded the same points end stage spans (``utils/tracing.py``)."""
        ctx = self.ctx
        p = ctx.params
        with tracing.stages(None, on_stage) as mark:
            ct = mod_raise(ctx, ct)
            # SubSum: project onto the stride-2^ls subring (kills inter-
            # stride garbage; scales kept coeffs by 2^ls, folded into the
            # diagonals)
            for j in range(self.ls):
                g = (2 * p.n) // (1 << (j + 1)) + 1
                ct = ctx.add(ct, ctx.apply_galois(ct, g))
            mark("ctos.raise+subsum", ct)
            for i, lt in enumerate(self.ctos_lt):
                ct = lt(ct)
                mark(f"ctos.lt{i}", ct)
            if self.ls == 0:
                cj = ctx.conjugate(ct)
                up = ctx.add(ct, cj)
                low = ctx.div_by_i(ctx.sub(ct, cj))
                mark("ctos.conj", (up, low))
                up = self._eval_mod(up)
                low = self._eval_mod(low)
                mark("ctos.evalmod", (up, low))
                return up, low
            cj = ctx.conjugate(ct)
            a = ctx.mul_plain(ct, self.fold_a_pt)
            b = ctx.mul_plain(cj, self.fold_b_pt)
            folded = ctx.rescale(ctx.add(a, b))
            mark("ctos.fold", folded)
            out = self._eval_mod(folded)
            mark("ctos.evalmod", out)
            return out, None

    def eval_mod_key(self, ct: Ciphertext) -> tuple:
        """What decides ``_eval_mod``'s launches besides the bootstrapper:
        the input's level and shape (its scale is replaced by Δm)."""
        return ("evalmod", ct.level, tuple(ct.c0.shape))

    def _eval_mod(self, ct: Ciphertext) -> Ciphertext:
        """values y = payload/(K·q0) → values payload/Δ0, scale ≈ Δ.  On
        the card, a CUDA graph of this bootstrapper replays it
        (``ckks/graphs.py``)."""
        return self.ctx._graphs.run(self.eval_mod_key(ct), ct,
                                    self._eval_mod_body, owner=self)

    def _eval_mod_body(self, ct: Ciphertext) -> Ciphertext:
        ctx = self.ctx
        p = ctx.params
        ct = ct.with_scale(self.delta_m)  # absorb float drift of λ folding
        # back out per-double-angle scales so the final scale lands at
        # Δ·(q0/(2π·Δ0)) before the exact reinterpretation below
        r = self.double_angle
        depth = _cheb_depth(len(self.sin_cheb) - 1) - (1 if self.em_tight
                                                       else 0)
        lc = ct.level - depth
        s_final = p.scale * self.q0 / (2 * np.pi * self.delta0)
        # with an arcsine pass below, the double-angle chain lands
        # sin(θ) at the working scale and the asin evaluation targets
        # s_final itself
        scales = [p.scale if self.arcsine_deg else s_final]
        for i in range(r):
            prev = np.sqrt(scales[-1] * p.q_moduli[lc - r + 1 + i])
            scales.append(prev)
        s_t = scales[-1]
        c = evaluate_chebyshev(ctx, ct, self.sin_cheb, -1.0, 1.0, s_t,
                               tight=self.em_tight)
        for i in range(r):
            sq = ctx.rescale(ctx.mul_ct(c, c))
            c = ctx.add_const(ctx.mul_scalar_int(sq, 2), -1.0)
        if self.arcsine_deg:
            # θ = asin(sin θ) exactly (|θ| = 2π·|payload|/q0 < π/2):
            # removes the sin distortion instead of the ≈x linearization
            c = evaluate_poly(ctx, c, self._asin_coeffs,
                              target_scale=s_final)
        # c ≈ sin(2πK y) = sin(2π payload/q0) ≈ 2π·payload/q0 at scale s
        # reinterpretation: payload/Δ0 at scale s·2πΔ0/q0  (exact, free)
        return c.with_scale(c.scale * 2 * np.pi * self.delta0 / self.q0)

    # ------------------------------------------------------------------

    def stoc(self, ct0: Ciphertext, ct1: Ciphertext | None,
             on_stage=None) -> Ciphertext:
        """Slot-domain message ct(s) → coefficient-packed ct at level 1."""
        ctx = self.ctx
        if self.ls == 0:
            if ct1 is None:
                raise ValueError("full-pack stoc needs both ciphertexts")
            ct = ctx.add(ct0, ctx.mul_by_i(ct1))
        else:
            ct = ct0
        lvl0 = self.stoc_lt[0].level
        if ct.level > lvl0:
            ct = ctx.drop_level(ct, ct.level - lvl0)
        with tracing.stages(None, on_stage) as mark:
            for i, lt in enumerate(self.stoc_lt):
                ct = lt(ct)
                mark(f"stoc.lt{i}", ct)
        return ct


def _cheb_depth(deg: int) -> int:
    d = 0
    while (1 << d) < deg + 1:
        d += 1
    return d + 1


class BootstrapperFamily:
    """Lazy {log_sparse: SplitBootstrapper}: a bootstrapper is built when
    a layer first asks for its log_sparse.

    The fork keeps all 5 bootstrappers resident for the whole run
    (btp..btp5, main.go:480-505).  max_live=None does the same; an
    integer keeps at most that many, dropping the least recently used
    and its CUDA graphs.
    A build is a span ``boot.build`` (attribute log_sparse) and adds to
    the counters ``boot.builds`` and ``boot.build_s``, its host seconds
    (``utils/tracing.py``)."""

    def __init__(self, ctx: CkksContext, boot_kwargs: dict | None = None,
                 max_live: int | None = None):
        self.ctx = ctx
        self.kwargs = dict(boot_kwargs or {})
        self.max_live = max_live
        self._live: dict[int, SplitBootstrapper] = {}

    def __getitem__(self, ls: int) -> SplitBootstrapper:
        btp = self._live.pop(ls, None)
        if btp is None:
            while self.max_live is not None and len(self._live) >= self.max_live:
                self.ctx._graphs.drop(self._live.pop(next(iter(self._live))))
            t0 = time.perf_counter()
            with tracing.span("boot.build", log_sparse=ls):
                btp = SplitBootstrapper(self.ctx, log_sparse=ls, **self.kwargs)
            tracing.count("boot.builds")
            tracing.count("boot.build_s", time.perf_counter() - t0)
        self._live[ls] = btp                 # most recently used last
        return btp

    def __contains__(self, ls: int) -> bool:
        return ls in self._live
