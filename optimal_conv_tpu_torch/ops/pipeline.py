"""The fused Conv→BN→Bootstrap(CtoS)→ReLU→repack→Bootstrap(StoC) layer.

Counterpart of ``optimal_conv_tpu/ops/pipeline.py``: the Go fork's
``evalConv_BNRelu_new`` (eval.go:272-607), the hot loop of every
encrypted model, and the masked-rotate-accumulate repack evaluators
``ext_ctxt`` / ``ext_double_ctxt`` / ``keep_ctxt`` (conv.go:347-431).

Kind dispatch mirrors the fork exactly (eval.go:283-313):
  Conv, Conv_sparse          plain conv, keep-mask repack
  StrConv_sparse             split-kernel even/odd double conv (stride 2)
  StrConv_sparse_full        full-pack strided conv via offset premul
  StrConv / StrConv_fast     strided conv w/ compression repack
  StrConv_odd                odd-width stride via X^offset premultiply
  Conv_inside/StrConv_inside dilated ("inside") kernels
  TransConv                  transposed conv (extend repack)

Scale protocol (the fork's non-standard core): conv out_scale =
2^(round(log2 q0) − (pow+8)); boost scale ×2^pow before bootstrap so
values enter CtoS in [−1,1]; repack masks at the level prime (vanish on
rescale); ReLU output ×2^pow restores range.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..ckks.context import CkksContext
from ..ckks.types import Ciphertext
from ..utils import tracing
from . import conv as convops
from .relu import eval_relu


# ---------------------------------------------------------------------------
# repack evaluators (masked rotate-accumulate over bit-reversed slot space)
# ---------------------------------------------------------------------------

def _mask_pt(ctx: CkksContext, mask: np.ndarray, level: int, scale: float):
    """Encode (and cache) a repack mask plaintext.  Masks are long-lived
    per-model tables; keying the cache on the array's identity avoids
    re-running the slot FFT + CRT on every layer invocation (a key on
    the contents would hash every slot a call)."""
    key = (id(mask), level, scale)
    hit = ctx._pt_cache.get(key)
    if hit is None:
        pt = ctx.encoder.encode_slots(mask.astype(np.complex128), scale, level)
        ctx._pt_cache[key] = (pt, mask)     # keep mask alive so id is stable
        return pt
    return hit[0]


def keep_ctxt(ctx: CkksContext, ct: Ciphertext, mask: np.ndarray) -> Ciphertext:
    """Multiply by 0/1 keep mask at the level prime, rescale
    (keep_ctxt, conv.go:417-431)."""
    pt = _mask_pt(ctx, mask, ct.level, float(ctx.params.q_moduli[ct.level]))
    return ctx.rescale(ctx.mul_plain(ct, pt))


def _masked_rotate_sum(ctx: CkksContext, ct: Ciphertext,
                       idx: dict[int, np.ndarray], sc: float) -> Ciphertext:
    """Σ_rot rot(ct ⊙ mask) over the {rotation: mask} table, no rescale.
    The counter ``repack.rotations`` adds the table's rotations."""
    tracing.count("repack.rotations", len(idx))
    out = None
    for rot, mask in sorted(idx.items()):
        t = ctx.rotate(ctx.mul_plain(ct, _mask_pt(ctx, mask, ct.level, sc)), rot)
        out = t if out is None else ctx.add(out, t)
    return out


def ext_ctxt(ctx: CkksContext, ct: Ciphertext,
             r_idx: dict[int, np.ndarray]) -> Ciphertext:
    """Single-stage Σ_rot rot(ct ⊙ mask) (ext_ctxt, conv.go:347-371)."""
    sc = float(ctx.params.q_moduli[ct.level])
    return ctx.rescale(_masked_rotate_sum(ctx, ct, r_idx, sc))


def ext_double_ctxt(ctx: CkksContext, ct: Ciphertext,
                    m_idx: dict[int, np.ndarray],
                    r_idx: dict[int, np.ndarray]) -> Ciphertext:
    """Two-stage BSGS repack; masks at √q so ONE rescale covers both
    stages (ext_double_ctxt, conv.go:374-414)."""
    sc = float(np.sqrt(ctx.params.q_moduli[ct.level]))
    mid = _masked_rotate_sum(ctx, ct, m_idx, sc)
    return ctx.rescale(_masked_rotate_sum(ctx, mid, r_idx, sc))


# ---------------------------------------------------------------------------
# fused layer
# ---------------------------------------------------------------------------

@dataclass
class LayerMaps:
    """Per-layer repack tables (the fork's context maps ext_idx /
    r_idx / m_idx(_l), built by models/* the way newContext does)."""
    ext_idx: list | None = None        # [ul] → 0/1 mask
    r_idx: dict | None = None
    r_idx_l: dict | None = None
    m_idx: dict | None = None
    m_idx_l: dict | None = None


def eval_conv_bn_relu(ctx: CkksContext, btps, ct_in: Ciphertext,
                      ker_in: np.ndarray, bn_a: np.ndarray,
                      bn_b: np.ndarray, alpha: float, pow_: float, in_wid: int,
                      kp_wid: int, ker_wid: int, real_ib: int, real_ob: int,
                      norm: int, pack_pos: int, step: int, n_iter: int,
                      log_sparse: int, kind: str, maps: LayerMaps,
                      debug_hook=None, on_stage=None) -> Ciphertext:
    """One fused layer.  btps maps log_sparse to its ``SplitBootstrapper``
    (a dict or a ``BootstrapperFamily``).  debug_hook(name, value) sees
    each stage's ciphertext(s); on_stage(name, value) is for timing: it
    is called at the same points and also passed down into ``ctos`` and
    ``stoc``, so a caller that synchronises in it reads each stage's
    time.  While spans are recorded (``utils/tracing.py``) the call is a
    span ``layer`` (attributes kind, log_sparse, step and halves: the
    CtoS outputs that go on, 2 at log_sparse 0, else 1) whose stage
    spans end at the same points: conv, ctos (its own stages ctos.*),
    relu, repack, stoc (stoc.lt*).  Inside the relu and repack stages
    each half's work is a span ``relu.half`` / ``repack.half``
    (attribute ul: 0 the upper half, 1 the lower)."""
    p = ctx.params
    n = p.n
    trans = stride = odd = inside = modify_ker = full = False
    in_step = step
    if kind == "Conv_sparse":
        pass
    elif kind == "StrConv_sparse":
        modify_ker = stride = True
    elif kind == "StrConv_sparse_full":
        modify_ker = stride = full = True
    elif kind == "Conv_inside":
        inside = True
    elif kind == "StrConv_inside":
        in_step = step // 2
        if step % 2 != 0:
            raise ValueError("step must be even for StrConv_inside")
        inside = True
    elif kind in ("StrConv", "StrConv_fast"):
        stride = True
    elif kind == "StrConv_odd":
        stride = odd = True
    elif kind == "TransConv":
        trans = True
    elif kind != "Conv":
        raise ValueError(f"unknown kind {kind}")

    # the layer is a span "layer" whose stages end at the marks
    # (utils/tracing.py); each mark then calls the hooks
    with tracing.stages("layer", debug_hook, on_stage, kind=kind,
                        log_sparse=log_sparse, step=step,
                        halves=1 if log_sparse else 2) as mark:
        q0 = p.q_moduli[0]
        out_scale = float(2.0 ** (round(np.log2(q0)) - (pow_ + 8)))
        max_batch = n // (in_wid * in_wid)

        if odd:
            # move input so strided output lands on even grid
            # (eval.go:315-332)
            if (in_wid - ker_wid // 2) % 2 == 0:
                offset = 0
            else:
                offset = max_batch * (in_wid + 1)
            if offset:
                ct_in = ctx.mul_monomial(ct_in, offset)

        if modify_ker and not full:
            # split even/odd out-channels into two convs (eval.go:335-390)
            ker = np.asarray(ker_in).reshape(ker_wid * ker_wid, real_ib,
                                             real_ob)
            k0 = ker[:, :, 0::2].ravel()
            k1 = ker[:, :, 1::2].ravel()
            ct1 = convops.eval_conv_bn(ctx, ct_in, k0, bn_a[0::2], bn_b[0::2],
                                       in_wid, ker_wid, real_ib, real_ob // 2,
                                       norm // 2, out_scale, trans)
            ct2 = convops.eval_conv_bn(ctx, ct_in, k1, bn_a[1::2], bn_b[1::2],
                                       in_wid, ker_wid, real_ib, real_ob // 2,
                                       norm // 2, out_scale, trans)
            ct2 = ctx.mul_monomial(ct2, norm // 4)
            ct_conv = ctx.add(ct1, ct2)
            if (in_wid - ker_wid // 2) % 2 == 0:
                ct_conv = ctx.mul_monomial(ct_conv,
                                           -(max_batch * (in_wid + 1)))
        elif modify_ker and full:
            ct_conv = convops.eval_conv_bn(ctx, ct_in, ker_in, bn_a, bn_b,
                                           in_wid, ker_wid, real_ib, real_ob,
                                           norm, out_scale, trans)
            if (in_wid - ker_wid // 2) % 2 == 0:
                ct_conv = ctx.mul_monomial(ct_conv,
                                           -(max_batch * (in_wid + 1)))
        elif inside:
            new_kw = ker_wid * in_step - in_step + 1
            ker = np.asarray(ker_in).reshape(ker_wid, ker_wid, real_ib,
                                             real_ob)
            new_ker = np.zeros((new_kw, new_kw, real_ib, real_ob))
            new_ker[::in_step, ::in_step] = ker
            ct_conv = convops.eval_conv_bn(ctx, ct_in, new_ker.ravel(), bn_a,
                                           bn_b, in_wid, new_kw, real_ib,
                                           real_ob, norm, out_scale, trans)
        else:
            ct_conv = convops.eval_conv_bn(ctx, ct_in, ker_in, bn_a, bn_b,
                                           in_wid, ker_wid, real_ib, real_ob,
                                           norm, out_scale, trans)

        # boost: values enter the bootstrap in [-1, 1] (eval.go:437)
        ct_conv = ct_conv.with_scale(ct_conv.scale * 2.0 ** pow_)
        mark("conv", ct_conv)

        btp = btps[log_sparse]
        ct_up, ct_low = btp.ctos(ct_conv, on_stage=on_stage)
        mark("ctos", (ct_up, ct_low))

        boots = [ct_up, ct_low]
        for ul in range(2):
            if boots[ul] is not None:
                with tracing.span("relu.half", ul=ul):
                    r = eval_relu(ctx, boots[ul], alpha)
                    boots[ul] = ctx.mul_scalar_int(r, 1 << int(pow_))
        mark("relu", tuple(boots))

        keep = [None, None]
        for ul in range(2):
            if boots[ul] is None:
                continue
            with tracing.span("repack.half", ul=ul):
                if trans:
                    keep[ul] = ext_ctxt(ctx, boots[ul], maps.r_idx if ul == 0
                                        else maps.r_idx_l)
                elif stride:
                    m = maps.m_idx if ul == 0 else maps.m_idx_l
                    r = maps.r_idx if ul == 0 else maps.r_idx_l
                    if m is None:
                        # non-fast_pack StrConv: single-stage maps from
                        # gen_comprs_full (eval.go:513-519)
                        keep[ul] = ext_ctxt(ctx, boots[ul], r)
                    else:
                        keep[ul] = ext_double_ctxt(ctx, boots[ul], m, r)
                else:
                    keep[ul] = keep_ctxt(ctx, boots[ul], maps.ext_idx[ul])
        mark("repack", tuple(keep))

        out = btp.stoc(keep[0], keep[1], on_stage=on_stage)
        mark("stoc", out)
        return out
