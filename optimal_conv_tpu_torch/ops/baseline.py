"""Prior-art ("BL") slot-domain convolution, the A/B baseline.

Counterpart of ``optimal_conv_tpu/ops/baseline.py``: the Go reference's
baseline path (reshape_input_BL / reshape_ker_BL / preConv_BL /
postConv_BL / evalConv_BN_BL_test / evalRMFC_BL, conv.go:57-178,
eval.go:61-218, test_BL.go): the classic SISO slot-packed conv, k²
hoisted rotations of the input, a masked plaintext product for each tap,
then a rotate-sum over out-channel offsets.  ``conv`` and ``convReLU``
run it before the paper's method on the same data (main.go:639-643).

Layout: slot t of the ciphertext holds channel b = t // (w·w) at spatial
position t mod (w·w) (row-major): a block a channel, the opposite of the
coefficient path's channel-interleaved packing.
"""

from __future__ import annotations

import numpy as np

from ..ckks.context import CkksContext
from ..ckks.types import Ciphertext
from .relu import eval_relu


def reshape_input_bl(raw: np.ndarray, in_wid: int) -> np.ndarray:
    """1-D HWC vector → per-channel slot blocks (reshape_input_BL)."""
    batch = len(raw) // (in_wid * in_wid)
    out = np.zeros(in_wid * in_wid * batch)
    k = 0
    for i in range(in_wid):
        for j in range(in_wid):
            for b in range(batch):
                out[i * in_wid + j + b * in_wid * in_wid] = raw[k]
                k += 1
    return out


def reshape_ker_bl(ker_in: np.ndarray, bn_a: np.ndarray, ker_wid: int,
                   in_b: int, out_b: int, max_bat: int,
                   norm: int = 1) -> np.ndarray:
    """Flat kernel → [kh, kw, max_bat, max_bat] with the BN scale folded
    in and the channels spread to max_bat."""
    ker = np.zeros((ker_wid, ker_wid, max_bat, max_bat))
    for i in range(ker_wid):
        for j in range(ker_wid):
            for ib in range(in_b):
                for ob in range(out_b):
                    ker[i, j, norm * ib, norm * ob] = \
                        ker_in[ob + ib * out_b + j * out_b * in_b
                               + i * out_b * in_b * ker_wid] * bn_a[ob]
    return ker


def eval_conv_bn_bl(ctx: CkksContext, ct_in: Ciphertext, ker_in: np.ndarray,
                    bn_a: np.ndarray, bn_b: np.ndarray, in_wid: int,
                    ker_wid: int, real_ib: int, real_ob: int,
                    pad: int = 0) -> Ciphertext:
    """SISO conv: k² hoisted input rotations, a masked plaintext product
    for each tap, accumulated, an out-channel rotate-sum, and the BN
    bias.  No rescale: the result's scale is the input's times Δ."""
    p = ctx.params
    in_size = in_wid * in_wid
    max_batch = p.slots // in_size
    ker = reshape_ker_bl(ker_in, bn_a, ker_wid, real_ib, real_ob, max_batch)

    # hoisted rotations over the k² neighbourhood (preConv_BL)
    half = ker_wid // 2
    rots = [i * in_wid + j for i in range(-half, half + 1)
            for j in range(-half, half + 1)]
    ct_rots = ctx.rotate_hoisted(ct_in, rots)

    ct_out = None
    for rot in range(max_batch):
        acc = None
        for i in range(-half, half + 1):
            for j in range(-half, half + 1):
                post = np.zeros(p.slots, dtype=np.complex128)
                any_nz = False
                for b in range(max_batch):
                    kv = ker[i + half, j + half, b, (b - rot) % max_batch]
                    if kv == 0.0:
                        continue
                    blk = np.zeros((in_wid, in_wid))
                    lo_i = max(0, -i)
                    hi_i = min(in_wid - pad, in_wid - pad - i)
                    lo_j = max(0, -j)
                    hi_j = min(in_wid - pad, in_wid - pad - j)
                    blk[lo_i:hi_i, lo_j:hi_j] = kv
                    post[b * in_size:(b + 1) * in_size] = blk.ravel()
                    any_nz = True
                if not any_nz:
                    continue
                pt = ctx.encoder.encode_slots(post, p.scale, ct_in.level)
                t = ctx.mul_plain(ct_rots[i * in_wid + j], pt)
                acc = t if acc is None else ctx.add(acc, t)
        if acc is None:
            continue
        if rot:
            acc = ctx.rotate(acc, rot * in_size)
        ct_out = acc if ct_out is None else ctx.add(ct_out, acc)

    bias = np.zeros(p.slots, dtype=np.complex128)
    for ob in range(real_ob):
        blk = np.zeros((in_wid, in_wid))
        blk[: in_wid - pad, : in_wid - pad] = bn_b[ob]
        bias[ob * in_size:(ob + 1) * in_size] = blk.ravel()
    pt_b = ctx.encoder.encode_slots(bias, ct_out.scale, ct_out.level,
                                    mont=False)
    return ctx.add_plain(ct_out, pt_b)


def fold_bl(ctx: CkksContext, btp, ct1: Ciphertext, ct2: Ciphertext,
            shift: float) -> Ciphertext:
    """Two real slot ciphertexts → one at level 0 holding
    2(z1 + i·z2) / 2^shift at scale Δ0: the input of one bootstrap."""
    a = ctx.add(ct1, ctx.conjugate(ct1))           # 2·Re(z1)
    b = ctx.mul_by_i(ctx.add(ct2, ctx.conjugate(ct2)))
    folded = ctx.add(a, b)
    # payload at Δ0·2^-shift, then declare Δ0: the values ÷ 2^shift
    folded = ctx.set_scale(folded, btp.delta0 / 2.0 ** shift)
    folded = folded.with_scale(btp.delta0)
    if folded.level > 0:
        folded = ctx.drop_level(folded, folded.level)
    return folded


def unfold_bl(ctx: CkksContext, boot: Ciphertext):
    """The bootstrapped v = 2(z1 + i·z2)/2^shift → 4(z1, z2)/2^shift:
    v + conj(v) and (v − conj(v))/i."""
    cj = ctx.conjugate(boot)
    return ctx.add(boot, cj), ctx.div_by_i(ctx.sub(boot, cj))


def eval_conv_bl_boot_relu(ctx: CkksContext, btp, ct1: Ciphertext,
                           ct2: Ciphertext, alpha: float = 0.0,
                           pow_: float = 4.0, *, shift: float):
    """Imaginary-part packing around ONE bootstrap (test_BL.go:113-168):
    fold two real slot ciphertexts into re + i·im, a whole bootstrap
    (CtoS, EvalMod, then StoC at the high level `btp` was built with),
    unfold with a conjugation, then the minimax ReLU on both, on z/2^pow.

    shift: log2 of what the packed values 2(z1 + i·z2) are divided by
    before the bootstrap.  At pow + 2, the JAX package's fixed choice,
    they stay within ±1/2 for every |z| ≤ 2^pow and the unfolded 4z/2^shift
    are z/2^pow as they stand.  The bootstrap's error is absolute (about
    5e-4 a slot on the fork's chains), so a smaller shift buys precision
    while the payload's coefficients stay inside EvalMod's range; the
    unfolded values are then brought to z/2^pow at the chain's scale by a
    set_scale, one level, as the Go baseline does after its bootstrap
    (test_BL.go:165).  Only declaring the scale would hand the ReLU an
    input scale 2^(pow+2-shift) too large, which its polynomials' powers
    overflow once |z| nears 2^(pow-1).  ``utils/bl_range.py`` measures
    both sides.

    btp must be a SplitBootstrapper built with stoc_level just under the
    EvalMod region, so the refreshed ciphertexts keep the ReLU's depth
    (and one level more when shift < pow + 2)."""
    up, low = btp.ctos(fold_bl(ctx, btp, ct1, ct2, shift))
    unit = 2.0 ** (pow_ + 2 - shift)
    out = []
    for ct in unfold_bl(ctx, btp.stoc(up, low)):
        x = ct.with_scale(ct.scale * unit)
        if unit != 1.0:
            x = ctx.set_scale(x, ctx.params.scale)
        r = eval_relu(ctx, x, alpha)
        out.append(ctx.mul_scalar_int(r, 1 << int(pow_)))
    return out[0], out[1]


def post_trim_bl(in_vals: np.ndarray, raw_in_wid: int,
                 in_wid: int) -> np.ndarray:
    """Crop the valid raw² region of every channel block, keeping the
    channel-major BL order (post_trim_BL, main.go:1073)."""
    vals = np.real(np.asarray(in_vals))
    batch = len(vals) // (in_wid * in_wid)
    out = np.zeros(raw_in_wid * raw_in_wid * batch)
    for b in range(batch):
        blk = vals[b * in_wid * in_wid:(b + 1) * in_wid * in_wid]
        out[b * raw_in_wid * raw_in_wid:(b + 1) * raw_in_wid * raw_in_wid] = \
            blk.reshape(in_wid, in_wid)[:raw_in_wid, :raw_in_wid].ravel()
    return out


def post_process_bl(in_vals: np.ndarray, raw_in_wid: int) -> np.ndarray:
    """Channel-major BL layout → (i, j, b) interleaved raw order
    (post_process_BL, main.go:1089)."""
    vals = np.asarray(in_vals)
    batch = len(vals) // (raw_in_wid * raw_in_wid)
    return vals.reshape(batch, raw_in_wid, raw_in_wid).transpose(1, 2, 0).ravel()


def conv_bl_split(ctx: CkksContext, ct1: Ciphertext, ct2: Ciphertext,
                  ker_in: np.ndarray, bn_a: np.ndarray, bn_b: np.ndarray,
                  in_wid: int, ker_wid: int, real_batch: int,
                  pad: int) -> list[Ciphertext]:
    """The BL test's 2-ct × 2×2 block conv: the channels are split over
    two ciphertexts (ct1 = channels [0, B/2), ct2 = the rest); each of
    the two output halves sums a conv from each input half
    (test_BL.go:82-110)."""
    hb = real_batch // 2
    ker = np.asarray(ker_in).reshape(ker_wid * ker_wid, real_batch,
                                     real_batch)
    zeros = np.zeros(hb)
    out = []
    for pos in range(2):
        k0 = ker[:, :hb, pos * hb:(pos + 1) * hb].ravel()
        k1 = ker[:, hb:, pos * hb:(pos + 1) * hb].ravel()
        a = eval_conv_bn_bl(ctx, ct1, k0, bn_a[pos * hb:(pos + 1) * hb],
                            bn_b[pos * hb:(pos + 1) * hb], in_wid, ker_wid,
                            hb, hb, pad)
        b = eval_conv_bn_bl(ctx, ct2, k1, bn_a[pos * hb:(pos + 1) * hb],
                            zeros, in_wid, ker_wid, hb, hb, pad)
        out.append(ctx.add(a, b))
    return out


def eval_rmfc_bl_img(ctx: CkksContext, ct_in: Ciphertext, ker_fc: np.ndarray,
                     in_batch: int, out_num: int,
                     raw_in_wid: int) -> Ciphertext:
    """ImageNet-tail reduce-mean + FC: rotate-sum 64 slots a channel block
    (only raw² are nonzero), then the diagonal method over 64-slot
    blocks (evalRMFC_BL_img, eval.go:187-218)."""
    p = ctx.params
    rs_ker = np.asarray(ker_fc).reshape(in_batch, out_num) \
        / float(raw_in_wid * raw_in_wid)
    ct_avg = ct_in
    i = 1
    while i < 64:
        ct_avg = ctx.add(ct_avg, ctx.rotate(ct_avg, i))
        i *= 2
    ct_res = None
    for i in range(in_batch):
        tmp = np.zeros(p.slots, dtype=np.complex128)
        for j in range(out_num):
            tmp[(i + j) % in_batch * 64] = rs_ker[(i + j) % in_batch, j]
        pl = ctx.encoder.encode_slots(tmp, p.scale, ct_avg.level)
        t = ctx.mul_plain(ct_avg, pl)
        if i == 0:
            ct_res = t
        else:
            ct_res = ctx.add(ct_res, ctx.rotate(t, i * 64))
    return ct_res


def eval_rmfc_bl(ctx: CkksContext, ct_in: Ciphertext, fc_w: np.ndarray,
                 fc_b: np.ndarray, in_batch: int, spatial: int) -> Ciphertext:
    """Reduce-mean + FC by a rotate-sum and the diagonal method
    (evalRMFC_BL)."""
    p = ctx.params
    out_num = fc_w.shape[1]
    blk = p.slots // in_batch            # slots a channel block
    # rotate-and-sum the spatial positions (power-of-two ladder)
    ct_avg = ct_in
    step = 1
    while step < spatial:
        ct_avg = ctx.add(ct_avg, ctx.rotate(ct_avg, step))
        step *= 2
    # diagonal method over channel blocks
    ct_res = None
    for d in range(in_batch):
        diag = np.zeros(p.slots, dtype=np.complex128)
        used = False
        for j in range(out_num):
            src = (d + j) % in_batch
            diag[src * blk] = fc_w[src, j] / spatial
            used = True
        if not used:
            continue
        pt = ctx.encoder.encode_slots(diag, p.scale, ct_avg.level)
        t = ctx.mul_plain(ct_avg, pt)
        if d:
            t = ctx.rotate(t, d * blk)
        ct_res = t if ct_res is None else ctx.add(ct_res, t)
    bias = np.zeros(p.slots, dtype=np.complex128)
    for j in range(out_num):
        bias[j * blk] = fc_b[j]
    pt_b = ctx.encoder.encode_slots(bias, ct_res.scale, ct_res.level,
                                    mont=False)
    return ctx.add_plain(ct_res, pt_b)
