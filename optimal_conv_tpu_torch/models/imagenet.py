"""Encrypted ImageNet tail blocks (14×14×256 → 7×7×512 → FC-1000).

Counterpart of ``optimal_conv_tpu/models/imagenet.py``: the Go fork's
``testImagenet_sparse`` (test.go:1402-1607) and
``testImagenet_final_fast_in`` (test.go:1209-1400) with the model parts
of ``newContext`` (main.go:225-263, :378-404).  Two conv blocks on the
16² and 8² grids, a stride-2 transition between them, and two heads:

  features  an identity-FC reduce-mean conv (``_identity_fc``): block 2's
            channel means at the centre position
  logits    the RMFC head: one 7×7 conv whose every tap is the FC matrix,
            BN scale 1/kp², BN bias the FC bias; the 1000 logits at
            1-based grid position (4, 4), output stride 1

``ImagenetTailRunner`` keeps block 1 at full packing (log_sparse 0) and
block 2 half-sparse (log_sparse 1, channel c at slot 2c); its transition
is two split-kernel ``StrConv_sparse_full`` convs, the odd half shifted
by X^2.  ``ImagenetFinalFastRunner`` keeps both blocks at full packing;
its transition is two plain ``StrConv`` on the out-channel halves at
pack_pos 0 and 1, summed.

``infer_features`` and ``infer_logits`` run the blocks and then a head
(``features_head``, ``logits_head``), as the JAX package does; a caller
that wants both heads on one image calls ``_run_blocks`` once and each
head on its result.  The layers and heads are reached through this
module's global names ``eval_conv_bn_relu`` and ``convops``, so a caller
can wrap them (to time, check or record each).  Spans
(``utils/tracing.py``): ``infer_features`` / ``infer_logits`` are the
root ``image``, ``encrypt_input`` is ``encrypt``, each head ``head``;
``ImagenetFinalFastRunner``'s transition is a span ``transition``
(attributes kind "StrConv" and halves 2) around its two fused-layer
calls and their sum.
"""

from __future__ import annotations

import numpy as np

from ..ckks.bootstrap import BootstrapperFamily
from ..ckks.context import CkksContext
from ..ckks.types import Ciphertext
from ..ops import conv as convops
from ..ops import repack as rp
from ..ops.pipeline import LayerMaps, eval_conv_bn_relu
from ..utils import tracing
from .resnet import Layout

HEAD_KW = 7                      # the RMFC head's taps (test.go:1591)
HEAD_SCALE = float(1 << 30)


def _identity_fc(ch: int, raw: int):
    """Reduce-mean 'conv' with identity channel mixing (feature readout,
    ``optimal_conv_tpu/models/imagenet.py:145-152``)."""
    kw = raw if raw % 2 == 1 else raw + 1
    ker = np.zeros((kw, kw, ch, ch))
    ker[:, :] = np.eye(ch)
    bn_a = np.full(ch, 1.0 / (raw * raw))
    bn_b = np.zeros(ch)
    return ker.ravel(), bn_a, bn_b


def tail_comprs_maps(vec_size: int, kp_wid: int, ul: int):
    """The tail transition's two-stage compression maps:
    ``gen_comprs_sparse(vec_size, 16, kp_wid, 0, ul, 0)`` with one repair
    (F9 in ROADMAP.md).  Where the batch exceeds 8·min_wid (logN ≥ 15:
    256 channels on the 16² grid at logN 16) that generator splits the
    channels into 8 blocks and rotates block bk's first stage by
    (8 − 1)·bk·min_wid²/2; the second stage's masks expect it at
    3·bk·min_wid²/2 (the source rows are min_wid·in_wid = 4·min_wid²/2
    apart), as they do with 4 blocks, where the two agree.  With 8 blocks
    only block 0 survives: 32 of a half's 256 channels.  The masks are
    the generator's; only the keys of the first stage move.  Elsewhere
    the maps are the generator's unchanged."""
    in_wid, min_wid = 16, 8
    m_idx, r_idx = rp.gen_comprs_sparse(vec_size, in_wid, kp_wid, 0, ul, 0)
    bks = 8
    if 2 * vec_size // (in_wid * in_wid) <= bks * min_wid:
        return m_idx, r_idx
    step = min_wid * min_wid // 2
    fixed = {}
    for rot, mask in m_idx.items():
        bk, j_rot = divmod(rot, (bks - 1) * step)
        fixed[j_rot + 3 * bk * step] = mask
    assert len(fixed) == len(m_idx)
    return fixed, r_idx


class _ImagenetRunner(Layout):
    """What both tails share: the grids, the input layout, the heads.

    Block `blk` keeps pixel (i, j) of its kp_wids[blk]² map at position
    (i, j) of the in_wids[blk]² grid, channel c at slot c·norm[blk]
    (``Layout``): block 1 channel c at coefficient c + 256·(16·i + j) at
    logN 16, block 2 where the heads read it."""

    in_wids = (16, 8)

    def __init__(self, ctx: CkksContext, ker_wid: int, boot_kwargs,
                 num_blc: tuple[int, int]):
        self.ctx = ctx
        self.ker_wid = ker_wid
        self.kp_wids = (14, 7 if ker_wid == 3 else 6)
        self.num_blc = num_blc
        self.btps = BootstrapperFamily(ctx, boot_kwargs)

    def layout(self, blk: int) -> tuple:
        w = self.in_wids[blk]
        return w, self.ctx.params.n // (w * w), 1, self.norm[blk]

    def raw_wid(self, blk: int) -> int:
        return self.kp_wids[blk]

    @tracing.spanned("encrypt")
    def encrypt_input(self, x: np.ndarray) -> Ciphertext:
        """x [14, 14, C0] (C0 at most block 1's full batch) → level-1 ct,
        channel b at coefficient b + max_batch·(16·i + j)."""
        p = self.ctx.params
        return self.ctx.encrypt(self.ctx.encoder.encode_coeffs(
            self.pack(x, 0), p.scale, 1))

    @tracing.spanned("image")
    def infer_features(self, x: np.ndarray, convs: list, bn_a: list,
                       bn_b: list, init_pow=6.0, mid_pow=5.0) -> np.ndarray:
        """Run the two blocks; returns decrypted feature coefficients."""
        return self.features_head(
            self._run_blocks(x, convs, bn_a, bn_b, init_pow, mid_pow))

    @tracing.spanned("image")
    def infer_logits(self, x: np.ndarray, convs: list, bn_a: list,
                     bn_b: list, fc_w: np.ndarray, fc_b: np.ndarray,
                     init_pow=6.0, mid_pow=5.0) -> np.ndarray:
        """Blocks + the 1000-way RMFC head → the decrypted logits."""
        return self.logits_head(
            self._run_blocks(x, convs, bn_a, bn_b, init_pow, mid_pow),
            fc_w, fc_b)

    def _ctr(self) -> int:
        """Coefficient of the head's output at 1-based position (4, 4)."""
        mb = self.ctx.params.n // (8 * 8)
        return (HEAD_KW // 2) * 8 * mb + (HEAD_KW // 2) * mb

    @tracing.spanned("head")
    def features_head(self, ct: Ciphertext) -> np.ndarray:
        """The identity-FC head on block 2's output → every decrypted
        coefficient; ``features`` reads the means out of them."""
        b1, kp = self.real_batch[1], self.kp_wids[1]
        out = convops.eval_conv_bn(self.ctx, ct, *_identity_fc(b1, kp), 8,
                                   kp | 1, b1, b1, self.norm[1], HEAD_SCALE)
        return self.ctx.decrypt_decode_coeffs(out)

    def features(self, cfs: np.ndarray) -> np.ndarray:
        """Block 2's b1 channel means in ``features_head``'s output: the
        centre position, channel stride norm[1]."""
        nm, ctr = self.norm[1], self._ctr()
        return np.asarray(cfs)[ctr: ctr + nm * self.real_batch[1]: nm]

    @tracing.spanned("head")
    def logits_head(self, ct: Ciphertext, fc_w: np.ndarray,
                    fc_b: np.ndarray) -> np.ndarray:
        """The RMFC head (reduce-mean + FC as one conv with the FC matrix
        at every tap, bn_a = 1/kp²) → the decrypted logits.  It reads
        block 2's channels at stride norm[1] and writes the logits at
        stride 1: 1000 > max_batch / 2 would not fit at stride 2."""
        b1, kp = self.real_batch[1], self.kp_wids[1]
        n_out = fc_w.shape[1]
        ker = np.broadcast_to(fc_w[None, None], (HEAD_KW, HEAD_KW, b1, n_out))
        out = convops.eval_conv_bn(self.ctx, ct, ker.ravel(),
                                   np.full(n_out, 1.0 / (kp * kp)),
                                   np.asarray(fc_b), 8, HEAD_KW, b1, n_out, 1,
                                   HEAD_SCALE, in_norm=self.norm[1])
        cfs = self.ctx.decrypt_decode_coeffs(out)
        return cfs[self._ctr(): self._ctr() + n_out]


class ImagenetTailRunner(_ImagenetRunner):
    """``testImagenet_sparse``: block 1 ``Conv_sparse`` at log_sparse 0,
    the transition two split-kernel ``StrConv_sparse_full`` convs (even
    and odd out-channels, the odd shifted by X^norm[1]), block 2
    ``Conv_sparse`` at log_sparse 1 (JAX ``imagenet.py:29-142``)."""

    # the pixels the stride-2 transition keeps: y[2i, 2j] of the 14²
    # conv output (the pipeline shifts by X^(-max_batch·17) only when
    # in_wid − ker_wid/2 is even); the plain model and the final-fast
    # runner keep y[2i+1, 2j+1] (F9 in ROADMAP.md)
    stride_phase = 0

    def __init__(self, ctx: CkksContext, ker_wid: int = 3,
                 boot_kwargs: dict | None = None,
                 num_blc: tuple[int, int] = (3, 3)):
        super().__init__(ctx, ker_wid, boot_kwargs, num_blc)
        n = ctx.params.n
        # full pack on the 16² grid, half sparse on the 8² grid
        self.real_batch = (n // 256, n // 128)
        self.norm = (1, 2)
        self.log_sparse = (0, 1)
        vec = n // 2
        kp0, kp1 = self.kp_wids
        self.keep_maps = [
            LayerMaps(ext_idx=[rp.gen_keep_vec(vec, 16, kp0, 0),
                               rp.gen_keep_vec(vec, 16, kp0, 1)]),
            LayerMaps(ext_idx=[rp.gen_keep_vec_sparse(vec, 8, kp1, 1), None]),
        ]
        m0, r0 = tail_comprs_maps(vec, kp1, 0)
        m1, r1 = tail_comprs_maps(vec, kp1, 1)
        self.str_maps = LayerMaps(m_idx=m0, r_idx=r0, m_idx_l=m1, r_idx_l=r1)

    def transition_channels(self, h: int) -> np.ndarray:
        """Block 2's layout channels that transition half h's output holds
        before the sum: channel k of either half at 2k; the X^norm[1]
        shift then moves the odd half's to 2k + 1."""
        return 2 * np.arange(self.real_batch[1] // 2)

    def _run_blocks(self, x: np.ndarray, convs: list, bn_a: list,
                    bn_b: list, init_pow: float, mid_pow: float) -> Ciphertext:
        ctx = self.ctx
        ct = self.encrypt_input(x)
        li = 0
        pow_ = init_pow
        b0, b1 = self.real_batch
        for i in range(self.num_blc[0]):
            if i == self.num_blc[0] - 1:
                pow_ = mid_pow
            ct = eval_conv_bn_relu(
                ctx, self.btps, ct, convs[li].ravel(), bn_a[li], bn_b[li],
                0.0, pow_, 16, self.kp_wids[0], self.ker_wid, b0, b0,
                1, 0, 1, 2, 0, "Conv_sparse", self.keep_maps[0])
            li += 1
        # transition: the even and the odd out-channels, each a full
        # strided conv; the odd half lands norm[1] slots further
        ker = convs[li]
        halves = [eval_conv_bn_relu(
            ctx, self.btps, ct, ker[:, :, :, h::2].ravel(), bn_a[li][h::2],
            bn_b[li][h::2], 0.0, pow_, 16, self.kp_wids[1], self.ker_wid,
            b0, b1 // 2, 1, 0, 1, 2, 0, "StrConv_sparse_full", self.str_maps)
            for h in (0, 1)]
        ct = ctx.add(halves[0], ctx.mul_monomial(halves[1], self.norm[1]))
        li += 1
        for _ in range(self.num_blc[1]):
            ct = eval_conv_bn_relu(
                ctx, self.btps, ct, convs[li].ravel(), bn_a[li], bn_b[li],
                0.0, pow_, 8, self.kp_wids[1], self.ker_wid, b1, b1,
                2, 0, 1, 2, 1, "Conv_sparse", self.keep_maps[1])
            li += 1
        return ct


class ImagenetFinalFastRunner(_ImagenetRunner):
    """``Imagenet_final_fast``: both blocks full-pack ``Conv`` with
    ``gen_keep_vec`` masks; the transition two plain ``StrConv`` on the
    out-channel halves at pack_pos 0 and 1 (single-stage
    ``gen_comprs_full`` maps with kp = 2·kp_wids[1]), summed (JAX
    ``imagenet.py:155-268``)."""

    # the transition keeps y[2i+1, 2j+1], as ``conv_bn_relu_plain`` does
    stride_phase = 1

    def __init__(self, ctx: CkksContext, ker_wid: int = 3,
                 boot_kwargs: dict | None = None,
                 num_blc: tuple[int, int] = (3, 3)):
        super().__init__(ctx, ker_wid, boot_kwargs, num_blc)
        n = ctx.params.n
        self.real_batch = (n // 256, 2 * (n // 256))
        self.norm = (1, 1)
        vec = n // 2
        self.keep_maps = [
            LayerMaps(ext_idx=[rp.gen_keep_vec(vec, w, kp, ul)
                               for ul in (0, 1)])
            for w, kp in zip(self.in_wids, self.kp_wids)]
        kp2 = 2 * self.kp_wids[1]
        self.str_maps = [
            LayerMaps(r_idx=rp.gen_comprs_full(vec, 16, kp2, pos, 0),
                      r_idx_l=rp.gen_comprs_full(vec, 16, kp2, pos, 1))
            for pos in range(2)]

    def transition_channels(self, h: int) -> np.ndarray:
        """Block 2's layout channels that transition half (pack_pos) h's
        output holds: channel k of the half at h·b1/2 + k."""
        half = self.real_batch[1] // 2
        return h * half + np.arange(half)

    def _run_blocks(self, x: np.ndarray, convs: list, bn_a: list,
                    bn_b: list, init_pow: float, mid_pow: float) -> Ciphertext:
        ctx = self.ctx
        ct = self.encrypt_input(x)
        li = 0
        pow_ = init_pow
        b0, b1 = self.real_batch
        for i in range(self.num_blc[0]):
            if i == self.num_blc[0] - 1:
                pow_ = mid_pow
            ct = eval_conv_bn_relu(
                ctx, self.btps, ct, convs[li].ravel(), bn_a[li], bn_b[li],
                0.0, pow_, 16, self.kp_wids[0], self.ker_wid, b0, b0,
                1, 0, 1, 2, 0, "Conv", self.keep_maps[0])
            li += 1
        # transition: out-channel halves as two plain StrConvs at pos 0/1
        ker = convs[li]
        halves = []
        with tracing.span("transition", kind="StrConv", halves=2):
            for pos in range(2):
                sl = slice(pos * b1 // 2, (pos + 1) * b1 // 2)
                halves.append(eval_conv_bn_relu(
                    ctx, self.btps, ct, ker[:, :, :, sl].ravel(),
                    bn_a[li][sl], bn_b[li][sl], 0.0, pow_, 16,
                    2 * self.kp_wids[1], self.ker_wid, b0, b0, 1, pos, 1, 2,
                    0, "StrConv", self.str_maps[pos]))
            ct = ctx.add(halves[0], halves[1])
        li += 1
        for _ in range(self.num_blc[1]):
            ct = eval_conv_bn_relu(
                ctx, self.btps, ct, convs[li].ravel(), bn_a[li], bn_b[li],
                0.0, pow_, 8, self.kp_wids[1], self.ker_wid, b1, b1,
                1, 0, 1, 2, 0, "Conv", self.keep_maps[1])
            li += 1
        return ct
