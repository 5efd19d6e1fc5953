"""Encrypted ResNet (plain conv-BN-ReLU stack): the sparse-packed and the
crop_fast pipelines.

Counterpart of ``ResNetConfig``, ``ResNetRunner``, ``FastResNetRunner``
and ``WideFastResNetRunner`` of ``optimal_conv_tpu/models/resnet.py``.
The fast runners keep every layer at log_sparse 0 on the block-1 grid
and dilate the kernels instead of repacking (their docstrings give the
geometry).  ``ResNetRunner`` runs the Go reference's flagship workload
``testResNet_crop_sparse`` (test.go:76-370) and the model-specific parts
of ``newContext`` (main.go:137-224).  Three conv blocks at log_sparse
2/3/4 with split-kernel strided transitions at log_sparse 1/2, one
bootstrap per layer, and the reduce-mean + FC head evaluated as one
coefficient-domain conv: a kw×kw kernel (kw the odd cover of the valid
width) whose every tap is the FC weight, BN scale 1/raw², BN bias the FC
bias; the logits land at the centre position with channel stride norm.
The head needs no bootstrapping; for fc_out > real_batch[2] (CIFAR-100)
it is two half-width convs (test.go:281-338).

Widths are parameters, so the same graph runs miniaturised in tests
(logN 10 ⇒ 16×16 inputs) and at full CIFAR scale (logN 16 ⇒ 32×32,
real_batch (16,32,64), norm (4,8,16)) on the card.

Spans (``utils/tracing.py``): a runner's ``infer`` is the root ``image``;
``encrypt_image`` is ``encrypt`` and the FC head ``head``; the fused
layers open their own ``layer`` spans.  ``WideFastResNetRunner``'s
``StrConv_odd`` step is a span ``transition`` (attributes kind and
halves: its fused-layer calls, 1 at wide 2, 2 at wide 3, whose sum it
also holds).
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass

import numpy as np

from ..ckks.bootstrap import BootstrapperFamily
from ..ckks.context import CkksContext
from ..ckks.types import Ciphertext
from ..interop import ciphertext_from_arrays, to_numpy
from ..ops import conv as convops
from ..ops import repack as rp
from ..ops.pipeline import LayerMaps, eval_conv_bn_relu
from ..utils import tracing
from .plain import NUM_BLOCKS, ResNetWeights


@dataclass
class ResNetConfig:
    ker_wid: int = 3
    depth: int = 20
    cf100: bool = False
    # packing geometry; defaults = the Go reference's CIFAR shapes at
    # logN 16.
    # wide=2: real_batch (32,64,128), wide=3: (48,96,192)
    # (test.go:680-693)
    in_wids: tuple = (32, 16, 8)
    real_batch: tuple = (16, 32, 64)
    wide: int = 1
    init_batch: int = 16          # first-layer width for wide models
    fc_out: int = 10
    init_pow: float = 6.0
    mid_pow: float = 6.0
    final_pow: float = 6.0
    alpha: float = 0.0

    @property
    def raw_in_wids(self) -> tuple:
        k = self.ker_wid
        return tuple(w - k // 2 for w in self.in_wids)


def _fc_geometry(ctx: CkksContext, cfg: ResNetConfig):
    in_wid = cfg.in_wids[2]
    max_batch = ctx.params.n // (in_wid * in_wid)
    return in_wid, max_batch, max_batch // cfg.real_batch[2]


def encrypt_fc_input(ctx: CkksContext, cfg: ResNetConfig,
                     x: np.ndarray) -> Ciphertext:
    """Encrypt last-block features x [raw, raw, real_batch[2]] in the
    head's input layout (channel stride norm) at the ECD level."""
    in_wid, _, norm = _fc_geometry(ctx, cfg)
    raw = cfg.raw_in_wids[2]
    p = ctx.params
    inp = convops.prep_input(np.asarray(x).ravel(), raw, in_wid, p.n, norm)
    return ctx.encrypt(ctx.encoder.encode_coeffs(inp, p.scale,
                                                 convops.ECD_LEVEL))


def fc_conv(ctx: CkksContext, cfg: ResNetConfig, ct: Ciphertext,
            fc_w: np.ndarray, fc_b: np.ndarray) -> np.ndarray:
    """Reduce-mean + FC of the encrypted features → decrypted logits.

    fc_w: [real_batch[2], n_out].  For n_out > real_batch[2] the head
    splits into two half-width convs, as the Go reference does
    (test.go:291-317)."""
    return _split_head(lambda w_, b_: _fc_conv(ctx, cfg, ct, w_, b_), cfg,
                       fc_w, fc_b)


def _split_head(conv, cfg: ResNetConfig, fc_w: np.ndarray,
                fc_b: np.ndarray) -> np.ndarray:
    """conv(fc_w, fc_b) once, or on each half of the outputs when there
    are more than real_batch[2] of them."""
    b3 = cfg.real_batch[2]
    n_out = fc_w.shape[1]
    if n_out <= b3:
        return conv(fc_w, fc_b)
    assert n_out % 2 == 0 and n_out // 2 <= b3
    lo = conv(fc_w[:, : n_out // 2], fc_b[: n_out // 2])
    hi = conv(fc_w[:, n_out // 2:], fc_b[n_out // 2:])
    return np.concatenate([lo, hi])


def _fc_conv(ctx: CkksContext, cfg: ResNetConfig, ct: Ciphertext,
             fc_w: np.ndarray, fc_b: np.ndarray) -> np.ndarray:
    in_wid, _, norm = _fc_geometry(ctx, cfg)
    return head_conv(ctx, cfg, ct, fc_w, fc_b, in_wid, cfg.raw_in_wids[2],
                     norm)


def head_conv(ctx: CkksContext, cfg: ResNetConfig, ct: Ciphertext,
              fc_w: np.ndarray, fc_b: np.ndarray, in_wid: int, cover: int,
              norm: int) -> np.ndarray:
    """The head as one conv on the in_wid grid: a kw×kw kernel, kw the odd
    cover of `cover` pixels, whose every tap is the FC weight, BN scale
    1/raw² (raw of the last block), BN bias the FC bias.  The logits are
    read at position (kw/2, kw/2), channel stride norm."""
    raw2 = cfg.raw_in_wids[2]
    kw = cover if cover % 2 == 1 else cover + 1
    b3 = cfg.real_batch[2]
    n_out = fc_w.shape[1]
    mb = ctx.params.n // (in_wid * in_wid)
    ker = np.broadcast_to(fc_w[None, None], (kw, kw, b3, n_out)).copy()
    bn_a = np.full(n_out, 1.0 / (raw2 * raw2))
    out = convops.eval_conv_bn(ctx, ct, ker.ravel(), bn_a, np.asarray(fc_b),
                               in_wid, kw, b3, n_out, norm, float(1 << 30))
    cfs = ctx.decrypt_decode_coeffs(out)
    ctr = (kw // 2) * in_wid * mb + (kw // 2) * mb
    return cfs[ctr: ctr + norm * n_out: norm]


class Layout:
    """Where a runner keeps the features of each block in the N
    coefficients: pixel (i, j) of the block's raw² map at grid position
    (step·i + init, step·j + init) of an in_wid² grid with max_batch
    channel slots a position, channel c at slot c·norm.  init is
    step − 1 for an even raw width, else 0, as ``gen_keep_vec_stride``
    keeps it.  A runner gives ``layout(blk)`` → (in_wid, max_batch,
    step, norm) and ``raw_wid(blk)``; the layers' keep masks and strided
    maps put each layer's output there."""

    def raw_wid(self, blk: int) -> int:
        return self.cfg.raw_in_wids[blk]

    def _index(self, blk: int, n_ch: int) -> np.ndarray:
        in_wid, mb, step, norm = self.layout(blk)
        raw = self.raw_wid(blk)
        init = 0 if raw % 2 == 1 else step - 1
        pos = step * np.arange(raw) + init
        return (pos[:, None, None] * in_wid * mb + pos[None, :, None] * mb
                + norm * np.arange(n_ch)[None, None, :])

    def pack(self, x: np.ndarray, blk: int) -> np.ndarray:
        """Features x [raw, raw, C] of block `blk` → N coefficients."""
        out = np.zeros(self.ctx.params.n)
        out[self._index(blk, x.shape[-1])] = x
        return out

    def unpack(self, cfs: np.ndarray, blk: int, n_ch: int) -> np.ndarray:
        """N coefficients → the features [raw, raw, n_ch] of block `blk`."""
        return np.asarray(cfs)[self._index(blk, n_ch)]

    def packed_image(self, image: np.ndarray) -> np.ndarray:
        """image [raw0, raw0, C] → the N coefficients ``encrypt_image``
        encodes: only the image's own channels, at stride norm (the Go
        reference's inline loop, test.go:140-148)."""
        return self.pack(image, 0)

    @tracing.spanned("encrypt")
    def encrypt_image(self, image: np.ndarray) -> Ciphertext:
        """image [raw0, raw0, C] → packed level-1 ciphertext."""
        p = self.ctx.params
        pt = self.ctx.encoder.encode_coeffs(self.packed_image(image),
                                            p.scale, 1)
        return self.ctx.encrypt(pt)


class ResNetRunner(Layout):
    """Builds the per-model repack tables and the bootstrapper family,
    then runs encrypted inference layer by layer (one fused
    conv-BN-ReLU-boot per layer), as testResNet_crop_sparse does.

    ``infer`` calls ``eval_conv_bn_relu`` through this module's global
    name, so a caller can wrap it (to time or record each layer)."""

    def __init__(self, ctx: CkksContext, cfg: ResNetConfig,
                 boot_kwargs: dict | None = None):
        self.ctx = ctx
        self.cfg = cfg
        p = ctx.params
        n = p.n
        self.max_batch = [n // (w * w) for w in cfg.in_wids]
        self.norm = [mb // rb for mb, rb in zip(self.max_batch, cfg.real_batch)]
        self.log_sparse = [int(np.log2(v)) for v in self.norm]
        assert all(1 << ls == v for ls, v in zip(self.log_sparse, self.norm))

        raw = cfg.raw_in_wids
        vec = n // 2

        # keep-masks per block: sparse for ls≥1, up/low pair for full pack
        # (gen_keep_vec[_sparse], main.go:137-162 incl. wide3 branch)
        self.keep_maps = []
        for i, w in enumerate(cfg.in_wids):
            if self.log_sparse[i] == 0:
                self.keep_maps.append(LayerMaps(ext_idx=[
                    rp.gen_keep_vec(vec, w, raw[i], 0),
                    rp.gen_keep_vec(vec, w, raw[i], 1)]))
            else:
                mask = rp.gen_keep_vec_sparse(vec, w, raw[i],
                                              self.log_sparse[i])
                self.keep_maps.append(LayerMaps(ext_idx=[mask, None]))

        # strided-transition maps (gen_comprs_sparse, main.go:164-224):
        # combined stride-conv ct has log_sparse = ls_in − 1 (or 0 for the
        # wide3 StrConv_sparse_full transition); full pack needs both
        # up/low map sets
        self.str_maps = []
        self.str_ls = []
        for i in (0, 1):
            ls_comb = max(self.log_sparse[i] - 1, 0)
            m_idx, r_idx = rp.gen_comprs_sparse(vec, cfg.in_wids[i],
                                                raw[i + 1], ls_comb, 0, 0)
            maps = LayerMaps(m_idx=m_idx, r_idx=r_idx)
            if ls_comb == 0:
                maps.m_idx_l, maps.r_idx_l = rp.gen_comprs_sparse(
                    vec, cfg.in_wids[i], raw[i + 1], 0, 1, 0)
            self.str_maps.append(maps)
            self.str_ls.append(ls_comb)

        # one bootstrapper per log_sparse in use, built at first use
        self.btps = BootstrapperFamily(ctx, boot_kwargs)

    # ------------------------------------------------------------------

    def layout(self, blk: int) -> tuple:
        """(in_wid, max_batch, step, norm) of block `blk`'s features."""
        return (self.cfg.in_wids[blk], self.max_batch[blk], 1,
                self.norm[blk])

    @tracing.spanned("image")
    def infer(self, image: np.ndarray, w: ResNetWeights,
              timings: dict | None = None,
              ckpt_dir: str | None = None) -> np.ndarray:
        """Logits of one image.  `timings` receives the host seconds of
        each block (blc1, blc1to2, blc2, blc2to3, blc3, fc).

        ckpt_dir: after each fused layer the output ciphertext is written
        to `ckpt_dir/layer.npz` (overwriting the previous one), and an
        interrupted inference resumes after the last completed layer on
        the next call.  The ciphertext is saved encrypted; nothing is
        decrypted."""
        ctx, cfg = self.ctx, self.cfg
        n1, n2, n3 = NUM_BLOCKS[cfg.depth]
        raw = cfg.raw_in_wids
        rb = cfg.real_batch
        ct = self.encrypt_image(image)
        li = 0
        t0 = time.perf_counter()
        tm = timings if timings is not None else {}

        resume_li = -1
        ckpt_path = None
        if ckpt_dir is not None:
            os.makedirs(ckpt_dir, exist_ok=True)
            ckpt_path = os.path.join(ckpt_dir, "layer.npz")
            if os.path.exists(ckpt_path):
                z = np.load(ckpt_path)
                resume_li = int(z["li"])
                resume_ct = ciphertext_from_arrays(
                    ctx, z["c0"], z["c1"], int(z["level"]), float(z["scale"]))
                print(f"  resuming after layer {resume_li} "
                      f"(level {resume_ct.level})", flush=True)

        def layer(ct, li, in_idx, kind, pow_, maps, ls, real_ib, real_ob,
                  norm, n_iter=2):
            if li <= resume_li:
                return resume_ct if li == resume_li else ct
            t = time.perf_counter()
            out = eval_conv_bn_relu(
                ctx, self.btps, ct, w.convs[li].ravel(), w.bn_a[li],
                w.bn_b[li], cfg.alpha, pow_, cfg.in_wids[in_idx],
                raw[in_idx if kind != "StrConv_sparse" else in_idx + 1],
                w.convs[li].shape[0], real_ib, real_ob, norm, 0, 1, n_iter,
                ls, kind, maps)
            print(f"  layer {li} ({kind}, ls={ls}) done in "
                  f"{time.perf_counter() - t:.1f}s", flush=True)
            if ckpt_path is not None:
                np.savez(ckpt_path, c0=to_numpy(out.c0), c1=to_numpy(out.c1),
                         level=out.level, scale=out.scale, li=li)
            return out

        pow_ = cfg.init_pow
        for i in range(n1):
            real_ib = w.convs[li].shape[2]
            real_ob = w.convs[li].shape[3]
            ct = layer(ct, li, 0, "Conv_sparse", pow_, self.keep_maps[0],
                       self.log_sparse[0], real_ib, real_ob, self.norm[0])
            pow_ = cfg.mid_pow
            li += 1
        tm["blc1"] = time.perf_counter() - t0
        t0 = time.perf_counter()

        if cfg.wide == 3:
            # full-pack transition: two StrConv_sparse_full halves on the
            # even/odd out-channels, second shifted by X^{norm[1]}, added
            # (test.go:797-818)
            ker = w.convs[li]
            c1 = eval_conv_bn_relu(
                ctx, self.btps, ct, ker[:, :, :, 0::2].ravel(),
                w.bn_a[li][0::2], w.bn_b[li][0::2], cfg.alpha, pow_,
                cfg.in_wids[0], raw[1], ker.shape[0], rb[0], rb[1] // 2,
                self.norm[0], 0, 1, 2, 0, "StrConv_sparse_full",
                self.str_maps[0])
            c2 = eval_conv_bn_relu(
                ctx, self.btps, ct, ker[:, :, :, 1::2].ravel(),
                w.bn_a[li][1::2], w.bn_b[li][1::2], cfg.alpha, pow_,
                cfg.in_wids[0], raw[1], ker.shape[0], rb[0], rb[1] // 2,
                self.norm[0], 0, 1, 2, 0, "StrConv_sparse_full",
                self.str_maps[0])
            # odd half shifted by X^norm[1] (the Go reference hardcodes xi[2]
            # with norm[1]=2, test.go:812)
            ct = ctx.add(c1, ctx.mul_monomial(c2, self.norm[1]))
        else:
            ct = layer(ct, li, 0, "StrConv_sparse", pow_, self.str_maps[0],
                       self.str_ls[0], rb[0], rb[1], self.norm[1])
        li += 1
        tm["blc1to2"] = time.perf_counter() - t0
        t0 = time.perf_counter()

        for _ in range(n2):
            ct = layer(ct, li, 1, "Conv_sparse", pow_, self.keep_maps[1],
                       self.log_sparse[1], rb[1], rb[1], self.norm[1])
            li += 1
        tm["blc2"] = time.perf_counter() - t0
        t0 = time.perf_counter()

        ct = layer(ct, li, 1, "StrConv_sparse", pow_, self.str_maps[1],
                   self.str_ls[1], rb[1], rb[2], self.norm[2])
        li += 1
        tm["blc2to3"] = time.perf_counter() - t0
        t0 = time.perf_counter()

        for j in range(n3):
            if j == n3 - 1:
                pow_ = cfg.final_pow
            ct = layer(ct, li, 2, "Conv_sparse", pow_, self.keep_maps[2],
                       self.log_sparse[2], rb[2], rb[2], self.norm[2])
            li += 1
        tm["blc3"] = time.perf_counter() - t0
        t0 = time.perf_counter()

        logits = self._fc_head(ct, w)
        tm["fc"] = time.perf_counter() - t0
        if ckpt_path is not None and os.path.exists(ckpt_path):
            # inference complete: a stale checkpoint would make the NEXT
            # image resume from this image's activations
            os.remove(ckpt_path)
        return logits

    @tracing.spanned("head")
    def _fc_head(self, ct: Ciphertext, w: ResNetWeights) -> np.ndarray:
        return fc_conv(self.ctx, self.cfg, ct, w.fc_w, w.fc_b)


def _layer_done(what: str, t: float) -> None:
    print(f"  {what} done in {time.perf_counter() - t:.1f}s", flush=True)


class FastResNetRunner(Layout):
    """The crop_fast packing regime (testResNet_crop_fast_in,
    test.go:372-636): every layer stays on the in_wids[0] grid at
    log_sparse 0; the strided transitions double the dilation step
    (1 → 2 → 4) through StrConv_inside with interleaved kernels, and the
    repack is a keep_vec_stride mask per (step, ul) (newContext
    "Resnet_crop_fast", main.go:123-137).  The FC head is one in-grid
    conv with replicated taps; the logits lie at grid position
    (kw/2+1, kw/2+1), 1-based, channel stride norm[2] (test.go:556-636).

    ``infer`` calls ``eval_conv_bn_relu`` through this module's global
    name, as ``ResNetRunner`` does."""

    def __init__(self, ctx: CkksContext, cfg: ResNetConfig,
                 boot_kwargs: dict | None = None):
        self.ctx = ctx
        self.cfg = cfg
        n = ctx.params.n
        w0 = cfg.in_wids[0]
        self.w0 = w0
        self.max_batch = n // (w0 * w0)
        self.norm = [self.max_batch // rb for rb in cfg.real_batch]
        self.steps = (1, 2, 4)
        raw = cfg.raw_in_wids
        vec = n // 2
        self.keep_maps = []
        for i in range(3):
            step = self.steps[i]
            odd = raw[i] % 2 == 1
            self.keep_maps.append(LayerMaps(ext_idx=[
                rp.gen_keep_vec_stride(vec, w0, raw[i], step, 0, odd),
                rp.gen_keep_vec_stride(vec, w0, raw[i], step, 1, odd)]))
        self.btps = BootstrapperFamily(ctx, boot_kwargs)

    def layout(self, blk: int) -> tuple:
        return self.w0, self.max_batch, self.steps[blk], self.norm[blk]

    @staticmethod
    def _interleave_ker(ker: np.ndarray) -> np.ndarray:
        """[kw, kw, ib, ob] → [kw, kw, 2·ib, ob] with the real input
        channels at even slots (the transitions' doubled-batch layout,
        test.go:485-493); the odd slots stay all-zero."""
        kw, _, ib, ob = ker.shape
        out = np.zeros((kw, kw, 2 * ib, ob))
        out[:, :, 0::2] = ker
        return out

    @tracing.spanned("image")
    def infer(self, image: np.ndarray, w: ResNetWeights,
              timings: dict | None = None) -> np.ndarray:
        """Logits of one image.  `timings` receives the host seconds of
        each block (blc1, blc1to2, blc2, blc2to3, blc3, fc)."""
        ctx, cfg = self.ctx, self.cfg
        n1, n2, n3 = NUM_BLOCKS[cfg.depth]
        raw = cfg.raw_in_wids
        rb = cfg.real_batch
        ct = self.encrypt_image(image)
        li = 0
        tm = timings if timings is not None else {}
        t0 = time.perf_counter()

        def layer(ct, li, kind, pow_, blk, ker, real_ib, real_ob, norm):
            t = time.perf_counter()
            step = self.steps[blk]
            out = eval_conv_bn_relu(
                ctx, self.btps, ct, ker.ravel(), w.bn_a[li], w.bn_b[li],
                cfg.alpha, pow_, self.w0, raw[blk], cfg.ker_wid, real_ib,
                real_ob, norm, 0, step, 2, 0, kind, self.keep_maps[blk])
            _layer_done(f"fast layer {li} ({kind}, step={step})", t)
            return out

        pow_ = cfg.init_pow
        for _ in range(n1):
            ct = layer(ct, li, "Conv_inside", pow_, 0, w.convs[li],
                       w.convs[li].shape[2], rb[0], self.norm[0])
            pow_ = cfg.mid_pow
            li += 1
        tm["blc1"] = time.perf_counter() - t0
        t0 = time.perf_counter()

        ct = layer(ct, li, "StrConv_inside", pow_, 1,
                   self._interleave_ker(w.convs[li]), rb[1], rb[1],
                   self.norm[1])
        li += 1
        tm["blc1to2"] = time.perf_counter() - t0
        t0 = time.perf_counter()

        for _ in range(n2):
            ct = layer(ct, li, "Conv_inside", pow_, 1, w.convs[li],
                       rb[1], rb[1], self.norm[1])
            li += 1
        tm["blc2"] = time.perf_counter() - t0
        t0 = time.perf_counter()

        ct = layer(ct, li, "StrConv_inside", pow_, 2,
                   self._interleave_ker(w.convs[li]), rb[2], rb[2],
                   self.norm[2])
        li += 1
        tm["blc2to3"] = time.perf_counter() - t0
        t0 = time.perf_counter()

        for j in range(n3):
            if j == n3 - 1:
                pow_ = cfg.final_pow
            ct = layer(ct, li, "Conv_inside", pow_, 2, w.convs[li],
                       rb[2], rb[2], self.norm[2])
            li += 1
        tm["blc3"] = time.perf_counter() - t0
        t0 = time.perf_counter()

        logits = self._fc_head(ct, w)
        tm["fc"] = time.perf_counter() - t0
        return logits

    @tracing.spanned("head")
    def _fc_head(self, ct: Ciphertext, w: ResNetWeights) -> np.ndarray:
        return _split_head(lambda w_, b_: self._fc_conv(ct, w_, b_), self.cfg,
                           w.fc_w, w.fc_b)

    def _fc_conv(self, ct: Ciphertext, fc_w: np.ndarray,
                 fc_b: np.ndarray) -> np.ndarray:
        """kw = raw0 (or raw0 + 1): the all-ones window centred at
        (kw/2, kw/2), 0-based, covers exactly the step-4 grid features
        {0, s, 2s, ...} (prt_mat_one_norm, main.go:920)."""
        return head_conv(self.ctx, self.cfg, ct, fc_w, fc_b, self.w0,
                         self.cfg.raw_in_wids[0], self.norm[2])


class WideFastResNetRunner(Layout):
    """The wide fast-regime models ``Resnet_crop_fast_wide2/3``
    (testResNet_crop_fast_wide_in, test.go:914-1207; newContext branches
    main.go:264-345).

    Geometry (the Go reference's values at logN 16 in parentheses):
      block 1    plain full-pack "Conv" on the in_wids[0] grid (32),
                 kp = raw[0], channels at stride norm[0]; opens
                 3 → init_batch → real_batch[0] (16 → 32 wide 2, → 48
                 wide 3)
      blc1→2     "StrConv_odd" onto the in_wids[1] grid (16) through
                 gen_comprs_fast maps with kp = 2·raw[1]; wide 2 runs ONE
                 conv with input-interleaved kernels at norm[0]/2, wide 3
                 even/odd out-channel halves at pack_pos 0 and 2, summed
                 (test.go:1060-1100)
      block 2    "Conv_inside" on the in_wids[1] grid, step 1,
                 keep_vec_stride(kp = raw[1]) masks, norm[1]
      blc2→3     "StrConv_inside" step 2 with input-interleaved kernels
                 (2·real_batch[1] → real_batch[2]), norm[2]
      block 3    "Conv_inside" step 2, keep_vec_stride(kp = raw[2])
      head       one (raw[1]|1)-wide replicated-tap conv on the
                 in_wids[1] grid; logits at 1-based (kw/2+1, kw/2+1),
                 stride norm[2] (prt_mat_one_norm, test.go:1195)

    norm is fixed by the wide case, wide 2 (2, 4, 2) and wide 3 (1, 2, 1),
    whatever real_batch is (wide 3 leaves max_batch − real_batch·norm
    channel slots empty, test.go:958-971)."""

    NORMS = {2: (2, 4, 2), 3: (1, 2, 1)}

    def __init__(self, ctx: CkksContext, cfg: ResNetConfig,
                 boot_kwargs: dict | None = None):
        if cfg.wide not in (2, 3):
            raise ValueError("WideFastResNetRunner needs wide 2 or 3")
        self.ctx = ctx
        self.cfg = cfg
        n = ctx.params.n
        w0, w1 = cfg.in_wids[0], cfg.in_wids[1]
        self.max_batch = [n // (w * w) for w in (w0, w1, w1)]
        self.norm = list(self.NORMS[cfg.wide])
        rb = cfg.real_batch
        assert all(b * nm <= mb for b, nm, mb
                   in zip(rb, self.norm, self.max_batch))
        raw = cfg.raw_in_wids
        self.steps = (1, 1, 2)
        vec = n // 2

        # block 1: full-pack keep masks on the w0 grid
        self.keep_maps = [LayerMaps(ext_idx=[
            rp.gen_keep_vec(vec, w0, raw[0], 0),
            rp.gen_keep_vec(vec, w0, raw[0], 1)])]
        # blocks 2/3: stride-step keep masks on the w1 grid
        for i in (1, 2):
            odd = raw[i] % 2 == 1
            self.keep_maps.append(LayerMaps(ext_idx=[
                rp.gen_keep_vec_stride(vec, w1, raw[i], self.steps[i], 0, odd),
                rp.gen_keep_vec_stride(vec, w1, raw[i], self.steps[i], 1,
                                       odd)]))
        # blc1→2 StrConv_odd maps (pos 0; wide 3 also pos 2)
        self.str_maps = {}
        for pos in (0,) if cfg.wide == 2 else (0, 2):
            m0, r0 = rp.gen_comprs_fast(vec, w0, 2 * raw[1], pos, 0)
            m1, r1 = rp.gen_comprs_fast(vec, w0, 2 * raw[1], pos, 1)
            self.str_maps[pos] = LayerMaps(m_idx=m0, r_idx=r0,
                                           m_idx_l=m1, r_idx_l=r1)
        self.btps = BootstrapperFamily(ctx, boot_kwargs)

    def layout(self, blk: int) -> tuple:
        return (self.cfg.in_wids[min(blk, 1)], self.max_batch[blk],
                self.steps[blk], self.norm[blk])

    @tracing.spanned("image")
    def infer(self, image: np.ndarray, w: ResNetWeights,
              timings: dict | None = None) -> np.ndarray:
        """Logits of one image; `timings` as ``FastResNetRunner.infer``."""
        ctx, cfg = self.ctx, self.cfg
        n1, n2, n3 = NUM_BLOCKS[cfg.depth]
        raw = cfg.raw_in_wids
        rb = cfg.real_batch
        w0, w1 = cfg.in_wids[0], cfg.in_wids[1]
        interleave = FastResNetRunner._interleave_ker
        ct = self.encrypt_image(image)
        li = 0
        tm = timings if timings is not None else {}
        t0 = time.perf_counter()

        def layer(ct, li, kind, pow_, ker, bn_a, bn_b, in_wid, kp, real_ib,
                  real_ob, norm, step, maps):
            t = time.perf_counter()
            out = eval_conv_bn_relu(
                ctx, self.btps, ct, ker.ravel(), bn_a, bn_b, cfg.alpha, pow_,
                in_wid, kp, cfg.ker_wid, real_ib, real_ob, norm, 0, step, 2,
                0, kind, maps)
            _layer_done(f"wide{cfg.wide} layer {li} ({kind})", t)
            return out

        pow_ = cfg.init_pow
        for _ in range(n1):
            ct = layer(ct, li, "Conv", pow_, w.convs[li], w.bn_a[li],
                       w.bn_b[li], w0, raw[0], w.convs[li].shape[2],
                       w.convs[li].shape[3], self.norm[0], 1,
                       self.keep_maps[0])
            pow_ = cfg.mid_pow
            li += 1
        tm["blc1"] = time.perf_counter() - t0
        t0 = time.perf_counter()

        ker = w.convs[li]
        with tracing.span("transition", kind="StrConv_odd",
                          halves=1 if cfg.wide == 2 else 2):
            if cfg.wide == 2:
                # one conv over interleaved inputs (i → 2i) at norm[0]/2
                ct = layer(ct, li, "StrConv_odd", pow_, interleave(ker),
                           w.bn_a[li], w.bn_b[li], w0, 2 * raw[1], rb[1],
                           rb[1], self.norm[0] // 2, 1, self.str_maps[0])
            else:
                # even/odd out-channel halves at pack_pos 0 / 2, summed
                c1 = layer(ct, li, "StrConv_odd", pow_, ker[:, :, :, 0::2],
                           w.bn_a[li][0::2], w.bn_b[li][0::2], w0,
                           2 * raw[1], rb[0], rb[1] // 2, self.norm[0], 1,
                           self.str_maps[0])
                c2 = layer(ct, li, "StrConv_odd", pow_, ker[:, :, :, 1::2],
                           w.bn_a[li][1::2], w.bn_b[li][1::2], w0,
                           2 * raw[1], rb[0], rb[1] // 2, self.norm[0], 1,
                           self.str_maps[2])
                ct = ctx.add(c1, c2)
        li += 1
        tm["blc1to2"] = time.perf_counter() - t0
        t0 = time.perf_counter()

        for _ in range(n2):
            ct = layer(ct, li, "Conv_inside", pow_, w.convs[li], w.bn_a[li],
                       w.bn_b[li], w1, raw[1], rb[1], rb[1], self.norm[1], 1,
                       self.keep_maps[1])
            li += 1
        tm["blc2"] = time.perf_counter() - t0
        t0 = time.perf_counter()

        ct = layer(ct, li, "StrConv_inside", pow_, interleave(w.convs[li]),
                   w.bn_a[li], w.bn_b[li], w1, raw[2], rb[2], rb[2],
                   self.norm[2], 2, self.keep_maps[2])
        li += 1
        tm["blc2to3"] = time.perf_counter() - t0
        t0 = time.perf_counter()

        for j in range(n3):
            if j == n3 - 1:
                pow_ = cfg.final_pow
            ct = layer(ct, li, "Conv_inside", pow_, w.convs[li], w.bn_a[li],
                       w.bn_b[li], w1, raw[2], rb[2], rb[2], self.norm[2], 2,
                       self.keep_maps[2])
            li += 1
        tm["blc3"] = time.perf_counter() - t0
        t0 = time.perf_counter()

        logits = self._fc_head(ct, w)
        tm["fc"] = time.perf_counter() - t0
        return logits

    @tracing.spanned("head")
    def _fc_head(self, ct: Ciphertext, w: ResNetWeights) -> np.ndarray:
        return _split_head(lambda w_, b_: self._fc_conv(ct, w_, b_), self.cfg,
                           w.fc_w, w.fc_b)

    def _fc_conv(self, ct: Ciphertext, fc_w: np.ndarray,
                 fc_b: np.ndarray) -> np.ndarray:
        return head_conv(self.ctx, self.cfg, ct, fc_w, fc_b,
                         self.cfg.in_wids[1], self.cfg.raw_in_wids[1],
                         self.norm[2])
