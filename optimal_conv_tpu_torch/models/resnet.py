"""Encrypted ResNet (plain conv-BN-ReLU stack), sparse-packed pipeline.

Counterpart of ``ResNetConfig`` and ``ResNetRunner`` of
``optimal_conv_tpu/models/resnet.py``: the Go reference's flagship workload
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
    b3 = cfg.real_batch[2]
    n_out = fc_w.shape[1]
    if n_out <= b3:
        return _fc_conv(ctx, cfg, ct, fc_w, fc_b)
    assert n_out % 2 == 0 and n_out // 2 <= b3
    lo = _fc_conv(ctx, cfg, ct, fc_w[:, : n_out // 2], fc_b[: n_out // 2])
    hi = _fc_conv(ctx, cfg, ct, fc_w[:, n_out // 2:], fc_b[n_out // 2:])
    return np.concatenate([lo, hi])


def _fc_conv(ctx: CkksContext, cfg: ResNetConfig, ct: Ciphertext,
             fc_w: np.ndarray, fc_b: np.ndarray) -> np.ndarray:
    raw2 = cfg.raw_in_wids[2]
    kw = raw2 if raw2 % 2 == 1 else raw2 + 1
    b3 = cfg.real_batch[2]
    n_out = fc_w.shape[1]
    in_wid, mb, norm = _fc_geometry(ctx, cfg)
    # kernel [kw, kw, b3, n_out], every tap = fc weight
    ker = np.broadcast_to(fc_w[None, None], (kw, kw, b3, n_out)).copy()
    bn_a = np.full(n_out, 1.0 / (raw2 * raw2))
    out = convops.eval_conv_bn(ctx, ct, ker.ravel(), bn_a, np.asarray(fc_b),
                               in_wid, kw, b3, n_out, norm, float(1 << 30))
    cfs = ctx.decrypt_decode_coeffs(out)
    # logits at spatial position (kw/2, kw/2), channel stride norm
    ctr = (kw // 2) * in_wid * mb + (kw // 2) * mb
    return cfs[ctr: ctr + norm * n_out: norm]


class ResNetRunner:
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

    def packed_image(self, image: np.ndarray) -> np.ndarray:
        """image [raw0, raw0, C] → the N coefficients ``encrypt_image``
        encodes: only the image's own channels, at stride norm (the Go
        reference's inline loop, test.go:140-148)."""
        cfg, p = self.cfg, self.ctx.params
        w0 = cfg.in_wids[0]
        mb = self.max_batch[0]
        raw0 = cfg.raw_in_wids[0]
        inp = np.zeros(p.n)
        for b in range(image.shape[-1]):
            blk = np.zeros((w0, w0))
            blk[:raw0, :raw0] = image[..., b]
            inp[b * self.norm[0]::mb] = blk.ravel()
        return inp

    def encrypt_image(self, image: np.ndarray) -> Ciphertext:
        """image [raw0, raw0, C] → sparse-packed level-1 ciphertext."""
        p = self.ctx.params
        pt = self.ctx.encoder.encode_coeffs(self.packed_image(image),
                                            p.scale, 1)
        return self.ctx.encrypt(pt)

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

    def _fc_head(self, ct: Ciphertext, w: ResNetWeights) -> np.ndarray:
        return fc_conv(self.ctx, self.cfg, ct, w.fc_w, w.fc_b)
