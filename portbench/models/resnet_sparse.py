"""ResNet on CIFAR in the paper's crop_sparse packing (``ResNetRunner``,
the reference's ``testResNet_crop_sparse``, test.go:76-370): blocks of
``Conv_sparse`` layers at log_sparse 2/3/4 joined by ``StrConv_sparse``
transitions, one bootstrap a layer, the reduce-mean + FC head as one
coefficient-domain conv."""

from __future__ import annotations

import numpy as np

from optimal_conv_tpu_torch.ckks.types import Ciphertext
from optimal_conv_tpu_torch.models import resnet as prog
from optimal_conv_tpu_torch.models.plain import ResNetWeights
from optimal_conv_tpu_torch.ops import conv as convops

from .. import common
from .base import Model as Base


class Model(Base):
    layer_module = prog

    def __init__(self, cfg: dict, seed: int, device: str):
        super().__init__(cfg, seed, device)
        k = cfg["ker_wid"]
        rb, wids = cfg["real_batch"], cfg["in_wids"]
        self.blocks = [(w, self.n // (w * w) // b, w - k // 2)
                       for w, b in zip(wids, rb)]
        # (block in, C_in, C_out, stride) a layer, in graph order
        n1, n2, n3 = cfg["blocks"]
        plan = [(0, cfg["in_ch"], rb[0], False)]
        plan += [(0, rb[0], rb[0], False)] * (n1 - 1)
        plan += [(0, rb[0], rb[1], True)]
        plan += [(1, rb[1], rb[1], False)] * n2
        plan += [(1, rb[1], rb[2], True)]
        plan += [(2, rb[2], rb[2], False)] * n3
        self.plan = plan
        self.pows = ([cfg["init_pow"]] + [cfg["mid_pow"]] * (len(plan) - 2)
                     + [cfg["final_pow"]])
        self.layers, self.fc_w, self.fc_b = common.draw_weights(
            [(k, ci, co) for _, ci, co, _ in plan], cfg, seed, device)
        for lay, (blk, _, _, stride) in zip(self.layers, plan):
            if stride:
                # the plain model's phase: even samples of an odd raw
                # width (plain.py, eval.go:377-385)
                lay["stride_phase"] = 0 if self.blocks[blk][2] % 2 else 1
                lay["crop"] = self.blocks[blk + 1][2]
        self.calls = [(li, slice(None), blk + stride, np.arange(co))
                      for li, (blk, _, co, stride) in enumerate(plan)]
        self.logit_pow = cfg["final_pow"]
        self.in_shape = (self.blocks[0][2],) * 2 + (cfg["in_ch"],)
        self.calibrate()

    # -- the program -----------------------------------------------------

    def build(self) -> None:
        cfg = self.cfg
        self.ctx = self.context()
        rcfg = prog.ResNetConfig(
            ker_wid=cfg["ker_wid"], depth=cfg["depth"],
            in_wids=tuple(cfg["in_wids"]), real_batch=tuple(cfg["real_batch"]),
            wide=cfg["wide"], fc_out=cfg["fc_out"], init_pow=cfg["init_pow"],
            mid_pow=cfg["mid_pow"], final_pow=cfg["final_pow"])
        self.runner = prog.ResNetRunner(self.ctx, rcfg, cfg["boot_kwargs"])
        self.weights = ResNetWeights(
            [lay["ker"] for lay in self.layers],
            [lay["a"] for lay in self.layers],
            [lay["b"] for lay in self.layers], self.fc_w, self.fc_b)

    def infer(self, x: np.ndarray) -> np.ndarray:
        """The image entry: encrypt, every fused layer, the head, decrypt."""
        return self.runner.infer(x, self.weights)

    # -- conv requests: the conv + BN of each Conv_sparse layer ---------

    def conv_layers(self) -> list:
        return [li for li, (_, _, _, stride) in enumerate(self.plan)
                if not stride]

    def conv_input(self, li: int, x: np.ndarray, acts: list) -> np.ndarray:
        """The features a client sends for layer `li`: the plain model's
        activations of its input (the image for the first layer)."""
        return x if li == 0 else acts[li - 1]

    def conv(self, ct: Ciphertext, li: int) -> Ciphertext:
        """The conv entry: ``eval_conv_bn`` of layer `li`, with the fused
        layer's arguments and output scale (ops/pipeline.py)."""
        blk, ci, co, _ = self.plan[li]
        lay, p = self.layers[li], self.ctx.params
        out_scale = float(2.0 ** (round(np.log2(p.q_moduli[0]))
                                  - (self.pows[li] + 8)))
        in_wid, norm, _ = self.blocks[blk]
        return convops.eval_conv_bn(
            self.ctx, ct, lay["ker"].ravel(), lay["a"], lay["b"], in_wid,
            self.cfg["ker_wid"], ci, co, norm, out_scale)

    def conv_block(self, li: int) -> int:
        """The block whose layout layer `li`'s input and output share."""
        return self.plan[li][0]
