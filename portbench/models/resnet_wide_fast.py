"""ResNet on CIFAR at two or three times the width, in the paper's
crop_fast packing (``WideFastResNetRunner``, the reference's
``testResNet_crop_fast_wide_in``, test.go:914-1207, and newContext
"Resnet_crop_fast_wide3", main.go:264-345): block 1 a full-pack ``Conv``
on the in_wids[0] grid that opens 3 → init_batch → real_batch[0]
(test.go:752-771); the ``StrConv_odd`` transition onto the in_wids[1]
grid, at wide 3 two fused layers on the even and the odd out-channels
(pack_pos 0 and 2) whose outputs the runner sums; ``Conv_inside`` at
step 1 on that grid, a ``StrConv_inside`` transition to step 2, and the
head one replicated-tap conv on the same grid.

The weights are drawn as the other kinds draw theirs, on the wide plan;
the reference is the plain model in PyTorch.  The kind serves whole
images only: it has no conv-request entry."""

from __future__ import annotations

import numpy as np

from optimal_conv_tpu_torch.models import resnet as prog
from optimal_conv_tpu_torch.models.plain import ResNetWeights

from .. import common
from . import resnet_fast
from .base import Model as Base

# the dilation step of each block (``WideFastResNetRunner.steps``)
STEPS = (1, 1, 2)


class Model(resnet_fast.Model):

    def __init__(self, cfg: dict, seed: int, device: str):
        Base.__init__(self, cfg, seed, device)
        k = cfg["ker_wid"]
        rb, wids, ib = cfg["real_batch"], cfg["in_wids"], cfg["init_batch"]
        # (in_wid, norm, raw, step) of each block: block 1 on the
        # in_wids[0] grid, blocks 2 and 3 on the in_wids[1] grid
        grids = (wids[0], wids[1], wids[1])
        self.blocks = [(g, nm, w - k // 2, st) for g, nm, w, st
                       in zip(grids, cfg["norm"], wids, STEPS)]
        # (block in, C_in, C_out, stride) a layer, in graph order
        n1, n2, n3 = cfg["blocks"]
        plan = [(0, cfg["in_ch"], ib, False), (0, ib, rb[0], False)]
        plan += [(0, rb[0], rb[0], False)] * (n1 - 2)
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
                # even samples of an odd raw width (plain_torch.py)
                lay["stride_phase"] = 0 if self.blocks[blk][2] % 2 else 1
                lay["crop"] = self.blocks[blk + 1][2]
        # one call a layer, but two for the wide-3 StrConv_odd transition:
        # half h holds the out-channels h, h + 2, ... at block 2's layout
        # channels of the same numbers (pack_pos 0 and 2 at norm 2)
        self.calls = []
        for li, (blk, _, co, stride) in enumerate(plan):
            if stride and blk == 0 and cfg["wide"] == 3:
                self.calls += [(li, slice(h, None, 2), 1, np.arange(h, co, 2))
                               for h in (0, 1)]
            else:
                self.calls.append((li, slice(None), blk + stride,
                                   np.arange(co)))
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
            wide=cfg["wide"], init_batch=cfg["init_batch"],
            fc_out=cfg["fc_out"], init_pow=cfg["init_pow"],
            mid_pow=cfg["mid_pow"], final_pow=cfg["final_pow"])
        self.runner = prog.WideFastResNetRunner(self.ctx, rcfg,
                                                cfg["boot_kwargs"])
        self.weights = ResNetWeights(
            [lay["ker"] for lay in self.layers],
            [lay["a"] for lay in self.layers],
            [lay["b"] for lay in self.layers], self.fc_w, self.fc_b)
