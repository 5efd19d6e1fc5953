"""The paper's ImageNet tail in its full-slot packing
(``ImagenetFinalFastRunner.infer_logits``, the reference's
``testImagenet_final_fast_in``, test.go:1209-1400, and newContext
"Imagenet_final_fast", main.go:378-404): 14²×256 on the 16² grid and
7²×512 on the 8² grid, every layer a full-pack ``Conv`` with
``gen_keep_vec`` masks and a full-slot bootstrap with two halves; the
stride-2 transition two plain ``StrConv`` calls on the out-channel
halves (pack_pos 0 and 1, the single-stage ``gen_comprs_full`` repack)
that the runner sums; the RMFC head's 1000 logits.

The network, weight shapes, pows and blocks are the sparse tail's
(``imagenet_tail.py``); the reference is the plain model in PyTorch
(``plain_torch``).  Where it departs from the paper: the weights are
seeded (``portbench/common.draw_weights``), not trained; the inputs are
seeded uniform 14²×256 features, not an ImageNet image's activations;
the transition keeps y[2i+1, 2j+1] of the 14² conv output, the plain
model's own choice, which this runner computes (F9 in ROADMAP.md).  The
kind serves whole images only: it has no conv-request entry."""

from __future__ import annotations

import time

import numpy as np

from optimal_conv_tpu_torch.models import imagenet as prog

from ..reference import plain_torch
from . import imagenet_tail


class Model(imagenet_tail.Model):

    def __init__(self, cfg: dict, seed: int, device: str):
        super().__init__(cfg, seed, device)
        n0, n1 = cfg["num_blc"]
        b0, b1 = cfg["real_batch"]
        # the transition's half h holds the out-channels
        # [h·b1/2, (h+1)·b1/2) at block 2's layout channels of the same
        # numbers (``ImagenetFinalFastRunner.transition_channels``)
        half = b1 // 2
        self.calls = ([(li, slice(None), 0, np.arange(b0)) for li in range(n0)]
                      + [(n0, slice(h * half, (h + 1) * half), 1,
                          h * half + np.arange(half)) for h in (0, 1)]
                      + [(li, slice(None), 1, np.arange(b1))
                         for li in range(n0 + 1, n0 + 1 + n1)])

    def reference(self, x: np.ndarray):
        """The plain model in PyTorch, float64 (``plain_torch``) →
        (pre-activations, activations, logits); its seconds are counted
        in ``ref_s``, which set-up leaves out."""
        t0 = time.perf_counter()
        try:
            return plain_torch.forward(self.layers, x, self.fc_w, self.fc_b)
        finally:
            self.ref_s += time.perf_counter() - t0

    def build(self) -> None:
        cfg = self.cfg
        self.ctx = self.context()
        self.runner = prog.ImagenetFinalFastRunner(
            self.ctx, cfg["ker_wid"], cfg["boot_kwargs"],
            tuple(cfg["num_blc"]))
