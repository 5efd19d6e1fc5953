"""ResNet on CIFAR in the paper's crop_fast packing (``FastResNetRunner``,
the reference's ``testResNet_crop_fast_in``, test.go:372-636, and
newContext "Resnet_crop_fast", main.go:123-137): every layer on the
in_wids[0] grid at log_sparse 0, so one full-slot bootstrapper whose
CtoS gives two halves; ``Conv_inside`` kernels dilated 1 → 2 → 4 by the
``StrConv_inside`` transitions; the head one conv with a 31²-tap kernel.

The network, its seeded weights, pows, stride phase and calls are the
crop_sparse kind's; the layouts and the runner are the fast regime's,
and the reference is the plain model in PyTorch.  The kind serves whole
images only: it has no conv-request entry."""

from __future__ import annotations

import time

import numpy as np

from optimal_conv_tpu_torch.ckks.types import Ciphertext
from optimal_conv_tpu_torch.models import resnet as prog
from optimal_conv_tpu_torch.models.plain import ResNetWeights

from .. import common
from ..reference import plain_torch
from . import resnet_sparse

# the dilation step of each block (``FastResNetRunner.steps``)
STEPS = (1, 2, 4)


class Model(resnet_sparse.Model):

    def __init__(self, cfg: dict, seed: int, device: str):
        super().__init__(cfg, seed, device)
        # (in_wid, norm, raw, step) of each block: all on the block-1 grid
        w0 = cfg["in_wids"][0]
        mb = self.n // (w0 * w0)
        self.blocks = [(w0, mb // b, raw, step) for (_, _, raw), b, step
                       in zip(self.blocks, cfg["real_batch"], STEPS)]

    def reference(self, x: np.ndarray):
        """The plain model in PyTorch, float64 (``plain_torch``) →
        (pre-activations, activations, logits); its seconds are counted
        in ``ref_s``, which set-up leaves out."""
        t0 = time.perf_counter()
        try:
            return plain_torch.forward(self.layers, x, self.fc_w, self.fc_b)
        finally:
            self.ref_s += time.perf_counter() - t0

    # -- the program -----------------------------------------------------

    def build(self) -> None:
        cfg = self.cfg
        self.ctx = self.context()
        rcfg = prog.ResNetConfig(
            ker_wid=cfg["ker_wid"], depth=cfg["depth"],
            in_wids=tuple(cfg["in_wids"]), real_batch=tuple(cfg["real_batch"]),
            wide=cfg["wide"], fc_out=cfg["fc_out"], init_pow=cfg["init_pow"],
            mid_pow=cfg["mid_pow"], final_pow=cfg["final_pow"])
        self.runner = prog.FastResNetRunner(self.ctx, rcfg,
                                            cfg["boot_kwargs"])
        self.weights = ResNetWeights(
            [lay["ker"] for lay in self.layers],
            [lay["a"] for lay in self.layers],
            [lay["b"] for lay in self.layers], self.fc_w, self.fc_b)

    def unpack(self, ct: Ciphertext, block: int, channels) -> np.ndarray:
        """Decrypt and read the features of `block` at its dilation step."""
        in_wid, norm, raw, step = self.blocks[block]
        idx = common.layout_index(self.n, in_wid, norm, raw,
                                  int(np.max(channels)) + 1, step)
        return self.ctx.decrypt_decode_coeffs(ct)[idx[..., channels]]

    def conv_layers(self) -> list:
        raise NotImplementedError("the crop_fast kind has no conv requests")

    def conv(self, ct: Ciphertext, li: int) -> Ciphertext:
        raise NotImplementedError("the crop_fast kind has no conv requests")
