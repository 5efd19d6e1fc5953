"""The paper's ImageNet tail (``ImagenetTailRunner.infer_logits``, the
reference's ``testImagenet_sparse``, test.go:1402-1607): 14²×256 on the
16² grid at log_sparse 0, a stride-2 transition of two
``StrConv_sparse_full`` halves, 7²×512 on the 8² grid at log_sparse 1,
and the RMFC head's 1000 logits."""

from __future__ import annotations

import numpy as np

from optimal_conv_tpu_torch.models import imagenet as prog

from .. import common
from .base import Model as Base


class Model(Base):
    layer_module = prog

    def __init__(self, cfg: dict, seed: int, device: str):
        super().__init__(cfg, seed, device)
        k = cfg["ker_wid"]
        n0, n1 = cfg["num_blc"]
        b0, b1 = cfg["real_batch"]
        self.blocks = [(w, nm, kp) for w, nm, kp in
                       zip(cfg["in_wids"], cfg["norm"], cfg["kp_wids"])]
        shapes = [(k, b0, b0)] * n0 + [(k, b0, b1)] + [(k, b1, b1)] * n1
        self.pows = ([cfg["init_pow"]] * (n0 - 1)
                     + [cfg["mid_pow"]] * (n1 + 2))
        self.layers, self.fc_w, self.fc_b = common.draw_weights(
            shapes, cfg, seed, device)
        self.layers[n0]["stride_phase"] = cfg["stride_phase"]
        self.layers[n0]["crop"] = cfg["kp_wids"][1]
        # the transition's halves hold the even and the odd out-channels,
        # channel k of either at block 2's layout channel 2k before the
        # odd half is shifted onto 2k + 1
        half = 2 * np.arange(b1 // 2)
        self.calls = ([(li, slice(None), 0, np.arange(b0)) for li in range(n0)]
                      + [(n0, slice(h, None, 2), 1, half) for h in (0, 1)]
                      + [(li, slice(None), 1, np.arange(b1))
                         for li in range(n0 + 1, n0 + 1 + n1)])
        self.logit_pow = cfg["mid_pow"]
        self.in_shape = (cfg["kp_wids"][0],) * 2 + (b0,)
        self.calibrate()

    def build(self) -> None:
        cfg = self.cfg
        self.ctx = self.context()
        self.runner = prog.ImagenetTailRunner(
            self.ctx, cfg["ker_wid"], cfg["boot_kwargs"],
            tuple(cfg["num_blc"]))

    def infer(self, x: np.ndarray) -> np.ndarray:
        """The image entry: encrypt, both blocks, the RMFC head, decrypt."""
        lay = self.layers
        return self.runner.infer_logits(
            x, [v["ker"] for v in lay], [v["a"] for v in lay],
            [v["b"] for v in lay], self.fc_w, self.fc_b,
            self.cfg["init_pow"], self.cfg["mid_pow"])
