"""The control of a cell's correctness check, as a model kind: a stand-in
for the program whose entries return the plain reference computed in a
lower precision.  Its configuration is the cell's own with "model" set
to "control" and "control": {"of": <the cell's model kind>, "fmt":
<precision>}; the harness drives it through the same set-up, window and
check as the program, so the control fails or passes by the same
comparison.  Its "ciphertexts" hold plain features in ``c0``."""

from __future__ import annotations

import importlib
import types

import numpy as np
import torch
from optimal_conv_tpu_torch.ckks.types import Ciphertext

from ..reference import plain


def _held(x: np.ndarray) -> Ciphertext:
    t = torch.from_numpy(np.ascontiguousarray(x, dtype=np.float64))
    return Ciphertext(t, torch.zeros(0), 0, 1.0)


class StandIn:
    """Put before a model kind's class: the same weights, inputs, calls
    and reference; the program replaced."""

    def build(self) -> None:
        self.fmt = self.cfg["control"]["fmt"]
        self.ctx = self.runner = None
        # the fused layer the image entry taps, this model's own
        self.layer_module = types.SimpleNamespace(
            eval_conv_bn_relu=lambda ct, **_: ct)

    def infer(self, x: np.ndarray) -> np.ndarray:
        _, acts, logits = plain.forward(self.layers, x, self.fc_w, self.fc_b,
                                        self.fmt)
        for li, sl, _, _ in self.calls:
            self.layer_module.eval_conv_bn_relu(_held(acts[li][..., sl]))
        return logits

    def encrypt_features(self, x: np.ndarray, block: int) -> Ciphertext:
        return _held(x)

    def conv(self, ct: Ciphertext, li: int) -> Ciphertext:
        lay = self.layers[li]
        return _held(plain.conv_bn(ct.c0.cpu().numpy(), lay["ker"], lay["a"],
                                   lay["b"], plain.rounder(self.fmt)))

    def unpack(self, ct: Ciphertext, block: int, channels) -> np.ndarray:
        return ct.c0.cpu().numpy()


def Model(cfg: dict, seed: int, device: str):
    kind = importlib.import_module(f"portbench.models.{cfg['control']['of']}")
    return type("Control", (StandIn, kind.Model), {})(cfg, seed, device)
