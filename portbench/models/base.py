"""What the model kinds share: the program's context from a configuration,
the input amplitude, and the client's side of a conv request."""

from __future__ import annotations

import time

import numpy as np
import torch

from optimal_conv_tpu_torch.ckks import params as prm
from optimal_conv_tpu_torch.ckks.context import CkksContext
from optimal_conv_tpu_torch.ckks.types import Ciphertext
from optimal_conv_tpu_torch.ops import conv as convops

from .. import common
from ..reference import plain


class Model:
    """A model kind fills ``self.layers`` (the reference's layers),
    ``self.pows`` (each layer's pow: its activations in units of 2^pow),
    ``self.blocks`` ((in_wid, norm, raw) of each block's layout),
    ``self.in_shape`` and ``self.calls`` (one entry a call of the fused
    layer, in order: (reference layer, its channels, output block, layout
    channels))."""

    # the module whose global ``eval_conv_bn_relu`` the runner calls
    layer_module = None

    def __init__(self, cfg: dict, seed: int, device: str):
        self.cfg, self.seed, self.device = cfg, seed, device
        self.n = 1 << cfg["params"]["log_n"]
        self.ctx = self.runner = None
        self.ref_s = 0.0               # seconds spent in the reference

    # -- host side: weights and inputs from the seed ---------------------

    def calibrate(self) -> None:
        """Scale the inputs so that the largest plain |pre-activation| of
        every layer of input 0 is at most input_peak of 2^pow: the range
        the bootstrapper takes (|x| / 2^pow < 1), with room for the
        other inputs."""
        self.amp = 1.0
        for _ in range(4):
            pres, _, _ = self.reference(self.image(0))
            peak = max(float(np.abs(p).max()) / 2.0 ** w
                       for p, w in zip(pres, self.pows))
            self.amp *= self.cfg["input_peak"] / peak

    def image(self, i: int) -> np.ndarray:
        return self.amp * common.uniform_input(self.in_shape, self.seed, i)

    def reference(self, x: np.ndarray, fmt: str | None = None):
        """The plain model on x → (pre-activations, activations, logits);
        its seconds are counted in ``ref_s``, which set-up leaves out."""
        t0 = time.perf_counter()
        try:
            return plain.forward(self.layers, x, self.fc_w, self.fc_b, fmt)
        finally:
            self.ref_s += time.perf_counter() - t0

    # -- the program -----------------------------------------------------

    def context(self) -> CkksContext:
        pc = dict(self.cfg["params"])
        preset = getattr(prm, pc.pop("preset"))
        return CkksContext(preset(**pc), self.device, seed=self.seed,
                           ntt_backend=self.cfg["ntt_backend"])

    def unpack(self, ct: Ciphertext, block: int, channels) -> np.ndarray:
        """Decrypt a ciphertext of the program's and read the features of
        `block` at the layout channels `channels` → [raw, raw, len]."""
        in_wid, norm, raw = self.blocks[block]
        idx = common.layout_index(self.n, in_wid, norm, raw,
                                  int(np.max(channels)) + 1)
        return self.ctx.decrypt_decode_coeffs(ct)[idx[..., channels]]

    def encrypt_features(self, x: np.ndarray, block: int) -> Ciphertext:
        """The client's side of a conv request: features x [raw, raw, C]
        of `block`, packed in its layout and encrypted at the conv's
        input level."""
        in_wid, norm, raw = self.blocks[block]
        cfs = np.zeros(self.n)
        cfs[common.layout_index(self.n, in_wid, norm, raw, x.shape[-1])] = x
        ctx = self.ctx
        return ctx.encrypt(ctx.encoder.encode_coeffs(
            cfs, ctx.params.scale, convops.ECD_LEVEL))

    def free(self) -> None:
        self.ctx = self.runner = None
        torch.cuda.empty_cache()
