"""The plain reference of the benchmark's ResNet on CIFAR, in PyTorch.

The same model as ``plain.py`` computes in NumPy, written with
``torch.nn.functional``: a stack of conv + BN + ReLU layers, a stride-2
transition between blocks, and the reduce-mean + FC head (Kim & Guyot,
github.com/dwkim606/optimal_conv, ``testResNet_crop_fast_in``,
test.go:372-636, and ``testResNet_crop_sparse``, test.go:76-370, run the
same network).  It runs in float64 on the CPU, one image at a time, with
no kernel of its own, no cache and no batching; TF32 is off while it
runs.  It imports no module of the measured program and takes nothing
the program made: only the inputs and weights the benchmark drew.

Where it departs from the paper's description: the weights are seeded
(``portbench/common.draw_weights``), not the paper's trained ones, and
the inputs are seeded uniform draws, not CIFAR-10 images.  As in the
paper's code: there are no residual connections; a stride-2 layer keeps
the samples y[p::2, p::2] of the 'same' conv, p the layer's
``stride_phase`` (0, the even samples, for the odd raw widths 31 and 15:
eval.go:377-385), cropped to the next block's raw width; the input is
the 31x31 top-left crop of a 32x32 image (test.go:129-148).
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn.functional as F

F64 = torch.float64


@contextlib.contextmanager
def _no_tf32():
    """TF32 off inside the block, as it was after."""
    was = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = was


def _t(x) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, dtype=np.float64), dtype=F64)


def _hwc(t: torch.Tensor) -> np.ndarray:
    """[1, C, H, W] → [H, W, C] as a NumPy array."""
    return t[0].permute(1, 2, 0).numpy().copy()


def conv_bn(x: torch.Tensor, lay: dict) -> torch.Tensor:
    """x [1, C_in, H, W] → the pre-activation [1, C_out, H', W'] of one
    layer: the cross-correlation with zero 'same' padding, BN, and for a
    stride-2 layer the samples y[p::2, p::2] cropped to ``crop``."""
    ker = _t(lay["ker"]).permute(3, 2, 0, 1)          # [C_out, C_in, kh, kw]
    y = F.conv2d(x, ker, padding=ker.shape[-1] // 2)
    y = y * _t(lay["a"])[:, None, None] + _t(lay["b"])[:, None, None]
    p = lay.get("stride_phase")
    if p is not None:
        crop = lay["crop"]
        y = y[..., p::2, p::2][..., :crop, :crop]
    return y


def forward(layers: list, x: np.ndarray, fc_w, fc_b):
    """Run the stack on one input x [H, W, C].  layers: dicts with ker
    [k, k, C_in, C_out], a, b and, for a stride-2 layer, stride_phase and
    crop.  → (pre-activations, activations, logits) as float64 NumPy
    arrays, [H, W, C] a layer."""
    pres, acts = [], []
    with _no_tf32(), torch.no_grad():
        t = _t(x).permute(2, 0, 1)[None]
        for lay in layers:
            pre = conv_bn(t, lay)
            t = F.relu(pre)
            pres.append(_hwc(pre))
            acts.append(_hwc(t))
        feat = t[0].mean(dim=(1, 2))
        logits = feat @ _t(fc_w) + _t(fc_b)
    return pres, acts, logits.numpy().copy()
