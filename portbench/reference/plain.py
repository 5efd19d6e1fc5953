"""The plain reference of the benchmark's models, in NumPy.

The Go reference's model (Kim & Guyot, github.com/dwkim606/optimal_conv,
``test.go``) is a stack of conv + BN + ReLU layers without residual
connections, a stride-2 transition between blocks, and a reduce-mean +
FC head.  This module computes it from the inputs and weights the
benchmark made, in float64, and nothing else: it imports no module of
the measured program and takes nothing the program made.

``fmt`` names the precision the tensors are stored in: None keeps
float64 (the reference); "bfloat16", "float16" or "float8_e4m3fn" rounds
every input, weight and result to that format after each operation,
with the sums of a convolution taken in float64, as a tensor core sums
its products in float32 (the benchmark's control).
"""

from __future__ import annotations

import numpy as np


def rounder(fmt: str | None):
    """x → x rounded to `fmt` (and back to float64); None: unchanged."""
    if fmt is None:
        return lambda x: np.asarray(x, dtype=np.float64)
    import torch
    dt = getattr(torch, fmt)

    def rnd(x):
        t = torch.from_numpy(np.ascontiguousarray(x, dtype=np.float64))
        return t.to(dt).to(torch.float64).numpy()
    return rnd


def conv2d_same(img: np.ndarray, ker: np.ndarray) -> np.ndarray:
    """img [H, W, Cin], ker [kh, kw, Cin, Cout] → [H, W, Cout]: the
    cross-correlation with zero 'same' padding."""
    h, w, cin = img.shape
    kh, kw, _, cout = ker.shape
    ph, pw = kh // 2, kw // 2
    pad = np.zeros((h + 2 * ph, w + 2 * pw, cin))
    pad[ph: ph + h, pw: pw + w] = img
    out = np.zeros((h, w, cout))
    for di in range(kh):
        for dj in range(kw):
            out += np.tensordot(pad[di: di + h, dj: dj + w], ker[di, dj],
                                axes=([2], [0]))
    return out


def conv_bn(x, ker, a, b, rnd, stride_phase=None, crop=None) -> np.ndarray:
    """The pre-activation of one layer: conv + BN, then for a stride-2
    layer the samples y[p::2, p::2] (p = stride_phase) cropped to `crop`."""
    y = rnd(rnd(conv2d_same(rnd(x), rnd(ker))) * rnd(a) + rnd(b))
    if stride_phase is not None:
        y = y[stride_phase::2, stride_phase::2][:crop, :crop]
    return y


def relu(x: np.ndarray) -> np.ndarray:
    return np.maximum(x, 0.0)


def forward(layers: list, x: np.ndarray, fc_w, fc_b, fmt=None):
    """Run the stack.  layers: dicts with ker, a, b and, for a stride-2
    layer, stride_phase and crop.  → (pre-activations, activations, logits),
    one pre-activation and one activation a layer."""
    rnd = rounder(fmt)
    pres, acts = [], []
    for lay in layers:
        pre = conv_bn(x, lay["ker"], lay["a"], lay["b"], rnd,
                      lay.get("stride_phase"), lay.get("crop"))
        x = rnd(relu(pre))
        pres.append(pre)
        acts.append(x)
    feat = rnd(x.mean(axis=(0, 1)))
    logits = rnd(feat @ rnd(fc_w) + rnd(fc_b))
    return pres, acts, logits
