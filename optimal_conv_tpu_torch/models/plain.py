"""Plaintext (numpy) model of the encrypted CNN: the golden oracle.

A copy of ``optimal_conv_tpu/models/plain.py`` (numpy only); the
functions have the same source, but for the paths of the Go sources in
docstrings and comments.  The weights are numpy arrays in both
packages, so a ``ResNetWeights`` crosses between them as it is, or
through the CSV directory layout of ``load_weights_dir`` /
``save_weights_dir``.

Architecture (the Go reference's "ResNet": a plain conv-BN-ReLU stack
WITHOUT residual connections, test.go:76-370):
  block1: conv(3→b1) + [conv(b1→b1)]×(n1−1), each + BN + ReLU
  transition: stride-2 conv(b1→b2) + BN + ReLU
  block2: [conv(b2→b2)]×n2 …
  transition: stride-2 conv(b2→b3) + BN + ReLU
  block3: [conv(b3→b3)]×n3 …
  head: reduce-mean over the spatial grid, then FC.

Strided convolution samples the EVEN positions of the SAME-padded conv
output (y[i,j] = conv(x)[2i, 2j], cropped to raw_in_wids[i+1]) when the
raw input width is odd; even raw widths are pre-shifted by X^{mb(w+1)}
so the odd positions land on the even grid (eval.go:315-332, 377-385).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..ops.conv import conv2d_same_np
from ..ops.relu import relu_np


NUM_BLOCKS = {20: (7, 5, 5), 14: (5, 3, 3), 8: (3, 1, 1)}


@dataclass
class ResNetWeights:
    convs: list          # [kh, kw, cin, cout] per conv layer (in graph order)
    bn_a: list           # [cout] multiplicative BN fold
    bn_b: list           # [cout] additive BN fold
    fc_w: np.ndarray     # [c3, fc_out]
    fc_b: np.ndarray     # [fc_out]


def channel_plan(depth: int, batches, in_ch: int = 3,
                 init_batch: int | None = None) -> list[tuple[int, int]]:
    """(cin, cout) per conv layer in graph order.  For wide models
    (init_batch set) block 1 opens with in_ch→init_batch→b1, matching
    the reference's wide driver (test.go:752-771)."""
    n1, n2, n3 = NUM_BLOCKS[depth]
    b1, b2, b3 = batches
    plan = []
    if init_batch is None:
        plan.append((in_ch, b1))
        plan += [(b1, b1)] * (n1 - 1)
    else:
        plan.append((in_ch, init_batch))
        plan.append((init_batch, b1))
        plan += [(b1, b1)] * (n1 - 2)
    plan.append((b1, b2))          # transition 1 (stride 2)
    plan += [(b2, b2)] * n2
    plan.append((b2, b3))          # transition 2 (stride 2)
    plan += [(b3, b3)] * n3
    return plan


def random_weights(ker_wid: int, depth: int, batches=(16, 32, 64),
                   fc_out: int = 10, in_ch: int = 3, seed: int = 0,
                   scale: float = 0.5,
                   init_batch: int | None = None) -> ResNetWeights:
    """He-style random weights, magnitudes tuned so activations stay in
    the ReLU approximation range."""
    rng = np.random.default_rng(seed)
    b3 = batches[2]
    convs, bn_a, bn_b = [], [], []
    for cin, cout in channel_plan(depth, batches, in_ch, init_batch):
        k = rng.normal(0, scale / np.sqrt(ker_wid * ker_wid * cin),
                       (ker_wid, ker_wid, cin, cout))
        convs.append(k)
        bn_a.append(rng.uniform(0.8, 1.2, cout))
        bn_b.append(rng.uniform(-0.1, 0.1, cout))
    fc_w = rng.normal(0, 1.0 / np.sqrt(b3), (b3, fc_out))
    fc_b = rng.normal(0, 0.1, fc_out)
    return ResNetWeights(convs, bn_a, bn_b, fc_w, fc_b)


def load_weights_dir(weight_dir: str, ker_wid: int, depth: int,
                     batches=(16, 32, 64), fc_out: int = 10, in_ch: int = 3,
                     init_batch: int | None = None) -> ResNetWeights:
    """ResNetWeights from the reference's weight-directory CSV layout
    (readTxt calls, test.go:170-186, 281-299 and the
    wide drivers test.go:752-771, 1036-1046):

      w{li}-conv.csv   flat [k²·cin·cout], tap-major then in then out
      w{li}-a.csv      [cout]  multiplicative BN fold
      w{li}-b.csv      [cout]  additive BN fold
      final-fckernel.csv  [b3·fc_out], feature-major
      final-fcbias.csv    [fc_out]

    li runs in graph order over channel_plan (block layers then the
    strided transitions, exactly the reference's weight_num order)."""
    import os
    convs, bn_a, bn_b = [], [], []
    for li, (cin, cout) in enumerate(
            channel_plan(depth, batches, in_ch, init_batch)):
        k = np.loadtxt(os.path.join(weight_dir, f"w{li}-conv.csv"))
        convs.append(k.reshape(ker_wid, ker_wid, cin, cout))
        bn_a.append(np.loadtxt(os.path.join(weight_dir, f"w{li}-a.csv"))
                    .reshape(cout))
        bn_b.append(np.loadtxt(os.path.join(weight_dir, f"w{li}-b.csv"))
                    .reshape(cout))
    fc_w = np.loadtxt(os.path.join(weight_dir, "final-fckernel.csv")) \
        .reshape(batches[2], fc_out)
    fc_b = np.loadtxt(os.path.join(weight_dir, "final-fcbias.csv")) \
        .reshape(fc_out)
    return ResNetWeights(convs, bn_a, bn_b, fc_w, fc_b)


def save_weights_dir(weight_dir: str, w: ResNetWeights) -> None:
    """Inverse of load_weights_dir (the role of the reference's python
    export pipeline that wrote the weight CSVs)."""
    import os
    os.makedirs(weight_dir, exist_ok=True)
    for li, k in enumerate(w.convs):
        np.savetxt(os.path.join(weight_dir, f"w{li}-conv.csv"),
                   np.asarray(k).ravel(), fmt="%.17g")
        np.savetxt(os.path.join(weight_dir, f"w{li}-a.csv"),
                   np.asarray(w.bn_a[li]).ravel(), fmt="%.17g")
        np.savetxt(os.path.join(weight_dir, f"w{li}-b.csv"),
                   np.asarray(w.bn_b[li]).ravel(), fmt="%.17g")
    np.savetxt(os.path.join(weight_dir, "final-fckernel.csv"),
               np.asarray(w.fc_w).ravel(), fmt="%.17g")
    np.savetxt(os.path.join(weight_dir, "final-fcbias.csv"),
               np.asarray(w.fc_b).ravel(), fmt="%.17g")


def conv_bn_relu_plain(x, ker, a, b, stride=1):
    y = conv2d_same_np(x, ker) * a + b
    if stride == 2:
        # odd raw width: even-grid samples y[2i,2j]; even raw width: the
        # encrypted path pre-shifts by X^{mb(w+1)} so y[2i+1,2j+1] lands
        # on the even grid (eval.go:377-385)
        ph = 0 if x.shape[0] % 2 == 1 else 1
        y = y[ph::2, ph::2]
    return relu_np(y)


def plain_forward(w: ResNetWeights, image: np.ndarray, depth: int,
                  raw_wids: tuple[int, int, int]) -> np.ndarray:
    """image [raw_wids[0], raw_wids[0], 3] → logits."""
    n1, n2, n3 = NUM_BLOCKS[depth]
    x = image
    li = 0
    for _ in range(n1):
        x = conv_bn_relu_plain(x, w.convs[li], w.bn_a[li], w.bn_b[li])
        li += 1
    x = conv_bn_relu_plain(x, w.convs[li], w.bn_a[li], w.bn_b[li], stride=2)
    x = x[: raw_wids[1], : raw_wids[1]]
    li += 1
    for _ in range(n2):
        x = conv_bn_relu_plain(x, w.convs[li], w.bn_a[li], w.bn_b[li])
        li += 1
    x = conv_bn_relu_plain(x, w.convs[li], w.bn_a[li], w.bn_b[li], stride=2)
    x = x[: raw_wids[2], : raw_wids[2]]
    li += 1
    for _ in range(n3):
        x = conv_bn_relu_plain(x, w.convs[li], w.bn_a[li], w.bn_b[li])
        li += 1
    feat = x.mean(axis=(0, 1))
    return feat @ w.fc_w + w.fc_b
