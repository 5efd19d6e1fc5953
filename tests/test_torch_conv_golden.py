"""The port's conv at logN=16 against the Go binary's outputs (CPU, plain
versions).  A file of its own: it is the port's longest CPU test, and the
suite hands whole files to its workers.
"""

import json
import os

import numpy as np
import torch

from optimal_conv_tpu_torch.ckks.context import CkksContext
from optimal_conv_tpu_torch.ckks.params import boot_params
from optimal_conv_tpu_torch.ops import conv as convops

CPU = torch.device("cpu")
GOLDEN = os.path.join(os.path.dirname(__file__), "golden",
                      "ref_conv_3_0_1.json")

# The suite runs in several pytest workers at once; PyTorch's intra-op
# threads on top of them oversubscribe the cores, so each worker keeps one.
torch.set_num_threads(1)


def test_conv_3_0_1_golden_logn16():
    """(d) conv 3 0 1 at logN=16 on the Go fork's chain, against the Go
    binary's decrypted outputs: atol 2e-5, average precision > 24 bits,
    minimum > 21.9 bits, the bars of tests/test_reference_parity.py.
    Decrypt-level because the two evaluations carry independent noise."""
    with open(GOLDEN) as f:
        g = json.load(f)["ours"]
    # the draw order of test_reference_parity._synth_inputs
    rng = np.random.default_rng(0)
    raw = rng.uniform(-1, 1, 127 * 127 * 4)
    ker = rng.uniform(-1, 1, 3 * 3 * 4 * 4) / 9.0
    bn_a = rng.uniform(0.8, 1.2, 4)
    bn_b = rng.uniform(-0.2, 0.2, 4)
    plain = (convops.conv2d_same_np(raw.reshape(127, 127, 4),
                                    ker.reshape(3, 3, 4, 4)) * bn_a
             + bn_b).ravel()
    params = boot_params(16)
    ctx = CkksContext(params, CPU, seed=0)
    inp = convops.prep_input(raw, 127, 128, params.n, 1)
    ct = ctx.encrypt(ctx.encoder.encode_coeffs(inp, params.scale, 1))
    out = convops.eval_conv_bn(ctx, ct, ker, bn_a, bn_b, 128, 3, 4, 4, 1,
                               float(1 << 30))
    got = convops.post_process(ctx.decrypt_decode_coeffs(out), 127, 128)
    np.testing.assert_allclose(got[:10], g["values_test"], atol=2e-5)
    lg = -np.log2(np.abs(got - plain) + 1e-300)
    assert lg.mean() > 24.0, f"avg precision {lg.mean():.2f} bits"
    assert lg.min() > 21.9, f"min precision {lg.min():.2f} bits"
