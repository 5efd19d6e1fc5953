"""Command-line driver (counterpart of ``optimal_conv_tpu/cli.py``):

    python -m optimal_conv_tpu_torch conv     <ker 3|5|7> <i_batch 0..3> <n_tests> [--device cuda|cpu]
    python -m optimal_conv_tpu_torch convReLU <ker 3|5|7> <i_batch 0..3> <n_tests> [--device cuda|cpu]

``conv`` runs the paper's coefficient-packed conv + BN ("Ours") at
logN=16 on the Go fork's exact chain (``boot_params(16)``, as the Go
binary's ``conv`` does), for the batch/width pairs {4,16,64,256} ×
{128,64,32,16}.  ``convReLU`` runs the whole fused layer on the same
data: conv + BN, the first bootstrap half (ModRaise, CtoS, EvalMod),
the minimax ReLU, the keep-mask repack and the second half (StoC), kind
``Conv`` at log_sparse 0 with pow 4, as the Go binary's ``convReLU``
does.  Inputs come from ``test_conv_data/`` CSVs when present, else from
seed 0 in the same draw order as the JAX CLI; the numpy conv (and the
exact ReLU) is the golden output.  The device defaults to CUDA and is
never silently replaced by the CPU.

``resnet``, the prior-art baseline (``--bl``) and the per-stage decrypt
oracles (``--debug``) are not ported yet and exit with an error that
names what they wait for.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np
import torch

BATCHS = [4, 16, 64, 256]
# what each unported command or option still waits for
MISSING = {
    "resnet": "the ResNetRunner (models/resnet.py) and the plaintext model "
              "(models/plain.py)",
    "--bl": "the prior-art baseline (ops/baseline.py)",
    "--debug": "the per-stage decrypt oracles (ops/debug.py)",
}
POW = 4.0            # convReLU: values enter the bootstrap divided by 2^POW
WIDTHS = [128, 64, 32, 16]


def precision_stats(want: np.ndarray, have: np.ndarray) -> str:
    """log2-error stats (avg/min/max/median/quartiles)."""
    err = np.abs(np.ravel(want) - np.ravel(have)) + 1e-300
    lg = -np.log2(err)
    q1, med, q3 = np.percentile(lg, (25, 50, 75))
    return (f"prec (log2): avg {lg.mean():6.2f}  min {lg.min():6.2f}  "
            f"max {lg.max():6.2f}  med {med:6.2f}  q1 {q1:6.2f}  q3 {q3:6.2f}")


def conv_inputs(ker_wid: int, i_batch: int, it: int, rng: np.random.Generator,
                relu: bool = False):
    """(raw, ker, bn_a, bn_b, want) of test `it`: the reference CSVs when
    present, else synthetic draws (JAX CLI order) and the numpy conv,
    followed by the exact ReLU when `relu`."""
    from .ops import conv as convops
    from .ops.relu import relu_np

    in_batch, in_wid = BATCHS[i_batch], WIDTHS[i_batch]
    raw_wid = in_wid - ker_wid // 2
    base = f"test_conv_data/test_conv{ker_wid}_batch_{in_batch}"
    if os.path.exists(f"{base}_in_{it}.csv"):
        raw = np.loadtxt(f"{base}_in_{it}.csv").ravel()
        ker = np.loadtxt(f"{base}_ker_{it}.csv").ravel()
        bn_a = np.loadtxt(f"{base}_bna_{it}.csv").ravel()
        bn_b = np.loadtxt(f"{base}_bnb_{it}.csv").ravel()
        want = np.loadtxt(
            f"{base}_{'reluout' if relu else 'out'}_{it}.csv").ravel()
        return raw, ker, bn_a, bn_b, want
    raw = rng.uniform(-1, 1, raw_wid * raw_wid * in_batch)
    ker = rng.uniform(-1, 1, ker_wid * ker_wid * in_batch * in_batch) \
        / ker_wid**2
    bn_a = rng.uniform(0.8, 1.2, in_batch)
    bn_b = rng.uniform(-0.2, 0.2, in_batch)
    img = raw.reshape(raw_wid, raw_wid, in_batch)
    kk = ker.reshape(ker_wid, ker_wid, in_batch, in_batch)
    want = convops.conv2d_same_np(img, kk) * bn_a + bn_b
    return raw, ker, bn_a, bn_b, (relu_np(want) if relu else want).ravel()


def encrypted_conv(ctx, ker_wid: int, i_batch: int, raw, ker, bn_a, bn_b):
    """Encrypt `raw`, run the conv + BN, decrypt: → (got, enc_s, conv_s)."""
    from .ops import conv as convops

    p = ctx.params
    in_batch, in_wid = BATCHS[i_batch], WIDTHS[i_batch]
    raw_wid = in_wid - ker_wid // 2
    inp = convops.prep_input(raw, raw_wid, in_wid, p.n, 1)
    t0 = time.perf_counter()
    ct = ctx.encrypt(ctx.encoder.encode_coeffs(inp, p.scale,
                                               convops.ECD_LEVEL))
    _sync(ctx.device)
    t1 = time.perf_counter()
    out = convops.eval_conv_bn(ctx, ct, ker, bn_a, bn_b, in_wid, ker_wid,
                               in_batch, in_batch, 1, float(1 << 30))
    _sync(ctx.device)
    t2 = time.perf_counter()
    got = convops.post_process(ctx.decrypt_decode_coeffs(out), raw_wid, in_wid)
    return got, t1 - t0, t2 - t1


def conv_relu_maps(params, ker_wid: int, i_batch: int):
    """The keep-mask repack tables of ``convReLU`` (full pack, two halves)."""
    from .ops import repack as rp
    from .ops.pipeline import LayerMaps

    in_wid = WIDTHS[i_batch]
    raw_wid = in_wid - ker_wid // 2
    return LayerMaps(ext_idx=[
        rp.gen_keep_vec(params.n // 2, in_wid, raw_wid, 0),
        rp.gen_keep_vec(params.n // 2, in_wid, raw_wid, 1)])


def encrypted_conv_relu(ctx, btps, maps, ker_wid: int, i_batch: int, raw, ker,
                        bn_a, bn_b, on_stage=None):
    """Encrypt `raw`, run the fused layer (kind ``Conv``, log_sparse 0,
    pow 4), decrypt: → (got, enc_s, layer_s)."""
    from .ops import conv as convops
    from .ops.pipeline import eval_conv_bn_relu

    p = ctx.params
    in_batch, in_wid = BATCHS[i_batch], WIDTHS[i_batch]
    raw_wid = in_wid - ker_wid // 2
    inp = convops.prep_input(raw, raw_wid, in_wid, p.n, 1)
    t0 = time.perf_counter()
    ct = ctx.encrypt(ctx.encoder.encode_coeffs(inp, p.scale,
                                               convops.ECD_LEVEL))
    _sync(ctx.device)
    t1 = time.perf_counter()
    out = eval_conv_bn_relu(ctx, btps, ct, ker, bn_a, bn_b, 0.0, POW, in_wid,
                            raw_wid, ker_wid, in_batch, in_batch, 1, 0, 1, 2,
                            0, "Conv", maps, on_stage=on_stage)
    _sync(ctx.device)
    t2 = time.perf_counter()
    got = convops.post_process(ctx.decrypt_decode_coeffs(out), raw_wid, in_wid)
    return got, t1 - t0, t2 - t1


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_conv(ker_wid: int, i_batch: int, n_tests: int, device,
             boot: bool = False) -> None:
    from .ckks.bootstrap import SplitBootstrapper
    from .ckks.context import CkksContext
    from .ckks.params import boot_params
    from .device import resolve_device

    dev = resolve_device(device)
    params = boot_params(16)
    print(f"CKKS parameters: logN={params.log_n} h={params.h} "
          f"levels={len(params.logq)} scale=2^{params.log_scale} device={dev}")
    ctx = CkksContext(params, dev, seed=0)
    if boot:
        t0 = time.perf_counter()
        btps = {0: SplitBootstrapper(ctx, log_sparse=0)}
        maps = conv_relu_maps(params, ker_wid, i_batch)
        print(f"Bootstrapper built in {time.perf_counter() - t0:.3f}s")
    rng = np.random.default_rng(0)
    for it in range(n_tests):
        print(f"{it + 1}-th iter... start")
        raw, ker, bn_a, bn_b, want = conv_inputs(ker_wid, i_batch, it, rng,
                                                 relu=boot)
        if boot:
            got, enc_s, conv_s = encrypted_conv_relu(
                ctx, btps, maps, ker_wid, i_batch, raw, ker, bn_a, bn_b)
        else:
            got, enc_s, conv_s = encrypted_conv(ctx, ker_wid, i_batch, raw,
                                                ker, bn_a, bn_b)
        print(f"Encryption done in {enc_s:.3f}s")
        print(f"Conv{'+ReLU+boot' if boot else ' (with BN)'} done in "
              f"{conv_s:.3f}s")
        print(precision_stats(want, got))


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    device = "cuda"
    if "--device" in argv:
        k = argv.index("--device")
        device = argv[k + 1]
        del argv[k: k + 2]
    if not argv:
        print(__doc__)
        return 1
    cmd = argv[0]
    for what in (cmd, "--bl", "--debug"):
        if what in MISSING and what in argv:
            raise SystemExit(f"{what}: not ported yet; conv and convReLU run, "
                             f"{MISSING[what]} still missing")
    if cmd not in ("conv", "convReLU"):
        raise SystemExit(f"unknown command {cmd}")
    ker, ib, n = int(argv[1]), int(argv[2]), int(argv[3])
    if ker not in (3, 5, 7):
        raise SystemExit("kernel width must be 3, 5 or 7")
    if n > 10 or not 0 <= ib <= 3:
        raise SystemExit("too many tests (>10) or batch index (>3)")
    run_conv(ker, ib, n, device, boot=cmd == "convReLU")
    return 0
