"""Command-line driver (counterpart of ``optimal_conv_tpu/cli.py``):

    python -m optimal_conv_tpu_torch conv     <ker 3|5|7> <i_batch 0..3> <n_tests> [--no-bl] [--device cuda|cpu] [--ntt butterfly|mxu|auto]
    python -m optimal_conv_tpu_torch convReLU <ker 3|5|7> <i_batch 0..3> <n_tests> [--no-bl] [--debug] [--device cuda|cpu] [--ntt butterfly|mxu|auto]
    python -m optimal_conv_tpu_torch resnet   <ker> <depth 8|14|20> <wide 1|2|3> <n_tests> [cf100] [--fast] [--debug] [--device cuda|cpu] [--ntt butterfly|mxu|auto]

``conv`` and ``convReLU`` first run the prior-art baseline ("Base Line
start.", ``ops.baseline``: the slot-packed SISO conv over two
ciphertexts) and then the paper's method ("Ours start.") on the same
data, as the Go binary does; ``--no-bl`` skips the baseline.  The
baseline's ``conv`` runs on a chain of its own (logN 16, logQ 60 + 30,
logP 61 + 61, scale 2^30; ``bl_params`` says why not the JAX CLI's);
its ``convReLU`` runs on the Go fork's baseline chain
(``bl_boot_params(16)``): the conv at its top ReLU level, then the two
output ciphertexts packed into one as re + i·im, one bootstrap (StoC
just under EvalMod), the unpacking and the minimax ReLU on each.

The paper's ``conv`` runs the coefficient-packed conv + BN at logN=16 on
the Go fork's exact chain (``boot_params(16)``, as the Go binary's
``conv`` does), for the batch/width pairs {4,16,64,256} ×
{128,64,32,16}.  ``convReLU`` runs the whole fused layer on the same
data: conv + BN, the first bootstrap half (ModRaise, CtoS, EvalMod),
the minimax ReLU, the keep-mask repack and the second half (StoC), kind
``Conv`` at log_sparse 0 with pow 4, as the Go binary's ``convReLU``
does.  Inputs come from ``test_conv_data/`` CSVs when present, else from
seed 0 in the same draw order as the JAX CLI; the numpy conv (and the
exact ReLU) is the golden output.  ``--debug`` decrypts each stage of
the paper's layer and prints its precision against the plaintext mirror
(``ops.debug.DebugOracle``).

``resnet`` runs the encrypted ResNet at logN=16 on ``n_tests`` images:
``models.resnet.ResNetRunner`` (sparse packing), or with ``--fast`` the
crop_fast runners, ``FastResNetRunner`` for wide 1 and
``WideFastResNetRunner`` for wide 2 and 3.  The weights are those of
``Resnet_weights/weights[_cf100]_crop_ker{k}_d{d}_wid{w}/`` when that
directory exists, else ``random_weights(seed=1)``; the images those of
``Resnet_plain_data/`` when present, else uniform in [-1, 1] from seed 2.
Each image's encrypted and plaintext logits go to
``Resnet_enc_results/`` as CSVs, which
``python -m optimal_conv_tpu_torch.compare`` scores; it prints the block
times, whether the argmax agrees and the precision of the logits.
``--debug`` prints the packed input first.

The device defaults to CUDA and is never silently replaced by the CPU.
``--ntt`` picks the route of every NTT of the command (the JAX
package's ``OPTCONV_NTT_BACKEND``, ``CkksContext(ntt_backend=...)``):
``butterfly`` (the default, K2/K3 on the card), ``mxu`` (the four-step
matrix transform on the int8 tensor cores) or ``auto`` (the JAX
package's default rule, tuned for the TPU); all give the same residues.
On an H100 the butterfly is the fastest of the three.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np
import torch

from .ops.debug import precision_stats

BATCHS = [4, 16, 64, 256]
POW = 4.0            # convReLU: values enter the bootstrap divided by 2^POW
WIDTHS = [128, 64, 32, 16]
# real_batch of the ResNet by width (test.go:680-693)
RESNET_BATCHES = {1: (16, 32, 64), 2: (32, 64, 128), 3: (48, 96, 192)}


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
                        bn_a, bn_b, on_stage=None, debug_hook=None):
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
                            0, "Conv", maps, debug_hook=debug_hook,
                            on_stage=on_stage)
    _sync(ctx.device)
    t2 = time.perf_counter()
    got = convops.post_process(ctx.decrypt_decode_coeffs(out), raw_wid, in_wid)
    return got, t1 - t0, t2 - t1


def conv_relu_oracle(ctx, maps, ker_wid: int, i_batch: int, raw, ker, bn_a,
                     bn_b):
    """The ``DebugOracle`` of one ``convReLU`` test: the expected conv + BN
    output on the whole padded grid, channel-interleaved as the layer
    packs it."""
    from .ops import conv as convops
    from .ops.debug import DebugOracle

    p = ctx.params
    in_batch, in_wid = BATCHS[i_batch], WIDTHS[i_batch]
    raw_wid = in_wid - ker_wid // 2
    full = np.zeros((in_wid, in_wid, in_batch))
    full[:raw_wid, :raw_wid] = np.reshape(raw, (raw_wid, raw_wid, in_batch))
    kk = np.reshape(ker, (ker_wid, ker_wid, in_batch, in_batch))
    pc = convops.conv2d_same_np(full, kk) * bn_a + bn_b
    cfs = np.zeros(p.n)
    for b in range(in_batch):
        cfs[b::in_batch] = pc[..., b].ravel()
    return DebugOracle(ctx, in_wid, raw_wid, "Conv", POW, 0, cfs, maps=maps)


# The baseline's convReLU bootstraps 2(z1 + i·z2) undivided and divides
# after the bootstrap, as the Go binary does: the bootstrap's error is
# absolute, so this is more precise than the JAX package's pow + 2.  It
# needs the payload's coefficients inside EvalMod's range, which the data
# of every geometry here keeps (utils/bl_range.py measures both; PERF.md).
BL_SHIFT = 0.0


def bl_params(boot: bool):
    """The baseline's chain.  ``convReLU``: the Go fork's own baseline
    chain, DefaultBootstrapParams[7] (``bl_boot_params``), whose StoC
    primes are 60-bit and whose ReLU primes lie below them.  ``conv``: a
    chain of its own, whose second prime is near the scale 2^30 and whose
    two special primes outweigh a digit.  (The JAX CLI's, logQ 60 + 45
    with one 61-bit special prime and the paper's chain for ``convReLU``,
    lose precision: after the conv's rescale the scale is 2^15, key
    switches add 1e-5 a slot and 1e-2 at slot 0, and on the paper's chain
    the StoC groups and the ReLU fall on 30- and 42-bit primes.)"""
    from .ckks.params import CkksParams, bl_boot_params

    if boot:
        return bl_boot_params(16)
    return CkksParams(log_n=16, logq=(60, 30), logp=(61, 61), log_scale=30,
                      h=192)


def bl_level(params) -> int:
    """The level the baseline encrypts at, one whose prime is near the
    scale, so the rescale after the tap products keeps it: level 1 of the
    conv's chain, or the top ReLU level of the bootstrapping one, which
    also leaves a level for the fold's set_scale before the bootstrap.
    (After the bootstrap, the set_scale that divides by 2^(pow+2-shift)
    and the ReLU take the refreshed ciphertexts from that level to 0.)"""
    if params.boot_layout is None:
        return 1
    return params.boot_layout["relu"][1] - 1


def bl_bootstrapper(ctx):
    """The baseline's bootstrapper: log_sparse 0 with StoC just under
    EvalMod, so the refreshed ciphertext keeps the ReLU's depth."""
    from .ckks.bootstrap import SplitBootstrapper

    stoc_top = ctx.params.boot_layout["evalmod"][0] - 1
    return SplitBootstrapper(ctx, log_sparse=0, stoc_level=stoc_top)


def bl_slots(ker_wid: int, i_batch: int, raw) -> list:
    """The baseline's two slot vectors: channels [0, B/2) and the rest,
    each channel a block of the padded grid (test_BL.go:59-76)."""
    from .ops import baseline as bl

    in_batch, in_wid = BATCHS[i_batch], WIDTHS[i_batch]
    raw_wid = in_wid - ker_wid // 2
    hb = in_batch // 2
    img3 = np.reshape(raw, (raw_wid, raw_wid, in_batch))
    pads = []
    for half in range(2):
        p_in = np.zeros(in_wid * in_wid * hb)
        for b in range(hb):
            blk = np.zeros((in_wid, in_wid))
            blk[:raw_wid, :raw_wid] = img3[..., half * hb + b]
            p_in[b::hb] = blk.ravel()
        pads.append(bl.reshape_input_bl(p_in, in_wid))
    return pads


def encrypted_conv_bl(ctx, btp, ker_wid: int, i_batch: int, raw, ker, bn_a,
                      bn_b):
    """Encrypt `raw` as two slot ciphertexts, run the baseline conv + BN
    (and with a bootstrapper `btp` the packed bootstrap and the ReLU),
    decrypt: → (got, {stage: seconds})."""
    from .ops import baseline as bl

    p = ctx.params
    in_batch, in_wid = BATCHS[i_batch], WIDTHS[i_batch]
    pad = ker_wid // 2
    raw_wid = in_wid - pad
    level = bl_level(p)
    secs = {}
    t0 = time.perf_counter()
    cts = [ctx.encrypt(ctx.encoder.encode_slots(v, p.scale, level))
           for v in bl_slots(ker_wid, i_batch, raw)]
    _sync(ctx.device)
    secs["encryption"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = bl.conv_bl_split(ctx, cts[0], cts[1], ker, bn_a, bn_b, in_wid,
                           ker_wid, in_batch, pad)
    res = [ctx.rescale(ct) for ct in res]
    _sync(ctx.device)
    secs["evaluation"] = time.perf_counter() - t0
    if btp is not None:
        t0 = time.perf_counter()
        res = list(bl.eval_conv_bl_boot_relu(ctx, btp, res[0], res[1], 0.0,
                                             POW, shift=BL_SHIFT))
        _sync(ctx.device)
        secs["boot + relu"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    vals = [ctx.decrypt_decode_slots(ct) for ct in res]
    secs["decryption"] = time.perf_counter() - t0
    got = np.concatenate([bl.post_trim_bl(v, raw_wid, in_wid) for v in vals])
    return bl.post_process_bl(got, raw_wid), secs


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_conv(ker_wid: int, i_batch: int, n_tests: int, device,
             ntt: str = "butterfly", boot: bool = False,
             debug: bool = False) -> list:
    """The paper's method on `n_tests` inputs → [(decrypted, expected)]
    of each."""
    from .ckks.bootstrap import SplitBootstrapper
    from .ckks.context import CkksContext
    from .ckks.params import boot_params
    from .device import resolve_device

    dev = resolve_device(device)
    params = boot_params(16)
    print(f"CKKS parameters: logN={params.log_n} h={params.h} "
          f"levels={len(params.logq)} scale=2^{params.log_scale} device={dev}")
    ctx = CkksContext(params, dev, seed=0, ntt_backend=ntt)
    if boot:
        t0 = time.perf_counter()
        btps = {0: SplitBootstrapper(ctx, log_sparse=0)}
        maps = conv_relu_maps(params, ker_wid, i_batch)
        print(f"Bootstrapper built in {time.perf_counter() - t0:.3f}s")
    rng = np.random.default_rng(0)
    results = []
    for it in range(n_tests):
        print(f"{it + 1}-th iter... start")
        raw, ker, bn_a, bn_b, want = conv_inputs(ker_wid, i_batch, it, rng,
                                                 relu=boot)
        if boot:
            hook = (conv_relu_oracle(ctx, maps, ker_wid, i_batch, raw, ker,
                                     bn_a, bn_b) if debug else None)
            got, enc_s, conv_s = encrypted_conv_relu(
                ctx, btps, maps, ker_wid, i_batch, raw, ker, bn_a, bn_b,
                debug_hook=hook)
        else:
            got, enc_s, conv_s = encrypted_conv(ctx, ker_wid, i_batch, raw,
                                                ker, bn_a, bn_b)
        print(f"Encryption done in {enc_s:.3f}s")
        print(f"Conv{'+ReLU+boot' if boot else ' (with BN)'} done in "
              f"{conv_s:.3f}s")
        print(precision_stats(want, got, distribution=True))
        results.append((got, want))
    return results


def run_conv_bl(ker_wid: int, i_batch: int, n_tests: int, device,
                ntt: str = "butterfly", boot: bool = False) -> None:
    """The prior-art baseline on the data ``run_conv`` then takes
    (main.go:639-643 → test_BL.go:16-185)."""
    from .ckks.context import CkksContext
    from .device import resolve_device

    dev = resolve_device(device)
    params = bl_params(boot)
    print(f"CKKS parameters: logN={params.log_n} logSlots={params.log_slots} "
          f"h={params.h} logQP~{sum(params.logq) + sum(params.logp)} "
          f"levels={len(params.logq)} scale=2^{params.log_scale} device={dev}")
    ctx = CkksContext(params, dev, seed=0, ntt_backend=ntt)
    btp = bl_bootstrapper(ctx) if boot else None
    rng = np.random.default_rng(0)
    for it in range(n_tests):
        print(f"{it + 1}-th iter... start")
        raw, ker, bn_a, bn_b, want = conv_inputs(ker_wid, i_batch, it, rng,
                                                 relu=boot)
        got, secs = encrypted_conv_bl(ctx, btp, ker_wid, i_batch, raw, ker,
                                      bn_a, bn_b)
        print(f"Encryption done in {secs['encryption']:.3f}s")
        print(f"Evaluation total done in {secs['evaluation']:.3f}s")
        if boot:
            print(f"Boot (imaginary pack) + ReLU done in "
                  f"{secs['boot + relu']:.3f}s")
        print(f"Decryption done in {secs['decryption']:.3f}s")
        print(precision_stats(want, got, distribution=True))


def run_resnet(ker_wid: int, depth: int, wide: int, n_tests: int,
               cf100: bool, device, ntt: str = "butterfly",
               debug: bool = False, fast: bool = False) -> None:
    from .ckks.context import CkksContext
    from .ckks.params import boot_params
    from .device import resolve_device
    from .models.plain import load_weights_dir, plain_forward, random_weights
    from .models.resnet import (FastResNetRunner, ResNetConfig, ResNetRunner,
                                WideFastResNetRunner)
    from .ops.debug import prt_mat

    dev = resolve_device(device)
    fc_out = 100 if cf100 else 10
    cfg = ResNetConfig(ker_wid=ker_wid, depth=depth, cf100=cf100,
                       real_batch=RESNET_BATCHES[wide], wide=wide,
                       fc_out=fc_out)
    params = boot_params(16)
    print(f"CKKS parameters: logN={params.log_n} h={params.h} "
          f"levels={len(params.logq)} scale=2^{params.log_scale} device={dev}")
    ctx = CkksContext(params, dev, seed=0, ntt_backend=ntt)
    if fast:
        # wide 1 → testResNet_crop_fast_in (test.go:372); wide 2/3 →
        # testResNet_crop_fast_wide_in (test.go:914, main.go:264-345)
        runner = (FastResNetRunner(ctx, cfg) if wide == 1
                  else WideFastResNetRunner(ctx, cfg))
    else:
        runner = ResNetRunner(ctx, cfg)
    init_batch = cfg.init_batch if wide > 1 else None
    # the Go reference's weight directory when present (test.go:92-100),
    # else deterministic random weights
    pfx = "weights_cf100_crop" if cf100 else "weights_crop"
    weight_dir = f"Resnet_weights/{pfx}_ker{ker_wid}_d{depth}_wid{wide}"
    if os.path.isdir(weight_dir):
        print(f"loading weights from {weight_dir}")
        w = load_weights_dir(weight_dir, ker_wid, depth, cfg.real_batch,
                             fc_out=fc_out, init_batch=init_batch)
    else:
        w = random_weights(ker_wid, depth, cfg.real_batch, fc_out=fc_out,
                           seed=1, init_batch=init_batch)
    rng = np.random.default_rng(2)
    out_dir = (f"Resnet_enc_results/results_crop_ker{ker_wid}_d{depth}"
               f"_wid{wide}")
    os.makedirs(out_dir, exist_ok=True)
    raw0, w0 = cfg.raw_in_wids[0], cfg.in_wids[0]
    pfx_d = "cf100_crop" if cf100 else "crop"
    for it in range(n_tests):
        img_file = (f"Resnet_plain_data/{pfx_d}_ker{ker_wid}_d{depth}"
                    f"_wid{wide}/test_image_{it}.csv")
        if os.path.exists(img_file):
            # the image CSVs hold the whole in_wid² grid, of which only the
            # raw_in_wid² top-left corner is meaningful (test.go:129-148)
            image = np.loadtxt(img_file).reshape(w0, w0, 3)[:raw0, :raw0]
        else:
            image = rng.uniform(-1, 1, (raw0, raw0, 3))
        if debug:
            # packed-input matrix view (test.go:151)
            _, mb, _, norm = runner.layout(0)
            prt_mat(runner.packed_image(image), mb, show=3, norm=norm)
        timings: dict = {}
        t0 = time.perf_counter()
        logits = runner.infer(image, w, timings)
        _sync(dev)
        total = time.perf_counter() - t0
        plain = plain_forward(w, image, depth, cfg.raw_in_wids)
        np.savetxt(f"{out_dir}/class_result_ker{ker_wid}_{it}.csv", logits)
        np.savetxt(f"{out_dir}/plain_result_ker{ker_wid}_{it}.csv", plain)
        agree = int(np.argmax(logits) == np.argmax(plain))
        for k, v in timings.items():
            print(f"  {k}: {v:.1f}s")
        print(f"sample {it}: total {total:.1f}s, argmax agree={agree}")
        print(precision_stats(plain, logits, distribution=True))


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    device = "cuda"
    if "--device" in argv:
        k = argv.index("--device")
        device = argv[k + 1]
        del argv[k: k + 2]
    ntt = "butterfly"
    if "--ntt" in argv:
        k = argv.index("--ntt")
        ntt = argv[k + 1]
        del argv[k: k + 2]
        if ntt not in ("butterfly", "mxu", "auto"):
            raise SystemExit("--ntt must be butterfly, mxu or auto")
    debug = "--debug" in argv
    fast = "--fast" in argv
    skip_bl = "--no-bl" in argv
    argv = [a for a in argv if a not in ("--debug", "--fast", "--no-bl")]
    if not argv:
        print(__doc__)
        return 1
    cmd = argv[0]
    if cmd == "resnet":
        ker, depth, wide, n = (int(x) for x in argv[1:5])
        cf100 = argv[5].lower() in ("true", "1") if len(argv) > 5 else False
        if depth not in (8, 14, 20):
            raise SystemExit("depth must be 8, 14 or 20")
        if wide not in RESNET_BATCHES:
            raise SystemExit("wide must be 1, 2 or 3")
        run_resnet(ker, depth, wide, n, cf100, device, ntt, debug=debug,
                   fast=fast)
        return 0
    if cmd not in ("conv", "convReLU"):
        raise SystemExit(f"unknown command {cmd}")
    ker, ib, n = int(argv[1]), int(argv[2]), int(argv[3])
    if ker not in (3, 5, 7):
        raise SystemExit("kernel width must be 3, 5 or 7")
    if n > 10 or not 0 <= ib <= 3:
        raise SystemExit("too many tests (>10) or batch index (>3)")
    boot = cmd == "convReLU"
    # the prior art, then the paper's method, on the same data
    # (main.go:639-643)
    if not skip_bl:
        print("Base Line start.")
        run_conv_bl(ker, ib, n, device, ntt, boot=boot)
    print("Ours start.")
    run_conv(ker, ib, n, device, ntt, boot=boot, debug=debug)
    return 0
