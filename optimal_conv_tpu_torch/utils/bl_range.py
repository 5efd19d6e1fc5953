"""The baseline's packed bootstrap against the size of its payload.

    python -m optimal_conv_tpu_torch.utils.bl_range [--geoms 3:0,3:1,3:2,3:3,5:0,7:0] [--shifts 6,3,0] [--device cuda]

The baseline's ``convReLU`` (``cli.encrypted_conv_bl``) bootstraps the
two conv outputs packed as 2(z1 + i·z2) / 2^shift.  EvalMod's sine is
exact only while every coefficient c of that payload stays small against
q0/Δ0 (2^8 on the Go fork's chains), and the bootstrap's error is
absolute, so the shift trades range for precision.  For each geometry
``ker:i_batch`` this runs the baseline conv once on the data ``cli
convReLU <ker> <i_batch> 1`` takes, prints the payload's largest slot and
coefficient, then the packed bootstrap and ReLU at each shift, with the
precision against numpy's conv + exact ReLU and, on ``3:0``, the
agreement with the Go binary's baseline values.  The CLI's shift is
``cli.BL_SHIFT``.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

from .. import cli
from ..ckks.context import CkksContext
from ..ckks.encoding import slots_to_coeffs_np
from ..device import resolve_device
from ..ops import baseline as bl

GOLDEN = os.path.join(os.path.dirname(__file__), "..", "..", "tests",
                      "golden", "ref_conv_3_0_1.json")


def _bits(got, want) -> np.ndarray:
    return -np.log2(np.abs(np.asarray(got) - np.asarray(want)) + 1e-300)


def geometry(ctx, btp, ker_wid: int, i_batch: int, shifts) -> dict:
    raw, ker, bn_a, bn_b, pre = cli.conv_inputs(
        ker_wid, i_batch, 0, np.random.default_rng(0))
    want = np.maximum(pre, 0.0)
    in_wid = cli.WIDTHS[i_batch]
    pad = ker_wid // 2
    raw_wid = in_wid - pad
    p = ctx.params
    t0 = time.perf_counter()
    cts = [ctx.encrypt(ctx.encoder.encode_slots(v, p.scale, cli.bl_level(p)))
           for v in cli.bl_slots(ker_wid, i_batch, raw)]
    res = bl.conv_bl_split(ctx, cts[0], cts[1], ker, bn_a, bn_b, in_wid,
                           ker_wid, cli.BATCHS[i_batch], pad)
    res = [ctx.rescale(ct) for ct in res]
    cli._sync(ctx.device)
    conv_s = time.perf_counter() - t0
    z1, z2 = (np.real(ctx.decrypt_decode_slots(ct)) for ct in res)
    payload = 2.0 * (z1 + 1j * z2)
    coeff = np.abs(slots_to_coeffs_np(payload)).max()
    row = dict(geometry=f"{ker_wid}:{i_batch}", max_abs_z=float(np.abs(pre).max()),
               std_z=float(pre.std()), payload_slot_max=float(np.abs(payload).max()),
               payload_coeff_max=float(coeff), conv_s=conv_s, shifts={})
    print(f"{ker_wid}:{i_batch}: conv {conv_s:.2f} s, |z| max {row['max_abs_z']:.3f}"
          f" std {row['std_z']:.3f}; payload 2(z1 + i z2): slot max "
          f"{row['payload_slot_max']:.3f}, coefficient max {coeff:.4f} "
          f"(x = c·Δ0/q0 = {coeff * btp.delta0 / btp.q0:.3e} at shift 0)")
    go = None
    if (ker_wid, i_batch) == (3, 0):
        with open(GOLDEN) as f:
            go = np.array(json.load(f)["convReLU"]["bl"]["values_test"])
    for shift in shifts:
        t0 = time.perf_counter()
        outs = bl.eval_conv_bl_boot_relu(ctx, btp, res[0], res[1], 0.0,
                                         cli.POW, shift=shift)
        cli._sync(ctx.device)
        secs = time.perf_counter() - t0
        vals = [ctx.decrypt_decode_slots(ct) for ct in outs]
        got = bl.post_process_bl(np.concatenate(
            [bl.post_trim_bl(v, raw_wid, in_wid) for v in vals]), raw_wid)
        prec = _bits(got, want)
        one = dict(mean_bits=float(prec.mean()), min_bits=float(prec.min()),
                   max_abs_err=float(np.abs(got - want).max()), secs=secs)
        if go is not None:
            one["go_agreement_bits"] = float(_bits(got[:10], go).mean())
        row["shifts"][str(shift)] = one
        print(f"  shift {shift:g}: boot + ReLU {secs:.2f} s; against numpy mean "
              f"{one['mean_bits']:.2f} min {one['min_bits']:.2f} bits, max |err| "
              f"{one['max_abs_err']:.3e}"
              + (f"; against the Go binary {one['go_agreement_bits']:.2f} bits"
                 if go is not None else ""))
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--geoms", default="3:0,3:1,3:2,3:3,5:0,7:0")
    ap.add_argument("--shifts", default="6,3,0")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    shifts = [float(s) for s in args.shifts.split(",")]
    ctx = CkksContext(cli.bl_params(True), dev, seed=0)
    btp = cli.bl_bootstrapper(ctx)
    rows = []
    for g in args.geoms.split(","):
        k, ib = (int(v) for v in g.split(":"))
        rows.append(geometry(ctx, btp, k, ib, shifts))
    print(json.dumps({"bl_range": rows, "cli_shift": cli.BL_SHIFT}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
