"""Offline accuracy comparison: encrypted vs plain logits vs labels.

Replaces the Go reference's ``compare_final.py``: scans
per-sample result CSVs (tolerating gaps, so partial/crashed sweeps are
still scoreable — the reference's only resumability mechanism,
SURVEY.md §5), reports enc-vs-plain argmax agreement and, when a labels
file is present, true accuracy of both.

    python -m optimal_conv_tpu_torch.compare <ker> <depth> <wide> [cf100] [n]
"""

from __future__ import annotations

import os
import sys

import numpy as np


def compare(ker: int, depth: int, wide: int, cf100: bool = False,
            num: int = 1000) -> dict:
    tag = "cf100_crop" if cf100 else "crop"
    enc_dir = f"Resnet_enc_results/results_{tag}_ker{ker}_d{depth}_wid{wide}"
    lab_file = f"Resnet_plain_data/{tag}_ker{ker}_d{depth}_wid{wide}/labels.csv"
    labels = np.loadtxt(lab_file).astype(int) if os.path.exists(lab_file) else None

    total = agree = enc_correct = plain_correct = 0
    for i in range(num):
        ef = f"{enc_dir}/class_result_ker{ker}_{i}.csv"
        pf = f"{enc_dir}/plain_result_ker{ker}_{i}.csv"
        if not (os.path.exists(ef) and os.path.exists(pf)):
            continue        # tolerate missing samples (partial runs valid)
        enc = np.loadtxt(ef)
        plain = np.loadtxt(pf)
        total += 1
        ea, pa = int(np.argmax(enc)), int(np.argmax(plain))
        agree += int(ea == pa)
        if labels is not None and i < len(labels):
            enc_correct += int(ea == labels[i])
            plain_correct += int(pa == labels[i])

    out = {"samples": total,
           "enc_vs_plain_agree": agree / total if total else float("nan")}
    if labels is not None and total:
        out["enc_accuracy"] = enc_correct / total
        out["plain_accuracy"] = plain_correct / total
    return out


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    ker, depth, wide = int(argv[0]), int(argv[1]), int(argv[2])
    cf100 = len(argv) > 3 and argv[3].lower() in ("true", "1", "cf100")
    num = int(argv[4]) if len(argv) > 4 else 1000
    res = compare(ker, depth, wide, cf100, num)
    for k, v in res.items():
        print(f"{k}: {v}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
