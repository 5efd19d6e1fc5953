#!/usr/bin/env python3
"""The control of a cell's correctness check: the plain reference put in
the program's place (the model kind ``portbench/models/control.py``),
computed in the precision below the one the configuration states, and
driven through the harness's own set-up, window and check.  Its result
has to come out not correct.

    python3 portbench/control.py --workload <name> --seeds 1 2 3 [--fmt F] [--seconds S]

prints one JSON line a seed: `correct` and each compared number beside
its limit.  F defaults to the control of the cell's kind: float8_e4m3fn
below the bfloat16 the image cells state, bfloat16 below the conv cell's
float32.  The weights and inputs are those a run of the same seed makes
on the same device."""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

HERE = pathlib.Path(__file__).resolve().parent
if str(HERE.parent) not in sys.path:
    sys.path.insert(0, str(HERE.parent))

CONTROL = {"image": "float8_e4m3fn", "conv": "bfloat16"}


def cell_of(cell: dict, fmt: str | None = None) -> dict:
    """The cell with the control in the program's place."""
    fmt = fmt or CONTROL[cell["traffic"]["entry"]]
    cfg = dict(cell["config"], model="control",
               control=dict(of=cell["config"]["model"], fmt=fmt))
    return dict(cell, config=cfg)


def result(cell: dict, seed: int, seconds: float, device: str,
           fmt: str | None = None) -> dict:
    """The control's result line on the cell's inputs of `seed`."""
    from portbench import run
    ctl = cell_of(cell, fmt)
    rec = run.measure(ctl, seed, seconds, False, device=device)
    return run.result(ctl, rec, False, 1, device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--fmt")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from portbench import common
    cell = common.cell(args.workload)
    fmt = args.fmt or CONTROL[cell["traffic"]["entry"]]
    for seed in args.seeds:
        out = result(cell, seed, args.seconds, args.device, fmt)
        print(json.dumps(dict(workload=args.workload, seed=seed, fmt=fmt,
                              correct=out["correct"],
                              attempted=out["attempted"],
                              failed=out["failed"], **out["compared"])),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
