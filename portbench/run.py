#!/usr/bin/env python3
"""Run one cell of the benchmark of ``optimal_conv_tpu_torch`` once.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with as many NVIDIA GPUs as the
cell asks for.  The cell (``BENCHMARK.json``) names a configuration file,
a traffic mix (``portbench/traffic/<mix>.json``, which names its entry,
``portbench/traffic/<entry>.py``) and, by its own name, its limits
(``portbench/limits/<cell>.json``); the configuration names its model
kind (``portbench/models/<kind>.py``).  Set-up builds the program's
context, keys and runner from the seed and warms every shape; then
``--trace 0`` measures the window of ``--seconds`` and prints the cell's
end-to-end metrics, ``--trace 1`` runs the traced pass and prints its
per-layer metrics, each read by ``portbench/metrics/<metric>.py``.  Either
way the outputs the timed path produced are then held to the plain
reference (``portbench/reference``), and the last line of standard output
is the result as one JSON object.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse                                          # noqa: E402
import contextlib                                        # noqa: E402
import importlib                                         # noqa: E402
import importlib.util                                    # noqa: E402
import json                                              # noqa: E402
import pathlib                                           # noqa: E402
import sys                                               # noqa: E402

HERE = pathlib.Path(__file__).resolve().parent
if str(HERE.parent) not in sys.path:
    sys.path.insert(0, str(HERE.parent))

# top-level module names the process must not hold: JAX and the JAX
# package the port was made from (names compared whole: the port's name
# begins with the JAX package's)
BANNED = frozenset({"jax", "jaxlib", "flax", "optimal_conv_tpu"})


def banned_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & BANNED)


def read_per_layer(cell: dict, rec: dict) -> dict:
    """Each per-layer metric of the cell from its reader; a reader that
    finds nothing to read returns None and the metric is left out."""
    out = {}
    for m in cell["per_layer"]:
        path = HERE / "metrics" / f"{m['name']}.py"
        spec = importlib.util.spec_from_file_location(
            "portbench_metric_" + m["name"].replace(".", "_"), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        value = mod.read(rec)
        if value is not None:
            out[m["name"]] = dict(value=float(value), unit=m["unit"])
    return out


def measure(cell: dict, seed: int, seconds: float, trace: bool,
            device: str = "cuda", t_start: float | None = None) -> dict:
    """Set up, run the window or the traced pass, check: → the record."""
    import torch

    from portbench import common, load

    t_start = time.perf_counter() if t_start is None else t_start
    cuda = device != "cpu"

    def sync():
        if cuda:
            torch.cuda.synchronize()
    cfg = cell["config"]
    kind = importlib.import_module(f"portbench.models.{cfg['model']}")
    # the program's progress lines go to standard error: the result is
    # the last line of standard output
    with contextlib.redirect_stdout(sys.stderr):
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        model = kind.Model(cfg, seed, device)
        model.build()
        entry = load.entry(model, cell["traffic"], sync)
        entry.setup()
        sync()
        # the plain reference's seconds (the inputs' scale, the conv
        # requests' client features) are the benchmark's, not set-up's
        setup_s = time.perf_counter() - t_start - model.ref_s
        rec = entry.traced() if trace else entry.window(seconds)
        sync()
        peak = torch.cuda.max_memory_allocated() if cuda else 0
        compared, attempted, failed = entry.check(cell["limits"])
    rec.update(setup_s=setup_s, peak_gib=peak / common.GIB, peak=peak,
               compared=compared, attempted=attempted, failed=failed,
               config=cfg, yardstick=common.yardstick())
    if trace:
        rec["modmul_counted"] = common.modmul_work(
            rec["counters"], cfg["params"]["log_n"])
    return rec


def result(cell: dict, rec: dict, trace: bool, chips: int,
           kind: str) -> dict:
    """The result line's object from a run's record; `kind` names the
    card (``torch.cuda.get_device_name``)."""
    from portbench import trace as tr
    lim = cell["limits"]
    compared = {k: dict(value=v, limit=lim[k])
                for k, v in rec["compared"].items()}
    correct = (rec["attempted"] > 0 and rec["failed"] == 0
               and all(c["value"] <= c["limit"] for c in compared.values()))
    if trace:
        metrics = read_per_layer(cell, rec)
    else:
        metrics = {m["name"]: dict(value=float(rec[m["name"]]),
                                   unit=m["unit"])
                   for m in cell["end_to_end"]}
    device = dict(platform="gpu", kind=kind,
                  count=chips, memory_peak_bytes=int(rec["peak"]))
    out = dict(correct=correct, attempted=rec["attempted"],
               failed=rec["failed"], metrics=metrics, device=device)
    if trace:
        red = rec["profile"]
        device.update(busy_s=red["busy_s"], window_s=red["window_s"])
        out["breakdown"] = tr.breakdown(red)
    out["compared"] = compared
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from portbench import common
    cell = common.cell(args.workload)
    chips = cell["workload"]["chips"]
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {chips} CUDA device(s); this machine "
              f"has {have}", file=sys.stderr)
        return 2
    rec = measure(cell, args.seed, args.seconds, bool(args.trace),
                  t_start=T_START)
    found = banned_modules()
    if found:
        print(f"the process holds {', '.join(found)}: the benchmark runs the "
              "port alone", file=sys.stderr)
        return 3
    out = result(cell, rec, bool(args.trace), chips,
                 torch.cuda.get_device_name(0))
    if args.trace:
        print(f"modular multiplications counted in the profiled pass: "
              f"{rec['modmul_counted']}", file=sys.stderr)
    for name, c in out["compared"].items():
        print(f"compared {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
