"""The NTT kernels' share of their roofline over the profiled image.

The least time of each NTT row the image ran (rows from the program's
``ntt_fwd`` / ``ntt_inv`` / ``mxu_fwd`` / ``mxu_inv`` counters, whichever
route computed them) is the larger of its bytes at the HBM rate and its
butterflies at the frozen issue slots (``portbench/yardstick.json``);
their sum over the device seconds of the kernels the yardstick's name
table calls NTT kernels.  None where the image ran no NTT kernel."""

from portbench import common

ROUTES = {"ntt_fwd": False, "ntt_inv": True, "mxu_fwd": False,
          "mxu_inv": True}


def read(rec):
    if rec.get("kind") != "image":
        return None
    ys, log_n = rec["yardstick"], rec["config"]["params"]["log_n"]
    least = sum(int(rows) * calls * common.ntt_row_seconds(ys, log_n, inv)
                for name, inv in ROUTES.items()
                for rows, calls in rec["counters"].get(name, {}).items())
    spent = sum(s for k, (_, s) in rec["profile"]["by_name"].items()
                if common.ntt_group(ys, k))
    if not spent or not least:
        return None
    return 100.0 * least / spent
