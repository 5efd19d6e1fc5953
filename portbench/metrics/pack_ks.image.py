"""Key-switch rows the profiled image's conv packs run: the counter
``conv.pack.keyswitches`` (C − 1 a conv of C kernel plaintexts, the
head's included) that moved inside its ``image`` span (the program's
recorder, ``optimal_conv_tpu_torch/utils/tracing.py``).  None where the
program counts no such rows."""


def read(rec):
    if rec.get("kind") != "image":
        return None
    try:
        from optimal_conv_tpu_torch.utils import tracing
    except ImportError:
        return None
    roots = [r for r in tracing.records()
             if r["name"] == "image" and not r["parent"]]
    if not roots:
        return None
    return roots[-1]["counters"].get("conv.pack.keyswitches")
