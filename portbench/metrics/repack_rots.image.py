"""Rotations the profiled image's masked rotate-sum repacks run: the
counter ``repack.rotations`` (one a map of ``ext_ctxt``, and of each
stage of ``ext_double_ctxt``) that moved inside its ``image`` span (the
program's recorder, ``optimal_conv_tpu_torch/utils/tracing.py``).  None
where the program counts no such rotations."""


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
    return roots[-1]["counters"].get("repack.rotations")
