"""Switching keys drawn in the profiled warm image: the counters
``keys.made`` (a key made at a miss) and ``keys.d1_drawn`` (a compressed
key's d1 regenerated from its seed) that moved inside its ``image`` span
(the program's recorder, ``optimal_conv_tpu_torch/utils/tracing.py``).
None where the program records no spans."""


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
    moved = roots[-1]["counters"]
    return moved.get("keys.made", 0) + moved.get("keys.d1_drawn", 0)
