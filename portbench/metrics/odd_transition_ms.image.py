"""Host ms of the profiled image's ``StrConv_odd`` transition: its
``transition`` spans, each holding the transition's fused-layer calls
(two halves at wide 3) and their sum (the program's recorder,
``optimal_conv_tpu_torch/utils/tracing.py``).  None where the image has
no such span or the program records none."""


def read(rec):
    if rec.get("kind") != "image":
        return None
    try:
        from optimal_conv_tpu_torch.utils import tracing
    except ImportError:
        return None
    recs = tracing.records()
    roots = [r for r in recs if r["name"] == "image" and not r["parent"]]
    if not roots:
        return None
    spans = [r for r in tracing.tree(recs, roots[-1]["id"])
             if r["name"] == "transition"]
    if not spans:
        return None
    return sum(r["t1"] - r["t0"] for r in spans) / 1e6
