"""Host ms of the profiled image's plain ``StrConv`` transition: its
``transition`` spans of kind "StrConv", each holding the transition's
two fused-layer calls (the out-channel halves at pack_pos 0 and 1) and
their sum (the program's recorder,
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
             if r["name"] == "transition"
             and r["attrs"].get("kind") == "StrConv"]
    if not spans:
        return None
    return sum(r["t1"] - r["t0"] for r in spans) / 1e6
