"""Host ms a fused layer of the profiled image spends in the polynomial
evaluators (``ckks/polyeval.py``): its ``ctos.evalmod`` and ``relu``
stage spans over its ``layer`` spans (the program's recorder,
``optimal_conv_tpu_torch/utils/tracing.py``).  None where the program
records no spans."""


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
    spans = tracing.tree(recs, roots[-1]["id"])
    layers = sum(r["name"] == "layer" for r in spans)
    if not layers:
        return None
    poly = sum(r["t1"] - r["t0"] for r in spans
               if r["name"] in ("ctos.evalmod", "relu"))
    return poly / layers / 1e6
