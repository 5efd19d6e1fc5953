"""Host ms the profiled image spends encoding plaintexts: its outermost
``encode`` and ``encode.kernel`` spans (the program's recorder,
``optimal_conv_tpu_torch/utils/tracing.py``): the conv kernels, the
repack masks on a cache miss, the head's plaintexts and the input's
encoding.  None where the program records no spans."""


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
    enc = tracing.outermost(spans, ("encode", "encode.kernel"))
    return sum(r["t1"] - r["t0"] for r in enc) / 1e6
