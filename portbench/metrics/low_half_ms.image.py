"""Host ms a two-half fused layer of the profiled image spends in its
lower half: its ``relu.half`` and ``repack.half`` spans with ``ul`` 1,
over the ``layer`` spans whose ``halves`` is 2 (log_sparse 0: CtoS gives
an upper and a lower half; the program's recorder,
``optimal_conv_tpu_torch/utils/tracing.py``).  None where no layer has
two halves or the program records no such spans."""


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
    layers = sum(r["name"] == "layer" and r["attrs"].get("halves") == 2
                 for r in spans)
    if not layers:
        return None
    low = sum(r["t1"] - r["t0"] for r in spans
              if r["name"] in ("relu.half", "repack.half")
              and r["attrs"].get("ul") == 1)
    return low / layers / 1e6
