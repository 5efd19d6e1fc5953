"""Share of the profiled image's host time inside outermost evaluator
calls (the public ``CkksContext`` ops, a call inside another counted
once): the ``eval`` tallies of every span of the ``image`` span over its
length (the program's recorder, ``optimal_conv_tpu_torch/utils/
tracing.py``).  The rest is the stages' own Python and the encoder.
None where the program records no spans."""


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
    root = roots[-1]
    ns = sum(r["eval"][1] for r in tracing.tree(recs, root["id"]))
    return 100.0 * ns / (root["t1"] - root["t0"])
