"""The share of the profiled image's polynomial evaluations (EvalMod and
the ReLU) that a CUDA graph replayed: the counters ``graph.replays`` and
``graph.eager`` that moved inside its ``image`` span, as 100 · replays /
(replays + eager) (the program's recorder,
``optimal_conv_tpu_torch/utils/tracing.py``).  None where the program
counts neither."""


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
    replays = moved.get("graph.replays", 0)
    calls = replays + moved.get("graph.eager", 0)
    if not calls:
        return None
    return 100.0 * replays / calls
