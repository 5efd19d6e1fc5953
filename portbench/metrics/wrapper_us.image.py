"""Mean host us of a hand-kernel wrapper call (``core/*_kernel.py``),
from its entry to its launch, over the profiled image: the ``kernels``
tallies of every span of the ``image`` span (the program's recorder,
``optimal_conv_tpu_torch/utils/tracing.py``).  None where the program
records no spans or the image launched no hand kernel."""


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
    calls = ns = 0
    for r in tracing.tree(recs, roots[-1]["id"]):
        for n, t, _ in r["kernels"].values():
            calls += n
            ns += t
    return ns / calls / 1e3 if calls else None
