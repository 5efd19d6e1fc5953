"""Host seconds the process spent building bootstrappers
(``BootstrapperFamily``: the slot encoding of every diagonal), the
counter ``boot.build_s`` since the process started (the program's
recorder, ``optimal_conv_tpu_torch/utils/tracing.py``).  None where the
program has no such counter."""


def read(rec):
    if rec.get("kind") != "image":
        return None
    try:
        from optimal_conv_tpu_torch.utils import tracing
    except ImportError:
        return None
    return tracing.counters().get("boot.build_s")
