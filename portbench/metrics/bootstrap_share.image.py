"""Share of the fused layers' host time after their conv stage: CtoS,
EvalMod, the ReLU, the repack and StoC (the bootstrapper and the ReLU),
from the span image's ``on_stage`` mark at the conv stage's end."""


def read(rec):
    if rec.get("kind") != "image":
        return None
    if len(rec["conv_s"]) != len(rec["layers_s"]):
        return None
    total = sum(rec["layers_s"])
    return 100.0 * (total - sum(rec["conv_s"])) / total
