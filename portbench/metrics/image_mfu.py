"""The image's share of the chip's peak rate of 64-bit modular
multiplications: the configuration's fixed work (``image_work`` in its
file, counted once on the card) over the span image's seconds times the
peak (``portbench/yardstick.json``: the int32 issue rate over the frozen
slots of one Montgomery product)."""

from portbench import common


def read(rec):
    if rec.get("kind") != "image" or "image_work" not in rec["config"]:
        return None
    work = rec["config"]["image_work"]["modmul"]
    peak = common.modmul_per_s(rec["yardstick"])
    return 100.0 * work / (rec["image_s"] * peak)
