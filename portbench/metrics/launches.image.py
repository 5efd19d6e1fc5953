"""Kernel launches of one image: the profiler's device events that are
not copies or memsets."""


def read(rec):
    if rec.get("kind") != "image":
        return None
    return rec["profile"]["launches"]
