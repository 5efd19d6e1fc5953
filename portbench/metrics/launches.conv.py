"""Kernel launches a conv request: the profiler's device events that are
not copies or memsets, over the profiled pass's requests."""


def read(rec):
    if rec.get("kind") != "conv":
        return None
    return rec["profile"]["launches"] / rec["requests"]
