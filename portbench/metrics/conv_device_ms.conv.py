"""Device ms a conv request: the busy union of the profiled pass's device
events over its requests."""


def read(rec):
    if rec.get("kind") != "conv":
        return None
    return rec["profile"]["busy_s"] / rec["requests"] * 1e3
