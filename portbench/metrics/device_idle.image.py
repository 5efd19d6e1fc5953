"""Share of the profiled image's window in which no device event ran."""


def read(rec):
    if rec.get("kind") != "image":
        return None
    p = rec["profile"]
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
