"""Host ms a conv request spends in kernel encoding: the span around the
``ops/conv`` module's global ``prep_ker``, ending in a synchronise."""


def read(rec):
    if rec.get("kind") != "conv" or not rec["encode_s"]:
        return None
    return sum(rec["encode_s"]) / rec["requests"] * 1e3
