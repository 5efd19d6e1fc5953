"""Mean host ms of one ``eval_conv_bn_relu`` call, each span starting and
ending in a synchronise (the span image of the traced pass)."""


def read(rec):
    if rec.get("kind") != "image" or not rec["layers_s"]:
        return None
    return sum(rec["layers_s"]) / len(rec["layers_s"]) * 1e3
