"""Host ms of an image outside the fused-layer spans (encryption, the
repacks between calls, the head with its plaintext encoding,
decryption), from the traced pass's span image."""


def read(rec):
    if rec.get("kind") != "image":
        return None
    return (rec["image_s"] - sum(rec["layers_s"])) * 1e3
