"""Share of an iteration in which the device runs nothing: 100 (1 - the
device's busy time an iteration in the traced stretch, over the time of an
iteration in the untraced stretch before it). The untraced time, not the
traced span: recording the host's operators slows the host, so the traced
span is longer than a user's iteration."""


def read(layer):
    if layer.get("kind") != "train":
        return None
    t = layer["trace"]
    return 100.0 * (1.0 - t["busy_s"] / t["units"] / layer["unit_s"])
