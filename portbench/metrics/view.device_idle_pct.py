"""Share of a viewer request in which the device runs nothing: 100 (1 -
the device's busy time a request in the traced requests, over the time of
a request in the untraced ones before them). The untraced time, not the
traced span: recording the host's operators slows the host."""


def read(layer):
    if layer.get("kind") != "view":
        return None
    t = layer["trace"]
    return 100.0 * (1.0 - t["busy_s"] / t["units"] / layer["unit_s"])
