"""Device kernels launched per viewer request, in the traced requests."""


def read(layer):
    if layer.get("kind") != "view":
        return None
    t = layer["trace"]
    return t["kernels"] / t["units"]
