"""Device kernels launched per training iteration, in the traced stretch
(profiler: kernels / iterations profiled)."""


def read(layer):
    if layer.get("kind") != "train":
        return None
    t = layer["trace"]
    return t["kernels"] / t["units"]
