"""The compositor's share of its roofline in training: the least time of
its forward and backward composites of the traced iterations, from the
benchmark's own projection, tile lists and work counts, over the same
kernels' device time."""


def read(layer):
    if layer.get("kind") != "train" or layer["trace"]["raster_s"] <= 0:
        return None
    return 100.0 * layer["bound_s"] / layer["trace"]["raster_s"]
