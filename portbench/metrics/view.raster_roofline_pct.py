"""The compositor forward's share of its roofline in serving: the least
time of the traced requests' composites, from the benchmark's own
projection, tile lists and work counts, over the same kernels' device
time."""


def read(layer):
    if layer.get("kind") != "view" or layer["trace"]["raster_s"] <= 0:
        return None
    return 100.0 * layer["bound_s"] / layer["trace"]["raster_s"]
