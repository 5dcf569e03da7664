"""Device time of the compositor's kernels (``raster_fwd*`` and
``raster_bwd*``) per training iteration, in the traced stretch (ms)."""


def read(layer):
    if layer.get("kind") != "train":
        return None
    t = layer["trace"]
    return 1e3 * t["raster_s"] / t["units"]
