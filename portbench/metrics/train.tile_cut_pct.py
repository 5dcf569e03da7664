"""Share of the binning's valid entries dropped by the per-tile cut at
``max_per_tile``: 100 (``bin.valid`` - ``bin.kept``) / ``bin.valid`` over
the iterations after the profiled stretch."""

from harness.spans import counters


def read(layer):
    c = counters(layer)
    if not c or not c.get("bin.valid"):
        return None
    return 100.0 * (c["bin.valid"] - c["bin.kept"]) / c["bin.valid"]
