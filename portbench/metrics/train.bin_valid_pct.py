"""Share of the tile binning's sorted keys that are valid (a splat's
entry inside its box, not culled): 100 ``bin.valid`` / ``bin.candidates``
over the iterations after the profiled stretch. The rest of the radix
sort's keys are padding."""

from harness.spans import counters


def read(layer):
    c = counters(layer)
    if not c or not c.get("bin.candidates"):
        return None
    return 100.0 * c["bin.valid"] / c["bin.candidates"]
