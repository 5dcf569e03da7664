"""Host ms an iteration in the step's update (span
``iteration/step/update``: densify statistics, learning rates, BLCE clip,
Adam), over the iterations after the profiled stretch."""

from harness.spans import tail_ms


def read(layer):
    return tail_ms(layer, "iteration/step/update")
