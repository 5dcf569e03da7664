"""Host ms an iteration in autograd's backward (span
``iteration/step/backward``), over the iterations after the profiled
stretch."""

from harness.spans import tail_ms


def read(layer):
    return tail_ms(layer, "iteration/step/backward")
