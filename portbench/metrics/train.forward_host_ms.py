"""Host ms an iteration in the step's forward (span
``iteration/step/forward``: the losses' graph, the renders included), over
the iterations after the profiled stretch, spans on."""

from harness.spans import tail_ms


def read(layer):
    return tail_ms(layer, "iteration/step/forward")
