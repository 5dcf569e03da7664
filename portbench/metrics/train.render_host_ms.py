"""Host ms an iteration in the render chain under the step's forward
(span ``iteration/step/forward/render``: every ``models/render.py`` entry
the forward calls; a part of ``train.forward_host_ms``), over the
iterations after the profiled stretch."""

from harness.spans import tail_ms


def read(layer):
    return tail_ms(layer, "iteration/step/forward/render")
