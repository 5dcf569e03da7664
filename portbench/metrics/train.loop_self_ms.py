"""Host ms an iteration in the loop's own work: the span ``iteration``
less the step's forward, backward and update, the exposure update, the
budget checks and densify (the batch, the step's glue, the log reads and
the loop's Python), over the iterations after the profiled stretch. With
the five other host metrics but the render chain, it sums to the
iteration's host time."""

from harness.spans import PARTITION, tail_ms


def read(layer):
    total = tail_ms(layer, "iteration")
    if total is None:
        return None
    return total - tail_ms(layer, *PARTITION)
