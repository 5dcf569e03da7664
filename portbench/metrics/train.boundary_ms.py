"""Host ms an iteration at the loop's boundaries: the capacity and budget
checks and densify with pool growth (spans ``iteration/budgets`` and
``iteration/densify``), over the iterations after the profiled stretch."""

from harness.spans import tail_ms


def read(layer):
    return tail_ms(layer, "iteration/budgets", "iteration/densify")
