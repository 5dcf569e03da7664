"""Host ms an iteration in the exposure re-estimation (span
``iteration/expo_update``, every 10 iterations past
``start_warp_exposure``; 0 where the stretch held none), over the
iterations after the profiled stretch."""

from harness.spans import tail_ms


def read(layer):
    return tail_ms(layer, "iteration/expo_update")
