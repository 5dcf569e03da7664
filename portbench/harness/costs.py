"""The work the compositor and the step need, counted from the benchmark's
own projection and tile lists (``refmodel``), never from the program's:
the operations and bytes of each composite and its backward (the
arithmetic of ``chip_smoke.py::raster_fwd_cost`` / ``raster_bwd_cost``),
their least time on the card, and the step's FLOPs (the model of
``utils/observability.py::analytic_step_flops``)."""

from __future__ import annotations

# one H100 SXM, dense, at its 700 W limit: float32 outside the tensor
# cores, HBM3 bandwidth (NVIDIA's data sheet)
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12
RECORD = 8      # the compositor's record row
PIX = 256


def fwd_cost(w):
    """(operations, bytes) of one forward composite."""
    CE, T = w["CE"], w["tiles"]
    pairs = w["slots"] * PIX
    ops = pairs * 16 + w["valid"] * (2 + 2 * CE)
    by = 4 * (w["slots"] + T + w["n_ref"] * (6 + CE) + T * PIX * CE)
    if w["sub"]:
        ops += pairs * 4 + w["valid_sub"] * 3
        by += 4 * (w["n_ref"] + T * PIX)
    return ops, by


def bwd_cost(w):
    """(operations, bytes) of the backward of one composite."""
    CE, T = w["CE"], w["tiles"]
    pairs = w["slots"] * PIX
    rows = 7 if w["sub"] else 6
    ops = pairs * 16 + w["valid"] * (38 + 4 * CE)
    by = 4 * (w["slots"] + T + w["n_ref"] * (rows + CE) + 2 * T * PIX * CE
              + w["N"] * (RECORD + CE) + 2 * w["n_ref"] * (rows + CE))
    if w["sub"]:
        ops += pairs * 4 + w["valid_sub"] * 15
        by += 4 * 2 * T * PIX
    return ops, by


def bound_s(ops, by):
    return max(ops / PEAK_F32, by / PEAK_BYTES)


def compositor_bound_s(works):
    """Least time of the composites in ``works`` (each with ``grad``: its
    backward ran too)."""
    total = 0.0
    for w in works:
        total += bound_s(*fwd_cost(w))
        if w["grad"]:
            total += bound_s(*bwd_cost(w))
    return total


def flops(works):
    """FLOPs of the composites in ``works`` and their projections: 300 a
    splat projected, (20 + 2 C) a (tile entry, pixel) pair, the backward
    twice the forward."""
    total = 0.0
    for w in works:
        f = 300.0 * w["N"] + w["entries"] * PIX * (20.0 + 2.0 * w["CE"])
        total += 3.0 * f if w["grad"] else f
    return total
