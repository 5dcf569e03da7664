"""The work counts behind the rooflines and the step's FLOPs, on cases
small enough to check by hand."""

import math

import numpy as np
import torch

from harness import costs, refmodel as R


def _one_tile(n, opacity, conic, K):
    """n copies of one splat at the centre of a 16x16 image."""
    m2d = torch.full((n, 2), 8.0)
    conics = torch.tensor(conic, dtype=torch.float32).expand(n, 3).contiguous()
    op = torch.full((n,), opacity)
    depth = torch.arange(1, n + 1, dtype=torch.float32)
    tiles = R.Tiles(m2d, torch.full((n,), 5), depth, op, 16, 16, 64, K)
    work = {}
    with torch.no_grad():
        R.composite(tiles, m2d, conics, op, torch.ones((n, 1)), work=work)
    return work


def test_one_splat_counts_the_pixels_past_the_gate():
    work = _one_tile(1, 0.5, (0.25, 0.0, 0.25), 256)
    # alpha = 0.5 exp(-r^2 / 8) passes 1/255 where r^2 < 8 ln(127.5)
    y, x = np.mgrid[0:16, 0:16]
    r2 = (x + 0.5 - 8) ** 2 + (y + 0.5 - 8) ** 2
    assert work["valid"] == int((0.5 * np.exp(-r2 / 8.0) > 1 / 255).sum())
    assert work["slots"] == 1 and work["n_ref"] == 1 and work["tiles"] == 1
    ops, by = costs.fwd_cost(dict(work, CE=1, sub=False))
    assert ops == 256 * 16 + work["valid"] * 4
    assert by == 4 * (1 + 1 + 1 * 7 + 256)


def test_a_saturated_tile_stops_after_its_first_chunk():
    # 200 wide splats at alpha 0.99: every pixel is saturated after the
    # second, so the tile composites one chunk of 128 slots of its 200
    work = _one_tile(200, 0.99, (1e-6, 0.0, 1e-6), 256)
    assert work["slots"] == 128 and work["valid"] == 128 * 256 and work["n_ref"] == 128
    work = _one_tile(200, 0.99, (1e-6, 0.0, 1e-6), 192)  # 192 = 3 chunks of 64
    assert work["slots"] == 64


def test_bounds_and_flops():
    w = dict(slots=1000, valid=100000, valid_sub=50000, n_ref=800, tiles=576, CE=11, sub=True,
             N=60000, entries=1000, grad=True)
    f_ops, f_by = costs.fwd_cost(w)
    b_ops, b_by = costs.bwd_cost(w)
    assert f_ops == 1000 * 256 * 20 + 100000 * 24 + 50000 * 3
    assert b_ops == 1000 * 256 * 20 + 100000 * 82 + 50000 * 15
    assert b_by == 4 * (1000 + 576 + 800 * 18 + 2 * 576 * 256 * 11 + 60000 * 19 + 2 * 800 * 18
                        + 2 * 576 * 256)
    want = max(f_ops / 67e12, f_by / 3.35e12) + max(b_ops / 67e12, b_by / 3.35e12)
    assert math.isclose(costs.compositor_bound_s([w]), want)
    assert costs.flops([w]) == 3 * (300 * 60000 + 1000 * 256 * 42)
    assert costs.flops([dict(w, grad=False)]) == 300 * 60000 + 1000 * 256 * 42
