"""Tile binning for the Gaussian rasterizer (port of
``mobgs_tpu/ops/tiles.py``).

1. every Gaussian expands to a fixed budget of ``tiles_per_gauss``
   candidate (tile, gaussian) entries covering its screen bbox (row-major;
   the bbox is radius-clamped so it always fits the budget),
2. each entry gets a fused int32 sort key ``tile_id << depth_bits |
   depth_key``, where ``depth_key`` is the top bits of the positive
   float32 depth's bit pattern (monotonic for positive floats); invalid
   entries get INT32_MAX,
3. one stable key-value sort yields contiguous per-tile, front-to-back
   runs; per-tile segment starts come from a ``searchsorted``,
4. the compositor reads at most ``max_per_tile`` front-most entries per
   tile (overflow drops the farthest Gaussians).

Given the same splats, ``gauss_ids``, ``counts`` and ``max_count`` are
bit-identical to the JAX package's: the keys are computed with the same
float operations, and ``torch.sort(stable=True)`` orders ties as the
stable ``jax.lax.sort`` does. The binning is integer data; callers pass
detached splats.

Counters (``utils/observability.py``, while counting is on), once per
binning of a view: ``bin.candidates`` the entries sorted (N x
``tiles_per_gauss``), ``bin.valid`` the pre-clamp entries, ``bin.kept``
those under ``max_per_tile`` and ``bin.tiles_cut`` the tiles above it.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from mobgs_tpu_torch.ops.projection import ProjectedSplats
from mobgs_tpu_torch.utils import observability as obs

TILE = 16
INT32_MAX = 2**31 - 1


class TileBins(NamedTuple):
    gauss_ids: torch.Tensor   # [T, max_per_tile] int32 Gaussian indices (depth order)
    counts: torch.Tensor      # [T] int32 live entries per tile
    n_tiles_x: int
    n_tiles_y: int
    # pre-clamp peak tile occupancy (scalar int32): above max_per_tile the
    # farthest entries of the hottest tile were dropped
    max_count: torch.Tensor | int = 0


def bin_gaussians(splats: ProjectedSplats, width: int, height: int,
                  tiles_per_gauss: int = 36, max_per_tile: int = 1024) -> TileBins:
    keys_sorted, gidx_sorted, starts, counts, ntx, nty = _expand_sort(
        splats, width, height, tiles_per_gauss)
    ids = _tile_slices(gidx_sorted, starts, ntx * nty, max_per_tile)
    max_count = torch.max(counts)
    kept = torch.clamp(counts, max=max_per_tile)
    if obs.COUNTING:
        obs.count("bin.candidates",
                  host_int=splats.means2d.shape[0] * tiles_per_gauss)
        _count_kept(counts, kept, max_per_tile)
    return TileBins(gauss_ids=ids, counts=kept,
                    n_tiles_x=ntx, n_tiles_y=nty, max_count=max_count)


def bin_views(splats: ProjectedSplats, width: int, height: int,
              tiles_per_gauss: int = 36, max_per_tile: int = 1024) -> TileBins:
    """Bin V views of one size, each on its own as :func:`bin_gaussians`
    bins it (its own sort and cut, its own counters), for one composite over
    all of them: ``splats`` carry a leading view axis [V, N, ...]; the result
    holds the views' tiles in turn ([V·T, K] ids, [V·T] counts), view v's ids
    offset by v·N into the flattened records, and the peak occupancy over
    the views. One view is :func:`bin_gaussians`' result as it stands."""
    V, N = splats.means2d.shape[:2]
    per = [bin_gaussians(ProjectedSplats(*(x[v] for x in splats)), width, height,
                         tiles_per_gauss, max_per_tile) for v in range(V)]
    if V == 1:
        return per[0]
    ids = torch.stack([b.gauss_ids for b in per])
    offset = torch.arange(V, dtype=ids.dtype, device=ids.device) * N
    return TileBins(gauss_ids=(ids + offset[:, None, None]).reshape(-1, ids.shape[-1]),
                    counts=torch.cat([b.counts for b in per]),
                    n_tiles_x=per[0].n_tiles_x, n_tiles_y=per[0].n_tiles_y,
                    max_count=torch.stack([b.max_count for b in per]).amax())


def _count_kept(counts_raw, counts, max_per_tile: int):
    """The binning's counters of valid entries (pre-clamp), of entries kept
    under ``max_per_tile`` and of tiles that cut some."""
    obs.count("bin.valid", device_tensor=counts_raw)
    obs.count("bin.kept", device_tensor=counts)
    obs.count("bin.tiles_cut", device_tensor=counts_raw, above=max_per_tile)


def _tile_index(v: torch.Tensor, n: int) -> torch.Tensor:
    """Float → int32 tile index clipped to [0, n-1]. The float clamp to
    [-1, n] before the cast changes no in-range value and makes huge or
    off-screen values saturate as XLA's float→int conversion does."""
    return torch.clamp(torch.clamp(v, -1.0, float(n)).to(torch.int32),
                       0, n - 1)


def _expand_sort(splats: ProjectedSplats, width: int, height: int,
                 tiles_per_gauss: int):
    """Expand every splat to its bbox-budget (tile, gaussian) entries and
    run the fused key-value sort; returns the sorted entry arrays plus
    per-tile segment starts and PRE-clamp counts."""
    n_tiles_x = -(-width // TILE)
    n_tiles_y = -(-height // TILE)
    n_tiles = n_tiles_x * n_tiles_y
    N = splats.means2d.shape[0]
    dev = splats.means2d.device
    i32 = torch.int32

    live = splats.radii > 0
    r = splats.radii.to(torch.float32)
    x, y = splats.means2d[:, 0], splats.means2d[:, 1]

    tx0 = _tile_index(torch.floor((x - r) / TILE), n_tiles_x)
    ty0 = _tile_index(torch.floor((y - r) / TILE), n_tiles_y)
    tx1 = _tile_index(torch.floor((x + r) / TILE), n_tiles_x)
    ty1 = _tile_index(torch.floor((y + r) / TILE), n_tiles_y)
    bw = tx1 - tx0 + 1
    bh = ty1 - ty0 + 1
    # Radius clamp so the bbox fits the expansion budget: shrink the box
    # symmetrically around the centre tile.
    side_cap = int(tiles_per_gauss ** 0.5)
    over = bw * bh > tiles_per_gauss
    bw_c = torch.where(over, torch.clamp(bw, max=side_cap), bw)
    bh_c = torch.where(over, torch.clamp(bh, max=side_cap), bh)
    ctx = _tile_index(x / TILE, n_tiles_x)   # truncation, as astype(int32)
    cty = _tile_index(y / TILE, n_tiles_y)
    tx0 = torch.where(over, torch.clamp(ctx - (bw_c - 1) // 2, 0,
                                        n_tiles_x - 1), tx0)
    ty0 = torch.where(over, torch.clamp(cty - (bh_c - 1) // 2, 0,
                                        n_tiles_y - 1), ty0)
    bw, bh = bw_c, bh_c

    # front-to-back depth key from the positive-float bit pattern
    tile_bits = max(1, n_tiles.bit_length())
    depth_bits = 31 - tile_bits
    dpos = torch.maximum(splats.depths.to(torch.float32),
                         torch.tensor(1e-12, dtype=torch.float32, device=dev))
    dkey = (dpos.view(i32) >> (31 - depth_bits)) & ((1 << depth_bits) - 1)

    # expand: entry e = (gaussian g, offset o)
    o = torch.arange(tiles_per_gauss, dtype=i32, device=dev)[None, :]  # [1, E]
    dx = o % bw[:, None]
    dy = o // bw[:, None]
    tile_id = (ty0[:, None] + dy) * n_tiles_x + (tx0[:, None] + dx)  # [N, E]
    entry_valid = (o < (bw * bh)[:, None]) & live[:, None]
    keys = torch.where(entry_valid, (tile_id << depth_bits) | dkey[:, None],
                       torch.full_like(tile_id, INT32_MAX)).reshape(-1)
    gidx = torch.arange(N, dtype=i32, device=dev)[:, None].expand(
        N, tiles_per_gauss).reshape(-1)

    keys_sorted, perm = torch.sort(keys, stable=True)
    gidx_sorted = gidx[perm]

    tile_keys = torch.arange(n_tiles + 1, dtype=i32, device=dev) << depth_bits
    bounds = torch.searchsorted(keys_sorted, tile_keys, right=False,
                                out_int32=True)
    starts = bounds[:-1]
    counts = (bounds[1:] - starts).to(i32)
    return keys_sorted, gidx_sorted, starts, counts, n_tiles_x, n_tiles_y


def suggest_tiles_per_gauss(radii, quantile: float = 0.995,
                            budgets=(9, 16, 25, 36, 64)) -> int:
    """Smallest bbox expansion budget covering the ``quantile`` live-splat
    tile span (host-side). A splat with pixel radius r spans at most
    ``ceil(2r/TILE) + 1`` tiles per axis."""
    if isinstance(radii, torch.Tensor):
        radii = radii.detach().cpu().numpy()
    r = np.asarray(radii)
    r = r[r > 0]
    if r.size == 0:
        return int(budgets[0])
    span = np.ceil(2.0 * np.quantile(r, quantile) / TILE) + 1
    need = int(span * span)
    for b in budgets:
        if b >= need:
            return int(b)
    return int(budgets[-1])


def _tile_slices(gidx_sorted: torch.Tensor, starts: torch.Tensor,
                 n_tiles: int, K: int) -> torch.Tensor:
    """Each tile's K front-most entries of the sorted entry array, one
    gather over the windows [start, start+K). Entries past a tile's own
    segment are garbage that ``counts`` masks downstream."""
    M = gidx_sorted.shape[0]
    k = torch.arange(K, dtype=torch.int64, device=starts.device)[None, :]
    idx = torch.clamp(starts.to(torch.int64)[:, None] + k, max=M - 1)
    return gidx_sorted[idx]
