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

``bin_static`` and ``merge_dyn_bins`` are the camera-shared static binning:
the static pool binned once per view, the dynamic records merged into it
per pass, with the result of ``bin_gaussians`` over the concatenation.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from mobgs_tpu_torch.ops.projection import ProjectedSplats

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
    counts = torch.clamp(counts, max=max_per_tile)
    return TileBins(gauss_ids=ids, counts=counts,
                    n_tiles_x=ntx, n_tiles_y=nty, max_count=max_count)


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


class StaticBins(NamedTuple):
    """Reusable per-camera binning of a time-invariant Gaussian subset.

    The train step renders the mid pass and the E-1 exposure-flow passes of
    a view from the same camera, and only the dynamic pool moves with the
    exposure shift: the static pool's projection, expansion, sort and
    per-tile lists are the same in all of them. Binning the static set once
    per view and merging the dynamic records per pass skips the static
    share of each pass's expand-sort; it pays only when the dynamic pool is
    a small fraction of the static one, so ``train/step.py`` keeps it off
    by default, as the JAX package does.
    """
    ids: torch.Tensor         # [T, K] int32 indices into the static set
    keys: torch.Tensor        # [T, K] fused sort keys (INT32_MAX pad)
    counts_raw: torch.Tensor  # [T] int32 PRE-clamp entries per tile
    n_tiles_x: int
    n_tiles_y: int


def _key_panel(keys_sorted, starts, counts, n_tiles: int, K: int):
    """Each tile's K front-most sort keys, INT32_MAX past its own count, so
    that the padding sorts behind every real record in a merge."""
    keys = _tile_slices(keys_sorted, starts, n_tiles, K)
    slot = torch.arange(K, dtype=torch.int32, device=keys.device)[None, :]
    return torch.where(slot < counts[:, None], keys,
                       torch.full_like(keys, INT32_MAX))


def bin_static(splats: ProjectedSplats, width: int, height: int,
               tiles_per_gauss: int = 36,
               max_per_tile: int = 1024) -> StaticBins:
    """Bin a time-invariant subset once (``tiles.py:164-179``), keeping the
    sorted key panel that ``merge_dyn_bins`` merges dynamic records into."""
    keys_sorted, gidx_sorted, starts, counts, ntx, nty = _expand_sort(
        splats, width, height, tiles_per_gauss)
    ids = _tile_slices(gidx_sorted, starts, ntx * nty, max_per_tile)
    keys = _key_panel(keys_sorted, starts, counts, ntx * nty, max_per_tile)
    return StaticBins(ids=ids, keys=keys, counts_raw=counts,
                      n_tiles_x=ntx, n_tiles_y=nty)


def merge_dyn_bins(static: StaticBins, dyn_splats: ProjectedSplats,
                   id_offset: int, width: int, height: int,
                   tiles_per_gauss: int = 36,
                   max_per_tile: int = 1024) -> TileBins:
    """Merge a dynamic set's records into a precomputed static binning
    (``tiles.py:182-215``): the same ``TileBins`` as ``bin_gaussians`` over
    the concatenated set with the dynamic indices offset by ``id_offset``
    (ids within each tile's count, counts and ``max_count``).

    Each stream is depth-sorted and truncated to its front-most K on its
    own, so the K front-most of the two-stream merge are the K front-most
    of the combined sort. Ties keep the combined sort's order (static
    before dynamic, index order within each): the static panel comes first
    and the row sort is stable.
    """
    T, K = static.ids.shape
    keys_sorted, gidx_sorted, starts, counts_d, _, _ = _expand_sort(
        dyn_splats, width, height, tiles_per_gauss)
    ids_d = _tile_slices(gidx_sorted, starts, T, max_per_tile) + id_offset
    keys_d = _key_panel(keys_sorted, starts, counts_d, T, max_per_tile)

    # a stable row sort of the [T, 2K] key panel, then the front-most K
    keys_cat = torch.cat([static.keys, keys_d], dim=1)
    ids_cat = torch.cat([static.ids, ids_d], dim=1)
    _, order = torch.sort(keys_cat, dim=1, stable=True)
    merged = torch.gather(ids_cat, 1, order[:, :K])

    counts_raw = static.counts_raw + counts_d  # the same entry set
    return TileBins(gauss_ids=merged,
                    counts=torch.clamp(counts_raw, max=K),
                    n_tiles_x=static.n_tiles_x, n_tiles_y=static.n_tiles_y,
                    max_count=torch.max(counts_raw))


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
