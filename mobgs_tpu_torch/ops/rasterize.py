"""Public rasterization API (port of ``mobgs_tpu/ops/rasterize.py``): the
render layer's one pipeline, and the one op of it that reads the mesh.

One call projects and bins the Gaussian set once and composites any
number of subset passes over the shared geometry: excluding a Gaussian
from a pass is rendering it with zero opacity. Every output pass carries
(image[C], alpha, expected depth). Several views of one size render in
one call over a leading view axis: one projection over the views, each
view binned on its own (``ops/tiles.py::bin_views``) and one composite
launch a pass over all their tiles.

The composite is ``ops/cuda_raster.py``: the hand-written kernel for CUDA
tensors, its plain version for CPU tensors. The first alpha-only mask is
fused into the main pass as the kernel's second transmittance chain
(``rasterize.py:190-204``); further alpha-only passes composite only the
depth and weight columns (CE=2).
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch

from mobgs_tpu_torch.ops import cuda_raster, projection, tiles
from mobgs_tpu_torch.parallel import mesh as Mx


class RasterConfig(NamedTuple):
    tiles_per_gauss: int = 36
    max_per_tile: int = 1024
    tile_chunk: int = 36   # memory knob of the JAX package's XLA compositor; unused
    eps2d: float = 0.3
    near: float = 0.01
    sigma_cut: float = 3.0
    backend: str = "auto"  # "auto" | "cuda" | "plain"


class RasterOut(NamedTuple):
    """A call's outputs; every tensor but ``tile_max`` has a leading view
    axis [V, ...] where the call rendered V views."""
    images: torch.Tensor     # [P, H, W, C] per-pass feature images
    alphas: torch.Tensor     # [P, H, W]
    depths: torch.Tensor     # [P, H, W] expected depth
    means2d: torch.Tensor    # [N, 2] pixel-space projected centres
    radii: torch.Tensor      # [N] int32 (0 = culled)
    sub_alphas: torch.Tensor | None = None  # [P2, H, W] alpha-only passes
    tile_max: torch.Tensor | int = 0  # pre-clamp peak tile occupancy


def _stack(xs, dim: int) -> torch.Tensor:
    """``torch.stack``; one tensor as a view, which launches no copy."""
    return xs[0].unsqueeze(dim) if len(xs) == 1 else torch.stack(xs, dim)


def rasterize(means: torch.Tensor, quats: torch.Tensor, scales: torch.Tensor,
              opacities: torch.Tensor, colors: torch.Tensor,
              viewmat: torch.Tensor, K: torch.Tensor,
              width: int, height: int,
              background: torch.Tensor | None = None,
              pass_masks: torch.Tensor | None = None,
              alpha_masks: torch.Tensor | None = None,
              means2d_offset: torch.Tensor | None = None,
              flow_to: torch.Tensor | None = None,
              want_depth: bool = True,
              want_alpha: bool = True,
              config: RasterConfig = RasterConfig(),
              segments: tuple[int, ...] | None = None) -> RasterOut:
    """Render one camera view, or V views, with one or more subset passes.

    Args:
      means: [N, 3]; quats: [N, 4]; scales: [N, 3] (activated);
      opacities: [N] (activated); colors: [N, C].
      viewmat: [4, 4] world→camera; K: [3, 3].
      background: [C'] blended as bg*(1-alpha) over the composited columns
        (C, and the two flow columns of ``flow_to``), or None.
      pass_masks: [P, N] multiplicative opacity masks per pass
        (None → single pass over all Gaussians).
      alpha_masks: [P2, N] masks for alpha-only subset passes.
      means2d_offset: [N, 2] zeros whose gradient is the view-space
        positional gradient (densification statistics).
      flow_to: [N, 2] screen positions: composite each Gaussian's
        ``(flow_to − means2d).detach()``, from this call's own projection,
        as two more colour columns (the train step's exp→mid flow).
      want_depth, want_alpha: composite the extended depth / weight
        columns; when off, depths / alphas come back as zeros.
      segments: on gauss-sharded rows (``parallel/mesh.py::gauss_sharded``),
        the local row counts of the pools the per-Gaussian arguments
        concatenate (static, dynamic); one pool by default.

    Views: ``viewmat`` [V, 4, 4] with ``means``, ``quats``, ``scales``,
    ``opacities``, ``colors`` (and ``means2d_offset``, ``flow_to``) [V, N,
    ...] renders V views of one size (``projection.project`` over the
    leading axis); the masks apply to every view, and every output but
    ``tile_max`` gains a leading view axis ([V, P, H, W, C], [V, N, 2],
    ...). Each view's outputs are those of its own call to the bit.

    On gauss-sharded rows the per-Gaussian arguments are this rank's rows:
    they are projected here, with the camera's gradient summed over the
    ``gauss`` ranks, then the records, colours, opacities and masks of all
    the views are all-gathered over ``gauss`` into the unsharded order
    (each pool whole in turn) in one collective before binning (the JAX
    README's step 2). With tile sharding on
    (``parallel/mesh.py::enable_tile_sharding``) and the launch's V·T tile
    rows divisible by the gauss axis, each gauss rank composites its
    contiguous V·T / S rows and the ranges are all-gathered before the
    epilogue. ``means2d`` and ``radii`` of the result are this rank's rows.

    Returns:
      RasterOut with a leading pass axis (after the view axis).
    """
    views = tuple(viewmat.shape[:-2])
    gauss = Mx.gauss_shard_info()
    splats = projection.project(means, quats, scales, Mx.replicated_into_rows(viewmat), K,
                                width, height, eps2d=config.eps2d, near=config.near,
                                sigma_cut=config.sigma_cut)
    if means2d_offset is not None:
        splats = splats._replace(means2d=splats.means2d + means2d_offset)
    if flow_to is not None:
        colors = torch.cat([colors, (flow_to - splats.means2d).detach()], dim=-1)
    if not views:  # one camera: a view axis of one from here on
        splats = projection.ProjectedSplats(*(x[None] for x in splats))
        opacities, colors = opacities[None], colors[None]
    local = splats
    V = splats.means2d.shape[0]
    n_rows = V * -(-width // tiles.TILE) * -(-height // tiles.TILE)
    shard = Mx.tile_shard_info(n_rows) if gauss is not None else None
    if gauss is not None:
        splats, opacities, colors, pass_masks, alpha_masks = _gather_rows(
            splats, opacities, colors, pass_masks, alpha_masks, segments,
            partial_grads=shard is not None)
    bins = tiles.bin_views(projection.ProjectedSplats(*(x.detach() for x in splats)),
                           width, height, tiles_per_gauss=config.tiles_per_gauss,
                           max_per_tile=config.max_per_tile)
    tile0, gather = 0, None
    if shard is not None:
        # this rank's contiguous range of the launch's rows
        # (pallas_raster.py:631-656); the per-splat gradients of a range
        # are partial, summed over gauss by the backward of the row gather
        mesh, axis, S = shard
        m = n_rows // S
        tile0 = mesh.get_local_rank(axis) * m
        bins = bins._replace(gauss_ids=bins.gauss_ids[tile0:tile0 + m],
                             counts=bins.counts[tile0:tile0 + m])
        gather = functools.partial(Mx.gather_tile_axis, dim=0)

    def composite(cols, opac, sub_opac=None, bg=None, depth=True, alpha=True):
        return cuda_raster.composite_tiles(
            bins, splats, cols, opac, width, height, background=bg,
            sub_opacities=sub_opac, want_depth=depth, want_alpha=alpha,
            backend=config.backend, tile0=tile0, gather=gather)

    # The FIRST alpha-only subset mask fuses into the main pass (second
    # transmittance chain); passes are a short static loop.
    n_alpha = 0 if alpha_masks is None else alpha_masks.shape[0]
    sub_list = []
    outs = []
    for i, mask in enumerate([None] if pass_masks is None else pass_masks):
        sub = opacities * alpha_masks[0] if (i == 0 and n_alpha) else None
        o = composite(colors, opacities if mask is None else opacities * mask, sub,
                      background, want_depth, want_alpha)
        if sub is not None:
            sub_list.append(o[3])
        outs.append(o[:3])
    sub_list += [composite(colors[..., :0], opacities * alpha_masks[i])[1]
                 for i in range(1, n_alpha)]
    out = RasterOut(images=_stack([o[0] for o in outs], 1),
                    alphas=_stack([o[1] for o in outs], 1),
                    depths=_stack([o[2] for o in outs], 1),
                    means2d=local.means2d, radii=local.radii,
                    sub_alphas=_stack(sub_list, 1) if n_alpha else None,
                    tile_max=bins.max_count)
    if not views:
        out = out._replace(**{k: v[0] for k, v in out._asdict().items()
                              if k != "tile_max" and v is not None})
    return out


def _gather_rows(splats, opacities, colors, pass_masks, alpha_masks, segments,
                 partial_grads):
    """The per-splat tensors of this rank's rows of the V views ([V, N,
    ...]) all-gathered over ``gauss`` as one [N, ·] table, each view's
    columns side by side, in one collective
    (``parallel/mesh.py::gather_gauss_rows``; with ``partial_grads``, a
    tile-sharded compositor's, its backward sums the ranks' partial
    gradients). The radii ride as float32, exact below 2^24."""
    V, N = splats.means2d.shape[:2]

    def rows(x):  # [V, N, c] -> [N, V·c]
        return x.to(torch.float32).transpose(0, 1).reshape(N, -1)

    cols = [rows(splats.means2d), rows(splats.conics), rows(splats.depths[..., None]),
            rows(splats.radii[..., None]), rows(opacities[..., None]), rows(colors)]
    masks = [m for m in (pass_masks, alpha_masks) if m is not None]
    cols += [m.T.to(torch.float32) for m in masks]
    widths = [c.shape[1] for c in cols]
    parts = list(torch.split(Mx.gather_gauss_rows(torch.cat(cols, 1), segments,
                                                  partial_grads), widths, dim=1))

    def views(p):  # [N', V·c] -> [V, N', c]
        return p.reshape(p.shape[0], V, -1).transpose(0, 1)

    whole = projection.ProjectedSplats(
        means2d=views(parts[0]), conics=views(parts[1]), depths=views(parts[2])[..., 0],
        radii=views(parts[3])[..., 0].detach().to(torch.int32))
    gathered = [p.T for p in parts[6:]]
    return (whole, views(parts[4])[..., 0], views(parts[5]),
            gathered.pop(0) if pass_masks is not None else None,
            gathered.pop(0) if alpha_masks is not None else None)


def validate_max_per_tile(means, quats, scales, opacities, colors,
                          viewmat, K, width: int, height: int,
                          config: RasterConfig,
                          budgets=(256, 384, 512, 1024, 1536, 2048),
                          min_psnr_db: float = 60.0,
                          observed_peak: int = 0) -> int:
    """Measured validation of the per-tile capacity
    (``rasterize.py:228-272``): composite one view at the configured cap
    and at the highest budget and escalate until they agree to
    ``min_psnr_db``. Returns the validated ``max_per_tile``."""
    hi = budgets[-1]
    if observed_peak > hi:
        hi = -(-observed_peak // 128) * 128
        budgets = tuple(budgets) + (hi,)
    ref = rasterize(means, quats, scales, opacities, colors, viewmat, K,
                    width, height, config=config._replace(max_per_tile=hi))
    for b in budgets:
        if b < config.max_per_tile:
            continue
        if b == hi:
            return hi
        out = rasterize(means, quats, scales, opacities, colors, viewmat,
                        K, width, height,
                        config=config._replace(max_per_tile=b))
        mse = float(torch.mean((out.images[0] - ref.images[0]) ** 2))
        if 10.0 * math.log10(1.0 / max(mse, 1e-12)) >= min_psnr_db:
            return b
    return hi


def project_means2d(means: torch.Tensor, quats: torch.Tensor,
                    scales: torch.Tensor, viewmat: torch.Tensor,
                    K: torch.Tensor, width: int, height: int,
                    config: RasterConfig = RasterConfig()) -> torch.Tensor:
    """2D projections only (gsplat `fully_fused_projection` as used for
    optical-flow painting, reference renderer :187-199)."""
    splats = projection.project(means, quats, scales, viewmat, K,
                                width, height, eps2d=config.eps2d,
                                near=config.near, sigma_cut=config.sigma_cut)
    return splats.means2d
