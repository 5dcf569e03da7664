"""Public rasterization API (port of ``mobgs_tpu/ops/rasterize.py``).

One call projects and bins the Gaussian set once and composites any
number of subset passes over the shared geometry: excluding a Gaussian
from a pass is rendering it with zero opacity. Every output pass carries
(image[C], alpha, expected depth).

The composite is ``ops/cuda_raster.py``: the hand-written kernel for CUDA
tensors, its plain version for CPU tensors. The first alpha-only mask is
fused into the main pass as the kernel's second transmittance chain
(``rasterize.py:190-204``); further alpha-only passes composite only the
depth and weight columns (CE=2).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from mobgs_tpu_torch.ops import cuda_raster, projection, tiles


class RasterConfig(NamedTuple):
    tiles_per_gauss: int = 36
    max_per_tile: int = 1024
    tile_chunk: int = 36   # memory knob of the JAX package's XLA compositor; unused
    eps2d: float = 0.3
    near: float = 0.01
    sigma_cut: float = 3.0
    backend: str = "auto"  # "auto" | "cuda" | "plain"


class RasterOut(NamedTuple):
    images: torch.Tensor     # [P, H, W, C] per-pass feature images
    alphas: torch.Tensor     # [P, H, W]
    depths: torch.Tensor     # [P, H, W] expected depth
    means2d: torch.Tensor    # [N, 2] pixel-space projected centres
    radii: torch.Tensor      # [N] int32 (0 = culled)
    sub_alphas: torch.Tensor | None = None  # [P2, H, W] alpha-only passes
    tile_max: torch.Tensor | int = 0  # pre-clamp peak tile occupancy


class SharedStatic(NamedTuple):
    """Per-(camera, static subset) projection and binning, built once per
    view by :func:`make_shared_static` and passed as ``rasterize(...,
    shared=...)`` to every pass that renders the same camera with only the
    rows past the static prefix changing (the train step's mid render and
    exposure-flow passes: static Gaussians are never time-shifted)."""
    splats: projection.ProjectedSplats  # static rows, differentiable
    bins: tiles.StaticBins


def _detached(splats: projection.ProjectedSplats) -> projection.ProjectedSplats:
    return projection.ProjectedSplats(*(x.detach() for x in splats))


def make_shared_static(means, quats, scales, viewmat, K,
                       width: int, height: int,
                       config: RasterConfig = RasterConfig()) -> SharedStatic:
    """Project and bin the static prefix once for a camera
    (``rasterize.py:62-80``). The projection stays in the graph: every pass
    that reuses it adds its gradient to the same tensors, so a view runs one
    static projection backward instead of one a pass. The binning sees
    detached splats, as in the unshared path."""
    splats = projection.project(means, quats, scales, viewmat, K,
                                width, height, eps2d=config.eps2d,
                                near=config.near, sigma_cut=config.sigma_cut)
    bins = tiles.bin_static(_detached(splats), width, height,
                            tiles_per_gauss=config.tiles_per_gauss,
                            max_per_tile=config.max_per_tile)
    return SharedStatic(splats=splats, bins=bins)


def rasterize(means: torch.Tensor, quats: torch.Tensor, scales: torch.Tensor,
              opacities: torch.Tensor, colors: torch.Tensor,
              viewmat: torch.Tensor, K: torch.Tensor,
              width: int, height: int,
              background: torch.Tensor | None = None,
              pass_masks: torch.Tensor | None = None,
              alpha_masks: torch.Tensor | None = None,
              means2d_offset: torch.Tensor | None = None,
              want_depth: bool = True,
              want_alpha: bool = True,
              splats: projection.ProjectedSplats | None = None,
              shared: SharedStatic | None = None,
              config: RasterConfig = RasterConfig()) -> RasterOut:
    """Render one camera view with one or more subset passes.

    Args:
      means: [N, 3]; quats: [N, 4]; scales: [N, 3] (activated);
      opacities: [N] (activated); colors: [N, C].
      viewmat: [4, 4] world→camera; K: [3, 3].
      background: [C] blended as bg*(1-alpha), or None.
      pass_masks: [P, N] multiplicative opacity masks per pass
        (None → single pass over all Gaussians).
      alpha_masks: [P2, N] masks for alpha-only subset passes.
      means2d_offset: [N, 2] zeros whose gradient is the view-space
        positional gradient (densification statistics).
      want_depth, want_alpha: composite the extended depth / weight
        columns; when off, depths / alphas come back as zeros.
      splats: precomputed ProjectedSplats for (means..., viewmat, K).
      shared: SharedStatic from :func:`make_shared_static` for this camera:
        only the rows past its static prefix are projected and binned here
        (exclusive with ``splats``).

    Returns:
      RasterOut with a leading pass axis.
    """
    if shared is not None:
        # the camera-shared static path (rasterize.py:125-142): the dynamic
        # rows' projection after the shared static one, their records merged
        # into the static bins
        Ms = shared.splats.means2d.shape[0]
        dyn_splats = projection.project(
            means[Ms:], quats[Ms:], scales[Ms:], viewmat, K, width, height,
            eps2d=config.eps2d, near=config.near, sigma_cut=config.sigma_cut)
        splats = projection.ProjectedSplats(
            *(torch.cat([a, b]) for a, b in zip(shared.splats, dyn_splats)))
    elif splats is None:
        splats = projection.project(means, quats, scales, viewmat, K,
                                    width, height, eps2d=config.eps2d,
                                    near=config.near,
                                    sigma_cut=config.sigma_cut)
    if means2d_offset is not None:
        splats = splats._replace(means2d=splats.means2d + means2d_offset)
    if shared is not None:
        # the dynamic records without the offset: it is zeros (a gradient
        # tap), so the bins are those of the unshared path
        bins = tiles.merge_dyn_bins(shared.bins, _detached(dyn_splats), Ms,
                                    width, height,
                                    tiles_per_gauss=config.tiles_per_gauss,
                                    max_per_tile=config.max_per_tile)
    else:
        bins = tiles.bin_gaussians(_detached(splats), width, height,
                                   tiles_per_gauss=config.tiles_per_gauss,
                                   max_per_tile=config.max_per_tile)

    if pass_masks is None:
        pass_masks = torch.ones((1, means.shape[0]), dtype=means.dtype,
                                device=means.device)

    def composite(cols, opac, sub_opac=None, bg=None, depth=True, alpha=True):
        return cuda_raster.composite_tiles(
            bins, splats, cols, opac, width, height, background=bg,
            sub_opacities=sub_opac, want_depth=depth, want_alpha=alpha,
            backend=config.backend)

    # The FIRST alpha-only subset mask fuses into the main pass (second
    # transmittance chain); passes are a short static loop.
    n_alpha = 0 if alpha_masks is None else alpha_masks.shape[0]
    sub_list = []
    outs = []
    for i in range(pass_masks.shape[0]):
        sub = opacities * alpha_masks[0] if (i == 0 and n_alpha) else None
        o = composite(colors, opacities * pass_masks[i], sub, background,
                      want_depth, want_alpha)
        if sub is not None:
            sub_list.append(o[3])
        outs.append(o[:3])
    images = torch.stack([o[0] for o in outs])
    alphas = torch.stack([o[1] for o in outs])
    depths = torch.stack([o[2] for o in outs])

    sub_alphas = None
    if n_alpha:
        zero_colors = torch.zeros((means.shape[0], 0), dtype=colors.dtype,
                                  device=colors.device)
        sub_list += [composite(zero_colors, opacities * alpha_masks[i])[1]
                     for i in range(1, n_alpha)]
        sub_alphas = torch.stack(sub_list)
    return RasterOut(images=images, alphas=alphas, depths=depths,
                     means2d=splats.means2d, radii=splats.radii,
                     sub_alphas=sub_alphas, tile_max=bins.max_count)


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
