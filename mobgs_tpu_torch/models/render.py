"""Scene rendering — spline-deformed dynamic + static Gaussian composition
(port of ``mobgs_tpu/models/render.py``).

Each (camera, time) evaluation is one projection and one binning, with
subset passes (dynamic-only, static-only) as opacity masks over the same
tiles; optical flow is a 2D displacement composited as extra colour
columns. With ``shared=`` (``make_shared_view``) the static pool's
projection and binning are made once per camera and reused by every pass
at that camera, only the dynamic rows projected and merged per pass.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from mobgs_tpu_torch.data.cameras import Camera, cam_rays, pixel_grid
from mobgs_tpu_torch.models import gaussians as G
from mobgs_tpu_torch.models.sandwich import SandwichParams, apply_sandwich
from mobgs_tpu_torch.ops import projection
from mobgs_tpu_torch.ops.rasterize import (RasterConfig, RasterOut,
                                           make_shared_static, rasterize)


class SceneGeom(NamedTuple):
    """Assembled per-Gaussian fields for one (time) evaluation, static set
    first then dynamic (reference renderer :181-185)."""
    means: torch.Tensor      # [N, 3]
    quats: torch.Tensor      # [N, 4] (normalized)
    scales: torch.Tensor     # [N, 3] (activated)
    opacity: torch.Tensor    # [N]
    colors: torch.Tensor     # [N, 9]
    stat_mask: torch.Tensor  # [N] 1.0 on static slots
    dyn_mask: torch.Tensor   # [N] 1.0 on dynamic slots


def assemble(stat: G.GaussianState, dyn: G.GaussianState, t,
             max_time: float = 1.0, delta_exposure=None) -> SceneGeom:
    """Gather the combined Gaussian set at (possibly exposure-shifted) time
    (renderer :69-130): dynamic positions from the spline at
    ``clip(t + Δe/max_time, 0, 1)``, rotations ``q + Δt·ω``, features
    ``[dc ‖ Δt·f_t]`` with Δt = t_eff - trbf_center; static uses raw
    params with zero time modulation."""
    d_means, d_quats, d_scales, d_opac, d_colors = assemble_dyn(
        dyn, t, max_time, delta_exposure)
    s_means, s_quats, s_scales, s_opac, s_colors = assemble_static(stat)

    Ms, Md = stat.capacity, dyn.capacity
    kw = dict(dtype=torch.float32, device=s_means.device)
    return SceneGeom(
        means=torch.cat([s_means, d_means]),
        quats=torch.cat([s_quats, d_quats]),
        scales=torch.cat([s_scales, d_scales]),
        opacity=torch.cat([s_opac, d_opac]),
        colors=torch.cat([s_colors, d_colors]),
        stat_mask=torch.cat([torch.ones(Ms, **kw), torch.zeros(Md, **kw)]),
        dyn_mask=torch.cat([torch.zeros(Ms, **kw), torch.ones(Md, **kw)]),
    )


def assemble_dyn(dyn: G.GaussianState, t, max_time: float = 1.0,
                 delta_exposure=None):
    """Dynamic half of :func:`assemble` — the only part that changes with
    the exposure shift (renderer :69-130)."""
    dev = dyn.xyz.device
    t = torch.as_tensor(t, dtype=torch.float32, device=dev)
    if delta_exposure is None:
        t_eff = t
    else:
        t_eff = t + torch.as_tensor(delta_exposure, dtype=torch.float32,
                                    device=dev) / max_time
    t_spline = torch.clamp(t_eff, 0.0, 1.0)

    dt = G.time_offset(dyn, t_eff)  # [Md, 1]
    d_means = G.positions_at(dyn, t_spline)
    d_quats = G.rotation_at(dyn, dt.detach())
    d_scales = G.act_scaling(dyn)
    d_opac = G.act_opacity(dyn)
    d_colors = G.features_at(dyn, dt.detach())
    return d_means, d_quats, d_scales, d_opac, d_colors


def assemble_static(stat: G.GaussianState):
    """Static half of :func:`assemble` — time- and exposure-invariant."""
    s_means = stat.xyz
    s_quats = G.act_rotation(stat.rotation)
    s_scales = G.act_scaling(stat)
    s_opac = G.act_opacity(stat)
    s_colors = G.features_at(stat, 0.0)
    return s_means, s_quats, s_scales, s_opac, s_colors


def make_shared_view(stat: G.GaussianState, cam: Camera,
                     width: int, height: int,
                     config: RasterConfig = RasterConfig()):
    """Project and bin the static pool once for a camera
    (``ops/rasterize.make_shared_static``), reused by the mid render and the
    exposure-flow passes of the view, which differ only in the dynamic
    rows. The returned SharedStatic is differentiable through its
    projection."""
    s_means, s_quats, s_scales, _, _ = assemble_static(stat)
    return make_shared_static(s_means, s_quats, s_scales, cam.w2c, cam.K,
                              width, height, config)


def project_dyn2d(dyn: G.GaussianState, cam: Camera,
                  width: int, height: int, max_time: float = 1.0,
                  delta_exposure=None,
                  config: RasterConfig = RasterConfig()) -> torch.Tensor:
    """2D projections of the DYNAMIC rows only at a time (static rows of a
    flow-colour difference are exactly zero)."""
    d_means, d_quats, d_scales, _, _ = assemble_dyn(dyn, cam.time, max_time,
                                                    delta_exposure)
    splats = projection.project(d_means, d_quats, d_scales,
                                cam.w2c, cam.K, width, height,
                                eps2d=config.eps2d, near=config.near,
                                sigma_cut=config.sigma_cut)
    return splats.means2d


def _bg9(bg3: torch.Tensor) -> torch.Tensor:
    """9-channel background = bg3 tiled x3 (renderer :90-91)."""
    return torch.cat([bg3, bg3, bg3])


class RenderOut(NamedTuple):
    image: torch.Tensor       # [H, W, 3] decoded RGB (combined)
    depth: torch.Tensor       # [H, W] expected depth (combined)
    alpha: torch.Tensor       # [H, W] (combined)
    d_image: torch.Tensor | None
    d_depth: torch.Tensor | None
    d_alpha: torch.Tensor | None
    s_image: torch.Tensor | None
    s_alpha: torch.Tensor | None
    feat: torch.Tensor        # [H, W, 9] raw combined features (pre-decoder)
    means2d: torch.Tensor     # [N, 2]
    radii: torch.Tensor       # [N]
    flow: torch.Tensor | None  # [H, W, F] optional extra-channel renders
    tile_max: torch.Tensor | int = 0  # pre-clamp peak tile occupancy


def render_view(stat: G.GaussianState, dyn: G.GaussianState,
                sandwich: SandwichParams, cam: Camera,
                width: int, height: int, bg3: torch.Tensor,
                max_time: float = 1.0, delta_exposure=None,
                get_static: bool = False, get_dynamic: bool = False,
                extra_colors: torch.Tensor | None = None,
                means2d_offset: torch.Tensor | None = None,
                subset_alpha_only: bool = False,
                want_depth: bool = True,
                want_alpha: bool = True,
                precomputed: tuple | None = None,
                shared=None,
                config: RasterConfig = RasterConfig()) -> RenderOut:
    """Render one view at one time (reference `render()`,
    ``render.py:157-248``).

    Args:
      extra_colors: [N, F] additional per-Gaussian channels composited
        with zero background (e.g. 2D flow displacements).
      subset_alpha_only: the static/dynamic subset passes composite only
        alpha; the first of them rides the main pass as the kernel's
        fused second chain. d_image/d_depth/s_image stay None.
      want_depth, want_alpha: composite the extended depth / weight
        columns; when off, depth/alpha come back as zeros and the
        background term is skipped.
      precomputed: (SceneGeom, ProjectedSplats) from assemble_project.
      shared: SharedStatic from make_shared_view for this camera; only the
        dynamic rows are projected and merged here (exclusive with
        precomputed).
    """
    if precomputed is not None:
        geom, splats = precomputed
    else:
        geom = assemble(stat, dyn, cam.time, max_time, delta_exposure)
        splats = None
    colors = geom.colors
    bg = _bg9(bg3) if want_alpha else None
    if extra_colors is not None:
        colors = torch.cat([colors, extra_colors], dim=1)
        if bg is not None:
            bg = torch.cat([bg, torch.zeros(extra_colors.shape[1],
                                            dtype=bg.dtype, device=bg.device)])

    masks = [torch.ones_like(geom.stat_mask)]
    sub_masks = []
    sub_list = sub_masks if subset_alpha_only else masks
    if get_dynamic:
        sub_list.append(geom.dyn_mask)
    if get_static:
        sub_list.append(geom.stat_mask)
    out: RasterOut = rasterize(
        geom.means, geom.quats, geom.scales, geom.opacity, colors,
        cam.w2c, cam.K, width, height, background=bg,
        pass_masks=torch.stack(masks),
        alpha_masks=torch.stack(sub_masks) if sub_masks else None,
        means2d_offset=means2d_offset,
        want_depth=want_depth, want_alpha=want_alpha,
        splats=splats, shared=shared, config=config)

    rays = cam_rays(cam, width, height)
    image = apply_sandwich(sandwich, out.images[0, ..., :9], rays)
    i = 1
    j = 0
    d_image = d_depth = d_alpha = s_image = s_alpha = None
    if get_dynamic:
        if subset_alpha_only:
            d_alpha = out.sub_alphas[j]
            j += 1
        else:
            d_image = apply_sandwich(sandwich, out.images[i, ..., :9], rays)
            d_depth = out.depths[i]
            d_alpha = out.alphas[i]
            i += 1
    if get_static:
        if subset_alpha_only:
            s_alpha = out.sub_alphas[j]
            j += 1
        else:
            s_image = apply_sandwich(sandwich, out.images[i, ..., :9], rays)
            s_alpha = out.alphas[i]
            i += 1
    flow = out.images[0, ..., 9:] if extra_colors is not None else None
    return RenderOut(image=image, depth=out.depths[0], alpha=out.alphas[0],
                     d_image=d_image, d_depth=d_depth, d_alpha=d_alpha,
                     s_image=s_image, s_alpha=s_alpha,
                     feat=out.images[0, ..., :9],
                     means2d=out.means2d, radii=out.radii, flow=flow,
                     tile_max=out.tile_max)


def assemble_project(stat: G.GaussianState, dyn: G.GaussianState,
                     cam: Camera, width: int, height: int,
                     max_time: float = 1.0, delta_exposure=None,
                     config: RasterConfig = RasterConfig()):
    """Assemble the combined set at (exposure-shifted) time and project it;
    returns (SceneGeom, ProjectedSplats) for ``render_view(precomputed=)``."""
    geom = assemble(stat, dyn, cam.time, max_time, delta_exposure)
    splats = projection.project(geom.means, geom.quats, geom.scales,
                                cam.w2c, cam.K, width, height,
                                eps2d=config.eps2d, near=config.near,
                                sigma_cut=config.sigma_cut)
    return geom, splats


def project_combined(stat: G.GaussianState, dyn: G.GaussianState,
                     cam: Camera, width: int, height: int,
                     max_time: float = 1.0, delta_exposure=None,
                     config: RasterConfig = RasterConfig()) -> torch.Tensor:
    """2D projections of the combined set at a time (flow colours)."""
    _, splats = assemble_project(stat, dyn, cam, width, height, max_time,
                                 delta_exposure, config)
    return splats.means2d


def get_flow(stat: G.GaussianState, dyn: G.GaussianState,
             sandwich: SandwichParams, cam: Camera,
             width: int, height: int, bg3: torch.Tensor,
             delta_exposure, max_time: float = 1.0,
             config: RasterConfig = RasterConfig()):
    """Exposure↔mid flow maps and the latent image and alpha
    (``render.py:280-310``): an exposure-time pass with channels
    [feat9 ‖ exp2mid flow] and the dynamic pass, and a mid-time pass with
    [feat9 ‖ mid2exp flow].

    Returns (exp2mid_coord [H,W,2], mid2exp_coord [H,W,2],
             latent_img [H,W,3], latent_alpha [H,W]).
    """
    mid2d = project_combined(stat, dyn, cam, width, height, max_time, None,
                             config)
    exp2d = project_combined(stat, dyn, cam, width, height, max_time,
                             delta_exposure, config)
    flow2d = (mid2d - exp2d).detach()  # exp→mid displacement

    exp_out = render_view(stat, dyn, sandwich, cam, width, height, bg3,
                          max_time, delta_exposure, get_dynamic=True,
                          extra_colors=flow2d, config=config)
    mid_out = render_view(stat, dyn, sandwich, cam, width, height, bg3,
                          max_time, None, extra_colors=-flow2d, config=config)

    pix = pixel_grid(width, height, use_center=False, device=flow2d.device)
    exp2mid_coord = pix + exp_out.flow
    mid2exp_coord = pix + mid_out.flow
    return exp2mid_coord, mid2exp_coord, exp_out.image, exp_out.d_alpha


def get_flow_static(stat: G.GaussianState, source_cam: Camera,
                    target_cam: Camera, splat_cam: Camera,
                    width: int, height: int,
                    config: RasterConfig = RasterConfig()):
    """Camera-induced flow from the static Gaussians (``render.py:313-336``):
    project the static set in the source and target views and composite the
    2D displacement from the splat camera, with no background and the depth
    and weight columns on (CE = 2 + 2). Returns (flow2d [N,2],
    rendered_flow [H,W,2])."""
    s_means = stat.xyz
    s_quats = G.act_rotation(stat.rotation)
    s_scales = G.act_scaling(stat)
    s_opac = G.act_opacity(stat)

    def proj2d(cam):
        spl = projection.project(s_means, s_quats, s_scales, cam.w2c, cam.K,
                                 width, height, eps2d=config.eps2d,
                                 near=config.near, sigma_cut=config.sigma_cut)
        return spl.means2d

    flow2d = proj2d(source_cam) - proj2d(target_cam)
    out = rasterize(s_means, s_quats, s_scales, s_opac, flow2d,
                    splat_cam.w2c, splat_cam.K, width, height,
                    background=None, config=config)
    return flow2d, out.images[0]
