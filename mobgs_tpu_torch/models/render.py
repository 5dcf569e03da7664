"""Scene rendering — spline-deformed dynamic + static Gaussian composition
(port of ``mobgs_tpu/models/render.py``).

Each (camera, time) evaluation is one projection and one binning, with
subset passes (dynamic-only, static-only) as opacity masks over the same
tiles; optical flow is a 2D displacement composited as extra colour
columns. With ``shared=`` (``make_shared_view``) the static pool's
projection and binning are made once per camera and reused by every pass
at that camera, only the dynamic rows projected and merged per pass.

The train step's latent renders of a view, V cameras at one time with
V exposure shifts, run as one batched pass (``render_latents``): the
static half assembled once, the dynamic half at the V times in one
broadcast evaluation, the V cameras projected together, each binned on
its own, one composite launch over all their tiles and one decode; each
view's features equal its own ``render_view`` call's to the bit. Its
exposure-flow passes, V time shifts at the view's own camera, run the same
way (``render_flow_passes``), with their flow columns and dynamic alpha.

The entries the train step and the exposure update call (``render_view``,
``render_latents``, ``render_flow_passes``, ``get_flow_static``,
``make_shared_view``, ``project_dyn2d``, ``project_combined``,
``assemble_project``) run in the
span ``render`` (``utils/observability.py``); a nested call in its own, one
level down.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from mobgs_tpu_torch.data.cameras import Camera, cam_rays, pixel_grid
from mobgs_tpu_torch.models import gaussians as G
from mobgs_tpu_torch.models.sandwich import SandwichParams, apply_sandwich
from mobgs_tpu_torch.ops import cuda_raster, projection, tiles
from mobgs_tpu_torch.ops.rasterize import (RasterConfig, RasterOut,
                                           make_shared_static, rasterize)
from mobgs_tpu_torch.utils import observability as obs


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


@obs.spanned("render")
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


@obs.spanned("render")
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


@obs.spanned("render")
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
        splats=splats, shared=shared, config=config,
        segments=(stat.capacity, dyn.capacity))

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


def _assemble_views(stat: G.GaussianState, dyn: G.GaussianState, time,
                    max_time: float, delta_exposure: torch.Tensor | None, V: int):
    """:func:`assemble`'s fields over a leading axis of V views at one time,
    view v shifted by ``delta_exposure[v]`` ([V], or None for none): the
    static half assembled once, the dynamic half at the V times in one
    broadcast evaluation; each view's rows those of its own call, to the bit.
    Returns (means, quats, scales, opacity, colors), each [V, N, ...]."""
    if delta_exposure is None:
        dyn_rows = assemble_dyn(dyn, time, max_time)
    else:
        dyn_rows = assemble_dyn(dyn, time, max_time, delta_exposure.reshape(V, 1, 1))

    def per_view(s, d):  # [V, N, ...]: the static rows, then the view's dynamic
        d = d if d.ndim > s.ndim else d.expand((V,) + d.shape)
        return torch.cat([s.expand((V,) + s.shape), d], dim=1)

    return tuple(per_view(s, d) for s, d in zip(assemble_static(stat), dyn_rows))


class LatentOut(NamedTuple):
    images: torch.Tensor    # [V, H, W, 3] decoded RGB, one a camera
    feat: torch.Tensor      # [V, H, W, 9] raw features (pre-decoder)
    tile_max: torch.Tensor  # pre-clamp peak tile occupancy over the views


@obs.spanned("render")
def render_latents(stat: G.GaussianState, dyn: G.GaussianState,
                   sandwich: SandwichParams, w2c: torch.Tensor, K: torch.Tensor,
                   time, width: int, height: int, max_time: float = 1.0,
                   delta_exposure: torch.Tensor | None = None,
                   config: RasterConfig = RasterConfig()) -> LatentOut:
    """V image-only renders at one time in one pass: camera v at ``w2c[v]``
    and exposure shift ``delta_exposure[v]`` ([V], or None for none), with
    no background, depth or weight columns. Each view's features are those
    of ``render_view(..., Camera(w2c[v], K, time), ..., delta_exposure[v],
    want_depth=False, want_alpha=False)`` to the bit, from the same float
    operations: the static half assembled once and the dynamic half at the
    V times over a leading view axis; projection over it
    (``ops/projection.py``); each view binned on its own
    (``ops/tiles.py::bin_views``); one composite launch over the V views'
    tiles (``ops/cuda_raster.py``). One decode with each camera's rays
    follows; its [V·H·W, 12] @ [12, 6] product may take another cuBLAS
    kernel than one view's, and round some values in their last place (on
    the CPU it gives the calls' bits).

    Counters (while counting is on): ``render.latent_calls`` one a call,
    ``render.latent_views`` its V."""
    V = w2c.shape[0]
    if obs.COUNTING:
        obs.count("render.latent_calls", host_int=1)
        obs.count("render.latent_views", host_int=V)
    means, quats, scales, opac, colors = _assemble_views(stat, dyn, time, max_time,
                                                         delta_exposure, V)
    splats = projection.project(means, quats, scales, w2c, K, width, height,
                                eps2d=config.eps2d, near=config.near,
                                sigma_cut=config.sigma_cut)
    bins = tiles.bin_views(projection.ProjectedSplats(*(x.detach() for x in splats)),
                           width, height, tiles_per_gauss=config.tiles_per_gauss,
                           max_per_tile=config.max_per_tile)
    feat = cuda_raster.composite_tiles(bins, splats, colors, opac, width, height,
                                       want_depth=False, want_alpha=False,
                                       backend=config.backend)[0]
    rays = cam_rays(Camera(w2c=w2c, K=K, time=time), width, height)
    return LatentOut(images=apply_sandwich(sandwich, feat, rays), feat=feat,
                     tile_max=bins.max_count)


class FlowPassOut(NamedTuple):
    images: torch.Tensor    # [V, H, W, 3] decoded RGB, one a pass
    d_alphas: torch.Tensor  # [V, H, W] dynamic-subset alpha
    flows: torch.Tensor     # [V, H, W, 2] composited exp→mid flow columns
    means2d: torch.Tensor   # [V, N, 2] each pass's projected centres
    tile_max: torch.Tensor  # pre-clamp peak tile occupancy over the passes


@obs.spanned("render")
def render_flow_passes(stat: G.GaussianState, dyn: G.GaussianState,
                       sandwich: SandwichParams, cam: Camera, width: int, height: int,
                       mid2d: torch.Tensor, max_time: float, shifts: torch.Tensor,
                       config: RasterConfig = RasterConfig()) -> FlowPassOut:
    """The train step's V exposure-flow passes of a view in one pass: all
    at the view's camera ``cam``, pass v at the exposure-time shift
    ``shifts[v]`` ([V]), composited with its exp→mid flow ``(mid2d −
    means2d_v).detach()`` ([N, 2] colours, ``mid2d`` the mid-time
    projection) as two extra columns and the dynamic-alpha chain, with no
    background, depth or weight columns (CE = 9 + 2 with the sub chain).
    Each pass's outputs are those of ``assemble_project(stat, dyn, cam, ...,
    shifts[v])`` and ``render_view(..., get_dynamic=True, extra_colors=flow,
    subset_alpha_only=True, want_depth=False, want_alpha=False,
    precomputed=...)`` to the bit, from the same float operations: the
    assembly as :func:`render_latents`' over a leading pass axis, one
    projection over it at the one camera (``ops/projection.py``, the products
    with its rotation per pass), each pass binned on its own
    (``ops/tiles.py::bin_views``), one composite launch over all their tiles
    (``ops/cuda_raster.py``), one decode with the camera's rays, which on the
    card may round some values in their last place as :func:`render_latents`'
    does.

    Counters (while counting is on): ``render.flow_calls`` one a call,
    ``render.flow_views`` its V."""
    V = shifts.shape[0]
    if obs.COUNTING:
        obs.count("render.flow_calls", host_int=1)
        obs.count("render.flow_views", host_int=V)
    means, quats, scales, opac, colors = _assemble_views(stat, dyn, cam.time, max_time,
                                                         shifts, V)
    splats = projection.project(means, quats, scales, cam.w2c.expand(V, 4, 4), cam.K,
                                width, height, eps2d=config.eps2d, near=config.near,
                                sigma_cut=config.sigma_cut)
    bins = tiles.bin_views(projection.ProjectedSplats(*(x.detach() for x in splats)),
                           width, height, tiles_per_gauss=config.tiles_per_gauss,
                           max_per_tile=config.max_per_tile)
    flow2d = (mid2d - splats.means2d).detach()
    dyn_mask = torch.cat([torch.zeros(stat.capacity, dtype=torch.float32, device=opac.device),
                          torch.ones(dyn.capacity, dtype=torch.float32, device=opac.device)])
    feat, _, _, d_alphas = cuda_raster.composite_tiles(
        bins, splats, torch.cat([colors, flow2d], dim=-1), opac, width, height,
        sub_opacities=opac * dyn_mask, want_depth=False, want_alpha=False,
        backend=config.backend)
    images = apply_sandwich(sandwich, feat[..., :9], cam_rays(cam, width, height))
    return FlowPassOut(images=images, d_alphas=d_alphas, flows=feat[..., 9:],
                       means2d=splats.means2d, tile_max=bins.max_count)


@obs.spanned("render")
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


@obs.spanned("render")
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


@obs.spanned("render")
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
