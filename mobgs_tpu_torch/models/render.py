"""Scene rendering — spline-deformed dynamic + static Gaussian composition
(port of ``mobgs_tpu/models/render.py``).

One pipeline renders (:func:`render_views`): V views at one time, view v at
camera ``w2c[v]`` (or one camera for all) and exposure shift
``delta_exposure[v]``, with the static half assembled once and the dynamic
half at the V times in one broadcast evaluation, then
``ops/rasterize.py::rasterize`` over the leading view axis (one projection,
each view binned on its own, one composite launch a pass over all their
tiles) and one decode with each camera's rays. Subset passes
(dynamic-only, static-only) are opacity masks over the same tiles; optical
flow is a 2D displacement composited as extra colour columns. One view
(:func:`render_view`) is the same call without the view axis.

The train step's renders of a view are three calls of it: its E-1 latent
cameras (:func:`render_latents`), its E-1 exposure-flow passes at its own
camera (:func:`render_flow_passes`) and the mid render (one view). Each
view's features are those of its own one-view call to the bit, from the
same float operations; the decode's [V·H·W, 12] @ [12, 6] product may take
another cuBLAS kernel than one view's, and round some values in their last
place (on the CPU it gives the calls' bits).

:func:`render_views`, :func:`project_combined` and :func:`get_flow_static`
run in the span ``render`` (``utils/observability.py``); a nested call in
its own, one level down.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from mobgs_tpu_torch.data.cameras import Camera, cam_rays, pixel_grid
from mobgs_tpu_torch.models import gaussians as G
from mobgs_tpu_torch.models.sandwich import SandwichParams, apply_sandwich
from mobgs_tpu_torch.ops import projection
from mobgs_tpu_torch.ops.rasterize import RasterConfig, rasterize
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


def _bg9(bg3: torch.Tensor) -> torch.Tensor:
    """9-channel background = bg3 tiled x3 (renderer :90-91)."""
    return torch.cat([bg3, bg3, bg3])


class RenderOut(NamedTuple):
    """A render's outputs; every tensor but ``tile_max`` carries the call's
    leading view axis [V, ...] where it rendered V views."""
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


def _assemble_views(stat: G.GaussianState, dyn: G.GaussianState, time,
                    max_time: float, delta_exposure, views: tuple[int, ...]):
    """:func:`assemble`'s fields, over a leading axis of V views (``views``
    (V,); () for one view) at one time, view v shifted by
    ``delta_exposure[v]`` (None for none): the static half assembled once,
    the dynamic half at the V times in one broadcast evaluation; each view's
    rows those of its own call, to the bit. Returns (means, quats, scales,
    opacity, colors), each [V, N, ...] (or [N, ...])."""
    if views and delta_exposure is not None:
        delta_exposure = delta_exposure.reshape(views + (1, 1))
    dyn_rows = assemble_dyn(dyn, time, max_time, delta_exposure)

    def per_view(s, d):  # the static rows, then the view's dynamic
        if views:
            s = s.expand(views + s.shape)
            d = d if d.ndim == s.ndim else d.expand(views + d.shape)
        return torch.cat([s, d], dim=len(views))

    return tuple(per_view(s, d) for s, d in zip(assemble_static(stat), dyn_rows))


def _pool_masks(stat: G.GaussianState, dyn: G.GaussianState, get_dynamic: bool,
                get_static: bool):
    """[P, N] opacity masks, 1.0 on the dynamic rows (with ``get_dynamic``)
    then on the static rows (with ``get_static``); None for neither."""
    Ms = stat.capacity
    rows = ([slice(Ms, None)] if get_dynamic else []) + ([slice(0, Ms)] if get_static else [])
    if not rows:
        return None
    masks = torch.zeros((len(rows), Ms + dyn.capacity), dtype=torch.float32,
                        device=stat.xyz.device)
    for i, r in enumerate(rows):
        masks[i, r] = 1.0
    return masks


@obs.spanned("render")
def render_views(stat: G.GaussianState, dyn: G.GaussianState,
                 sandwich: SandwichParams, w2c: torch.Tensor, K: torch.Tensor,
                 time, width: int, height: int, bg3: torch.Tensor | None = None,
                 max_time: float = 1.0, delta_exposure=None,
                 get_static: bool = False, get_dynamic: bool = False,
                 extra_colors: torch.Tensor | None = None,
                 flow_to: torch.Tensor | None = None,
                 means2d_offset: torch.Tensor | None = None,
                 subset_alpha_only: bool = False,
                 want_depth: bool = True, want_alpha: bool = True,
                 config: RasterConfig = RasterConfig()) -> RenderOut:
    """Render V views at one time (reference `render()`,
    ``render.py:157-248``), in one pass.

    Args:
      w2c: [V, 4, 4] the views' cameras, or [4, 4] one camera for every
        view; K [3, 3] their intrinsics.
      delta_exposure: [V] the views' exposure shifts; with one camera a
        scalar (or None) renders one view, and every output is then
        without the view axis.
      bg3: [3] background; needed only with ``want_alpha``.
      extra_colors: [N, F] (or [V, N, F]) additional per-Gaussian channels
        composited with zero background (e.g. 2D flow displacements).
      flow_to: [N, 2] screen positions: each view's flow columns
        ``(flow_to − means2d).detach()`` from its own projection, composited
        after ``extra_colors`` (``ops/rasterize.py``).
      means2d_offset: [N, 2] the view-space gradient tap.
      subset_alpha_only: the static/dynamic subset passes composite only
        alpha; the first of them rides the main pass as the kernel's
        fused second chain. d_image/d_depth/s_image stay None.
      want_depth, want_alpha: composite the extended depth / weight
        columns; when off, depth/alpha come back as zeros and the
        background term is skipped.
    """
    if w2c.ndim == 3:
        views = (w2c.shape[0],)
    elif isinstance(delta_exposure, torch.Tensor) and delta_exposure.ndim:
        views = tuple(delta_exposure.shape)
    else:
        views = ()
    means, quats, scales, opac, colors = _assemble_views(stat, dyn, time, max_time,
                                                         delta_exposure, views)
    n_extra = (0 if extra_colors is None else extra_colors.shape[-1]) \
        + (0 if flow_to is None else 2)
    bg = None
    if want_alpha:
        bg = _bg9(bg3)
        if n_extra:
            bg = torch.cat([bg, torch.zeros(n_extra, dtype=bg.dtype, device=bg.device)])
    if extra_colors is not None:
        colors = torch.cat([colors, extra_colors], dim=-1)

    subsets = _pool_masks(stat, dyn, get_dynamic, get_static)
    pass_masks = alpha_masks = None
    if subset_alpha_only:
        alpha_masks = subsets
    elif subsets is not None:
        pass_masks = torch.cat([torch.ones_like(subsets[:1]), subsets])
    viewmat = w2c.expand(views + (4, 4)) if views and w2c.ndim == 2 else w2c
    out = rasterize(means, quats, scales, opac, colors, viewmat, K, width, height,
                    background=bg, pass_masks=pass_masks, alpha_masks=alpha_masks,
                    means2d_offset=means2d_offset, flow_to=flow_to,
                    want_depth=want_depth, want_alpha=want_alpha, config=config,
                    segments=(stat.capacity, dyn.capacity))

    rays = cam_rays(Camera(w2c=w2c, K=K, time=time), width, height)

    def passed(x, i):  # pass i of a [V, P, ...] (or [P, ...]) output
        return x.select(len(views), i)

    feat = passed(out.images, 0)
    image = apply_sandwich(sandwich, feat[..., :9], rays)
    i = 1
    j = 0
    d_image = d_depth = d_alpha = s_image = s_alpha = None
    if get_dynamic:
        if subset_alpha_only:
            d_alpha = passed(out.sub_alphas, j)
            j += 1
        else:
            d_image = apply_sandwich(sandwich, passed(out.images, i)[..., :9], rays)
            d_depth = passed(out.depths, i)
            d_alpha = passed(out.alphas, i)
            i += 1
    if get_static:
        if subset_alpha_only:
            s_alpha = passed(out.sub_alphas, j)
            j += 1
        else:
            s_image = apply_sandwich(sandwich, passed(out.images, i)[..., :9], rays)
            s_alpha = passed(out.alphas, i)
            i += 1
    return RenderOut(image=image, depth=passed(out.depths, 0), alpha=passed(out.alphas, 0),
                     d_image=d_image, d_depth=d_depth, d_alpha=d_alpha,
                     s_image=s_image, s_alpha=s_alpha, feat=feat[..., :9],
                     means2d=out.means2d, radii=out.radii,
                     flow=feat[..., 9:] if n_extra else None, tile_max=out.tile_max)


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
                config: RasterConfig = RasterConfig()) -> RenderOut:
    """Render one view at one time: :func:`render_views` at ``cam`` with a
    scalar (or None) ``delta_exposure``, whose outputs have no view axis."""
    return render_views(stat, dyn, sandwich, cam.w2c, cam.K, cam.time, width, height, bg3,
                        max_time, delta_exposure, get_static=get_static,
                        get_dynamic=get_dynamic, extra_colors=extra_colors,
                        means2d_offset=means2d_offset, subset_alpha_only=subset_alpha_only,
                        want_depth=want_depth, want_alpha=want_alpha, config=config)


def render_latents(stat: G.GaussianState, dyn: G.GaussianState,
                   sandwich: SandwichParams, w2c: torch.Tensor, K: torch.Tensor,
                   time, width: int, height: int, max_time: float = 1.0,
                   delta_exposure: torch.Tensor | None = None,
                   config: RasterConfig = RasterConfig()) -> RenderOut:
    """The train step's V latent renders of a view: :func:`render_views` at
    the cameras ``w2c`` [V, 4, 4] with the exposure shifts
    ``delta_exposure`` ([V], or None for none), image only (no background,
    depth or weight columns).

    Counters (while counting is on): ``render.latent_calls`` one a call,
    ``render.latent_views`` its V."""
    if obs.COUNTING:
        obs.count("render.latent_calls", host_int=1)
        obs.count("render.latent_views", host_int=w2c.shape[0])
    return render_views(stat, dyn, sandwich, w2c, K, time, width, height, None, max_time,
                        delta_exposure, want_depth=False, want_alpha=False, config=config)


def render_flow_passes(stat: G.GaussianState, dyn: G.GaussianState,
                       sandwich: SandwichParams, cam: Camera, width: int, height: int,
                       mid2d: torch.Tensor, max_time: float, shifts: torch.Tensor,
                       config: RasterConfig = RasterConfig()) -> RenderOut:
    """The train step's V exposure-flow passes of a view: :func:`render_views`
    at the view's camera ``cam`` with the exposure-time shifts ``shifts``
    ([V]), each pass composited with its exp→mid flow ``(mid2d −
    means2d_v).detach()`` (``mid2d`` [N, 2] the mid-time projection) as two
    extra columns and the dynamic-alpha chain, with no background, depth
    or weight columns (CE = 9 + 2 with the sub chain).

    Counters (while counting is on): ``render.flow_calls`` one a call,
    ``render.flow_views`` its V."""
    if obs.COUNTING:
        obs.count("render.flow_calls", host_int=1)
        obs.count("render.flow_views", host_int=shifts.shape[0])
    return render_views(stat, dyn, sandwich, cam.w2c, cam.K, cam.time, width, height, None,
                        max_time, shifts, get_dynamic=True, flow_to=mid2d,
                        subset_alpha_only=True, want_depth=False, want_alpha=False,
                        config=config)


@obs.spanned("render")
def project_combined(stat: G.GaussianState, dyn: G.GaussianState,
                     cam: Camera, width: int, height: int,
                     max_time: float = 1.0, delta_exposure=None,
                     config: RasterConfig = RasterConfig()) -> torch.Tensor:
    """2D projections of the combined set at a time (flow colours)."""
    geom = assemble(stat, dyn, cam.time, max_time, delta_exposure)
    return projection.project(geom.means, geom.quats, geom.scales, cam.w2c, cam.K,
                              width, height, eps2d=config.eps2d, near=config.near,
                              sigma_cut=config.sigma_cut).means2d


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
