"""The fine-stage training step and the exposure re-estimation (port of
``mobgs_tpu/train/step.py``).

One step renders, per view of the camera batch, the E-1 latent sharp images
at the BLCE-predicted poses (image only, ``want_depth=False,
want_alpha=False``) and the mid render at the view's own camera with the
dynamic-alpha chain fused in (``get_dynamic=True, subset_alpha_only=True``)
and the ``means2d_offset`` gradient tap; the latent images and the mid image
average into the synthetic blurry prediction. Loss (``step.py:361-372``):

  photo = L1(pred, gt) + λ_dssim (1 − SSIM(pred, gt))
  reg   = 0.2 L1(depth, gt_depth) + 1e-7 (entropy + sparsity)(dynamic alpha)
          + λ_flow Σ_views flow_warp_loss

With flow on (``lambda_flow_loss > 0`` and the latents on), each latent
render has an exposure-flow pass beside it: the combined set at the fixed
time shift ``(e - half)/half`` (not BLCE's exposure), projected at the
view's own camera and composited with its exp→mid flow as two extra
colour columns and the dynamic chain (CE = 9 + 2 with the sub chain); the
mid render carries the mid→exp flow of every exposure as 2·E extra columns
(CE = 9 + 18 + depth + weight = 29 with the sub chain at E=9). The flow
colours are detached; the flow pass's geometry is not, so the warp loss
reaches it through the composite.

Then the gradients of every Gaussian field, the Sandwich weights, the BLCE
parameters (global-norm clipped to 1) and the offsets; densify statistics
from the offsets' gradient scaled by (W/2, H/2); and Adam on each group.
The views are a Python loop; a view's renders are calls of the one render
pipeline (``models/render.py::render_views``), whatever the mesh: its E-1
latent renders in one (``render_latents``), its E-1 exposure-flow passes in
one (``render_flow_passes``) and the mid render (``render_view``). The
compositing runs through the
hand-written kernels for CUDA tensors (per step at B=2, E=9: 2 + 2 forward
and 2 + 2 backward launches flow off, 2 + 2 + 2 and 2 + 2 + 2 flow on), and
so does the flow-warp loss (``ops/cuda_warp.py``: a view's 2E warps in one
forward and one backward launch, 2 + 2 a step at B=2). The step updates
the state in place (parameters and Adam moments) and returns it with new
statistics and step count.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from mobgs_tpu_torch.core import se3
from mobgs_tpu_torch.core.image import psnr
from mobgs_tpu_torch.data.cameras import Camera, pixel_grid
from mobgs_tpu_torch.models import blce as B
from mobgs_tpu_torch.models import gaussians as G
from mobgs_tpu_torch.models import render as R
from mobgs_tpu_torch.models.sandwich import SandwichParams
from mobgs_tpu_torch.ops.rasterize import RasterConfig
from mobgs_tpu_torch.parallel import mesh as Mx
from mobgs_tpu_torch.train import densify, losses
from mobgs_tpu_torch.train.optim import (AdamState, adam_update, gaussian_lrs,
                                         init_adam)
from mobgs_tpu_torch.utils import observability as obs


class TrainState(NamedTuple):
    stat: G.GaussianState
    dyn: G.GaussianState
    sandwich: SandwichParams
    blce: B.BLCEState
    stat_opt: AdamState
    dyn_opt: AdamState
    sandwich_opt: AdamState
    blce_opt: AdamState
    stat_stats: densify.DensifyStats
    dyn_stats: densify.DensifyStats
    step: int  # iterations taken
    # the carried deformation net (models/deformation.py), which the fine
    # stage never renders through or updates: the step and the loop pass it
    # through untouched, the checkpoints write it (``step.py:51-56``)
    deform: object | None = None


class Batch(NamedTuple):
    """One sampled camera batch (tensors stacked over B)."""
    view_idx: torch.Tensor   # [B] int64
    w2c: torch.Tensor        # [B, 4, 4]
    K: torch.Tensor          # [B, 3, 3]
    time: torch.Tensor       # [B]
    image: torch.Tensor      # [B, H, W, 3] blurry GT
    depth: torch.Tensor      # [B, H, W] prior depth
    blur_feat: torch.Tensor  # [B] precomputed FFT blur features


class Metrics(NamedTuple):
    loss: torch.Tensor
    photo: torch.Tensor
    depth_l1: torch.Tensor
    mask: torch.Tensor
    flow: torch.Tensor
    psnr: torch.Tensor
    tile_max: torch.Tensor  # peak pre-clamp tile occupancy of the step


def sandwich_leaves(sw: SandwichParams) -> tuple[torch.Tensor, ...]:
    return tuple(getattr(sw, f) for f in SandwichParams._fields)


def init_train_state(stat: G.GaussianState, dyn: G.GaussianState,
                     sandwich: SandwichParams,
                     blce_state: B.BLCEState, deform=None) -> TrainState:
    """Zero Adam moments and densify statistics, on the state's device;
    ``deform`` (a ``DeformationParams`` or None) is carried as given."""
    dev = stat.xyz.device
    return TrainState(
        stat=stat, dyn=dyn, sandwich=sandwich, blce=blce_state,
        stat_opt=init_adam(G.split_diff(stat)[0]),
        dyn_opt=init_adam(G.split_diff(dyn)[0]),
        sandwich_opt=init_adam(sandwich_leaves(sandwich)),
        blce_opt=init_adam(blce_state.params.leaves()),
        stat_stats=densify.init_stats(stat.capacity, dev),
        dyn_stats=densify.init_stats(dyn.capacity, dev),
        step=0, deform=deform)


def make_forward(opt_cfg, width: int, height: int, max_time: float,
                 num_warp: int = 9, raster_cfg: RasterConfig = RasterConfig(),
                 use_blce: bool = True, with_latents: bool = True,
                 with_exposure_delta: bool = True):
    """The differentiated core of the step (``step.py:124-380``):
    ``forward(stat, dyn, sandwich, blce, offsets, batch)`` returns (total
    loss, aux).

    Args:
      use_blce: latent poses from BLCE; otherwise every latent render uses
        the view's own camera and zero exposure shift.
      with_latents: False before ``start_warp``: no latent renders and no
        flow term, the prediction is the mid render alone.
      with_exposure_delta: False before ``start_warp_dynamic``: latent
        renders keep the warped poses but no exposure time shift (the flow
        passes keep their fixed shifts either way).
    """
    E = num_warp
    half = E // 2
    others = [e for e in range(E) if e != half]
    lambda_dssim = opt_cfg.lambda_dssim
    lambda_flow = opt_cfg.lambda_flow_loss
    compute_flow = lambda_flow > 0 and with_latents
    # the flow passes' fixed exposure-time shifts (step.py:198-199)
    ratios = [(e - half) / half for e in range(E)] if compute_flow else None

    def forward(stat, dyn, sandwich, blce_state, offsets, batch: Batch):
        dev = stat.xyz.device
        bg3 = torch.zeros(3, dtype=torch.float32, device=dev)
        preds, depths, d_alphas, radii, tile_maxes, flow_ls = [], [], [], [], [], []
        if compute_flow:
            shifts = torch.tensor([ratios[e] for e in others], dtype=torch.float32,
                                  device=dev)
        for b in range(batch.view_idx.shape[0]):
            w2c, K, time = batch.w2c[b], batch.K[b], batch.time[b]
            cam = Camera(w2c=w2c, K=K, time=time)
            if compute_flow:
                mid2d = R.project_combined(stat, dyn, cam, width, height,
                                           max_time, None, raster_cfg).detach()
            if with_latents:
                if use_blce:
                    lat_c2w, expo = B.latent_poses(
                        blce_state, se3.view_to_world(w2c), batch.blur_feat[b],
                        batch.view_idx[b], E)
                    lat_w2c = se3.view_to_world(lat_c2w)
                else:
                    lat_w2c = w2c.expand(E, 4, 4)
                    expo = torch.zeros(E, dtype=torch.float32, device=dev)
                # the latent renders, image only (train.py:502-541): the E-1
                # cameras in one call
                lat = R.render_latents(
                    stat, dyn, sandwich, torch.cat([lat_w2c[:half], lat_w2c[half + 1:]]),
                    K, time, width, height, max_time,
                    torch.cat([expo[:half], expo[half + 1:]]) if with_exposure_delta
                    else None, config=raster_cfg)
                tile_maxes.append(lat.tile_max)
                # keep only the images: the call's zero depth and alpha maps and
                # its [V, N] projections would otherwise live to the loss
                lat_image = lat.image
                del lat
            mid_extra = None
            if compute_flow:
                # the exposure-flow passes at the view's own camera and the
                # exposure-time geometry (train.py:564-584), the E-1 shifts
                # in one call: image, exp→mid flow columns and the dynamic
                # alpha
                fl = R.render_flow_passes(stat, dyn, sandwich, cam, width, height,
                                          mid2d, max_time, shifts, raster_cfg)
                tile_maxes.append(fl.tile_max)
                f_imgs, f_alphas, f_e2m = list(fl.image), list(fl.d_alpha), list(fl.flow)
                # mid→exposure flow colours ride the mid render as 2·E extra
                # columns, (x, y) per exposure; the mid exposure's are zero
                flow2d_o = list((mid2d - fl.means2d).detach())
                del fl  # as the latents' output above
                flow2d = torch.stack(flow2d_o[:half]
                                     + [torch.zeros_like(flow2d_o[0])]
                                     + flow2d_o[half:])              # [E, N, 2]
                mid_extra = (-flow2d).permute(1, 0, 2).reshape(-1, 2 * E)
            # mid render at the view's camera (train.py:441-469)
            mid = R.render_view(stat, dyn, sandwich, cam, width, height, bg3,
                                max_time, None, get_static=False,
                                get_dynamic=True, means2d_offset=offsets[b],
                                extra_colors=mid_extra,
                                subset_alpha_only=True, config=raster_cfg)
            tile_maxes.append(torch.as_tensor(mid.tile_max))
            if with_latents:
                preds.append((lat_image.sum(0) + mid.image) / E + 1e-10)
            else:
                preds.append(mid.image)
            depths.append(mid.depth)
            d_alphas.append(mid.d_alpha)
            radii.append(mid.radii)

            if compute_flow:
                # exposure flow consistency (train.py:564-584); the mid
                # exposure is the mid render itself
                pix = pixel_grid(width, height, use_center=False, device=dev)
                m2e = mid.flow.reshape(height, width, E, 2).permute(2, 0, 1, 3)
                zrow = torch.zeros((height, width, 2), dtype=torch.float32,
                                   device=dev)
                lat_f_imgs = torch.stack(f_imgs[:half] + [mid.image] + f_imgs[half:])
                lat_alphas = torch.stack(f_alphas[:half] + [mid.d_alpha]
                                         + f_alphas[half:])
                e2m = torch.stack(f_e2m[:half] + [zrow] + f_e2m[half:])
                flow_ls.append(losses.flow_warp_loss(
                    mid.image, lat_f_imgs, lat_alphas, mid.d_alpha,
                    pix[None] + e2m, pix[None] + m2e, width, height,
                    backend=raster_cfg.backend))

        pred = torch.stack(preds).permute(0, 3, 1, 2)     # [B, 3, H, W]
        gt = batch.image.permute(0, 3, 1, 2)
        l1 = losses.l1_loss(pred, gt)
        ssim_v = losses.ssim_loss_term(pred, gt) if lambda_dssim else 0.0
        photo = l1 + lambda_dssim * (1.0 - ssim_v)
        depth_l1 = losses.l1_loss(torch.stack(depths), batch.depth)
        d_alpha = torch.stack(d_alphas)
        mask_l = 1e-7 * (losses.entropy_loss(d_alpha)
                         + losses.sparsity_loss(d_alpha))
        if compute_flow:
            flow_l = lambda_flow * torch.stack(flow_ls).sum()
        else:
            flow_l = torch.zeros((), dtype=torch.float32, device=dev)
        total = photo + (0.2 * depth_l1 + mask_l + flow_l)
        psnr_v = torch.mean(psnr(pred.detach(), gt))
        aux = dict(radii=torch.stack(radii), photo=photo, depth_l1=depth_l1,
                   mask=mask_l, flow=flow_l, psnr=psnr_v,
                   tile_max=torch.stack(tile_maxes).amax())
        return total, aux

    return forward


def make_train_step(opt_cfg, width: int, height: int, max_time: float,
                    num_warp: int = 9,
                    raster_cfg: RasterConfig = RasterConfig(),
                    spatial_lr_scale: float = 5.0, use_blce: bool = True,
                    with_latents: bool = True,
                    with_exposure_delta: bool = True,
                    with_omega_freeze: bool = False, mesh=None):
    """Build the per-iteration update ``train_step(ts, batch) -> (ts,
    Metrics)`` (``step.py:383-474``). It runs on the device the state lives
    on, and reads the state's Parameters from ``ts`` on every call, so a
    state whose pools grew between calls needs no new step.

    mesh: a ``data`` x ``gauss`` mesh (``parallel/mesh.py::make_mesh``), the
    explicit form of the JAX step's sharding propagation; None runs the
    step as on one device. With a mesh the step takes this rank's state
    (``parallel/mesh.py::shard_train_state``: its rows of the pools, their
    moments and statistics; the rest replicated) and its B / n_data views
    of the batch. Projection runs on the rank's rows and the records are
    all-gathered before binning (``ops/rasterize.py``); the step reduces
    over ``data`` what the JAX step reduces over the batch
    (``step.py:361-376,425-455``): the loss, the metrics and every gradient
    leaf averaged (the mask and flow terms are sums over the batch's views,
    so a rank's share counts n_data times before the average), the view-space
    gradient summed (a rank's is of its own mean over B / n_data views:
    scaled by 1 / n_data first), ``radii_max``, ``visible`` and
    ``tile_max`` maxed. The replicated leaves' gradients are also averaged
    over ``gauss``, where every rank holds them whole, so every rank takes
    the same BLCE clip and Adam update; the gauss-sharded leaves update
    their own rows.

    with_omega_freeze: densify mode 1 past iteration 8001
    (helper_train.py:191-194): the step takes two more arguments, [M] bool
    masks of the static and the dynamic pool, and applies
    ``densify.apply_omega_freeze`` to the Gaussian gradients before Adam."""
    forward = make_forward(opt_cfg, width, height, max_time, num_warp,
                           raster_cfg, use_blce, with_latents,
                           with_exposure_delta)
    n_data = 1 if mesh is None else mesh.size(0)

    def train_step(ts: TrainState, batch: Batch, stat_omega_mask=None,
                   dyn_omega_mask=None):
        stat_p, _ = G.split_diff(ts.stat)
        dyn_p, _ = G.split_diff(ts.dyn)
        sand_p = sandwich_leaves(ts.sandwich)
        blce_p = ts.blce.params.leaves()
        dev = ts.stat.xyz.device
        Ms = ts.stat.capacity
        Ntot = Ms + ts.dyn.capacity
        offsets = torch.zeros((batch.view_idx.shape[0], Ntot, 2),
                              dtype=torch.float32, device=dev,
                              requires_grad=True)
        groups = (stat_p, dyn_p, sand_p, blce_p, (offsets,))
        leaves = [p for grp in groups for p in grp]
        with torch.enable_grad(), Mx.gauss_sharded(mesh):
            for p in leaves:
                p.requires_grad_(True)
            with obs.span("forward"):
                total, aux = forward(ts.stat, ts.dyn, ts.sandwich, ts.blce,
                                     offsets, batch)
            if n_data > 1:
                # the mask term (sums over pixels) and the flow term sum
                # over the batch's views: this rank's views count n_data
                # times before the average over data
                total = total + (n_data - 1) * (aux["mask"] + aux["flow"])
                aux["mask"], aux["flow"] = n_data * aux["mask"], n_data * aux["flow"]
            with obs.span("backward"):
                grads = torch.autograd.grad(total, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads)]
        if mesh is not None:
            n_gauss_leaves = len(stat_p) + len(dyn_p)
            grads = (_mean_over(mesh, ("data",), grads[:n_gauss_leaves])
                     + _mean_over(mesh, ("gauss", "data"),
                                  grads[n_gauss_leaves:-1])
                     + [grads[-1] / n_data])
        split, i = [], 0
        for grp in groups:
            split.append(grads[i:i + len(grp)])
            i += len(grp)
        g_stat, g_dyn, g_sand, g_blce, (g_off,) = split
        if with_omega_freeze:
            g_stat = densify.apply_omega_freeze(G.DiffFields(*g_stat),
                                                stat_omega_mask)
            g_dyn = densify.apply_omega_freeze(G.DiffFields(*g_dyn),
                                               dyn_omega_mask)

        with obs.span("update"), torch.no_grad():
            # densification stats from the view-space gradient
            # (train.py:633-648), accumulated over the batch
            vs_grad = g_off.sum(0) * torch.tensor(
                [width * 0.5, height * 0.5], dtype=torch.float32, device=dev)
            radii = aux["radii"]                          # [B, Ntot]
            radii_max = radii.amax(0)
            visible = (radii > 0).any(0)
            if mesh is not None:
                vs_grad = Mx.reduce_over(mesh, "data", vs_grad)
                radii_max = Mx.reduce_over(mesh, "data", radii_max, "max")
                visible = Mx.reduce_over(mesh, "data", visible.to(torch.int32),
                                         "max").to(torch.bool)
            stat_stats = densify.add_stats(ts.stat_stats, vs_grad[:Ms],
                                           radii_max[:Ms], visible[:Ms])
            dyn_stats = densify.add_stats(ts.dyn_stats, vs_grad[Ms:],
                                          radii_max[Ms:], visible[Ms:])

            step = ts.step + 1
            lrs = gaussian_lrs(opt_cfg, step, spatial_lr_scale)
            stat_opt = adam_update(stat_p, g_stat, ts.stat_opt, lrs)
            dyn_opt = adam_update(dyn_p, g_dyn, ts.dyn_opt, lrs)
            sand_opt = adam_update(sand_p, g_sand, ts.sandwich_opt,
                                   [opt_cfg.rgb_lr] * len(sand_p))
            # BLCE: global-norm clip (the SE(3) exp-map's 1/|w| factors
            # amplify pose gradients where the decoded axis passes near
            # zero), lr 1e-4 decayed by 0.01^(step/iterations)
            gnorm = torch.sqrt(torch.stack([torch.sum(g * g) for g in g_blce]).sum()
                               + 1e-20)
            scale = torch.where(torch.isfinite(gnorm),
                                torch.clamp(1.0 / gnorm, max=1.0),
                                torch.zeros_like(gnorm))
            g_blce = [g * scale for g in g_blce]
            blce_lr = float(np.float32(1e-4) * np.float32(0.01) ** (
                np.float32(step) / np.float32(opt_cfg.iterations)))
            blce_opt = adam_update(blce_p, g_blce, ts.blce_opt,
                                   [blce_lr] * len(blce_p))

        new_ts = ts._replace(stat_opt=stat_opt, dyn_opt=dyn_opt,
                             sandwich_opt=sand_opt, blce_opt=blce_opt,
                             stat_stats=stat_stats, dyn_stats=dyn_stats,
                             step=step)
        values = [total, aux["photo"], aux["depth_l1"], aux["mask"], aux["flow"],
                  aux["psnr"]]
        tile_max = aux["tile_max"]
        if mesh is not None:
            values = Mx.reduce_over(mesh, "data", torch.stack(
                [torch.as_tensor(v, dtype=torch.float32, device=dev).detach()
                 for v in values]), "mean").unbind()
            tile_max = Mx.reduce_over(mesh, "data", tile_max, "max")
        loss, photo, depth_l1, mask, flow, psnr_v = (v.detach() for v in values)
        metrics = Metrics(loss=loss, photo=photo, depth_l1=depth_l1, mask=mask,
                          flow=flow, psnr=psnr_v, tile_max=tile_max)
        return new_ts, metrics

    return train_step


def _mean_over(mesh, axes, grads):
    """The gradient tensors averaged over each mesh axis of ``axes`` in
    turn, as one flat buffer per axis."""
    if not grads:
        return []
    flat = torch.cat([g.reshape(-1) for g in grads])
    for axis in axes:
        flat = Mx.reduce_over(mesh, axis, flat, "mean")
    return [x.view_as(g) for x, g in zip(torch.split(flat, [g.numel() for g in grads]),
                                          grads)]


def make_exposure_update(width: int, height: int, max_time: float,
                         num_warp: int = 9,
                         raster_cfg: RasterConfig = RasterConfig()):
    """Online exposure re-estimation (``step.py:477-526``; train.py:474-492,
    every 10 iterations): per batch view, the median ratio of the latent
    window's static flow magnitude (first to last latent pose) to the
    frame-to-frame one (previous to next view), over the pixels above the
    1 % quantile of the latter; halved at the sequence's ends, the old value
    kept where the estimate is not finite. Two ``get_flow_static``
    composites per view (CE=4), no gradient.

    ``update(ts, view_idx, w2c, K, time, blur_feat, fwd_w2c, bwd_w2c,
    is_endpoint)`` takes the batch's tensors (view_idx [B], w2c / fwd_w2c /
    bwd_w2c [B,4,4], K [B,3,3], time / blur_feat / is_endpoint [B]) and
    returns the state with ``blce.exposure_expo[view_idx]`` replaced (a new
    BLCE state sharing the parameters; the old state is left as it was)."""

    def update(ts: TrainState, view_idx, w2c, K, time, blur_feat,
               fwd_w2c, bwd_w2c, is_endpoint) -> TrainState:
        new_expos = []
        with torch.no_grad():
            for b in range(view_idx.shape[0]):
                cam = Camera(w2c=w2c[b], K=K[b], time=time[b])
                lat_c2w, _ = B.latent_poses(ts.blce, se3.view_to_world(w2c[b]),
                                            blur_feat[b], view_idx[b], num_warp)
                lat_w2c = se3.view_to_world(lat_c2w)
                start = Camera(w2c=lat_w2c[0], K=K[b], time=time[b])
                end = Camera(w2c=lat_w2c[-1], K=K[b], time=time[b])
                fwd = Camera(w2c=fwd_w2c[b], K=K[b], time=time[b])
                bwd = Camera(w2c=bwd_w2c[b], K=K[b], time=time[b])
                _, cam_flow = R.get_flow_static(ts.stat, bwd, fwd, cam, width,
                                                height, config=raster_cfg)
                _, lat_flow = R.get_flow_static(ts.stat, start, end, cam, width,
                                                height, config=raster_cfg)
                cam_mag = torch.linalg.norm(cam_flow, dim=-1).reshape(-1)
                lat_mag = torch.linalg.norm(lat_flow, dim=-1).reshape(-1)
                q = torch.quantile(cam_mag, 0.01)
                ratio = torch.where(cam_mag > q,
                                    lat_mag / torch.clamp(cam_mag, min=1e-12),
                                    torch.full_like(cam_mag, float("nan")))
                # the mean of the two middle values for an even count, as
                # jnp.nanmedian (torch.nanmedian returns the lower one)
                new_expo = torch.nanquantile(ratio, 0.5)
                new_expo = torch.where(is_endpoint[b], new_expo * 0.5, new_expo)
                new_expos.append(torch.where(torch.isfinite(new_expo), new_expo,
                                             ts.blce.exposure_expo[view_idx[b]]))
            expo = ts.blce.exposure_expo.clone()
            expo[view_idx] = torch.stack(new_expos)
        return ts._replace(blce=B.BLCEState(ts.blce.params, expo))

    return update
