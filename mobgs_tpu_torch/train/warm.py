"""Warm-stage geometric initialization (port of ``mobgs_tpu/train/warm.py``).

Reference: ``scene_initialization`` (train.py:58-199) and the depth-warping
ops it uses (``scene/deformation.py:481-783``):

1. For every training frame, warp every other frame into it through the
   depth map (inverse warping) and accumulate the photometric error.
2. Pixels with error == 0 AND motion-mask == 0 seed the *static* cloud
   (accumulated across all frames, stat_npts sampled).
3. Frame-0 pixels with error == 1 AND mask == 1 seed the *dynamic* cloud
   (dyn_npts sampled); each dynamic seed snaps to its nearest TAPIR track
   and its 3D trajectory is read off the per-frame unprojected point maps at
   the track positions (nearest sampling).

The tensor work (warps, error masks, point maps, the nearest-track search)
runs on the device given; each target view warps all reference views in one
batch and adds their errors in the reference order, as the JAX package's
``fori_loop`` does. The selections stay numpy, drawn from
``np.random.default_rng(seed)`` in the JAX module's order, so both packages
pick the same seeds from the same masks.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from mobgs_tpu_torch import resolve_device

# dynamic seeds per nearest-track search chunk (bounds the [chunk, P]
# distance matrix)
_TRACK_CHUNK = 1024


class PointClouds(NamedTuple):
    stat_points: np.ndarray  # [Ns, 3]
    stat_colors: np.ndarray  # [Ns, 3]
    stat_times: np.ndarray   # [Ns]
    dyn_points: np.ndarray   # [Nd, 3]
    dyn_colors: np.ndarray   # [Nd, 3]
    dyn_times: np.ndarray    # [Nd]
    dyn_trajectory: np.ndarray  # [Nd, T, 3] world-space tracks


def unproject_depth(depth: torch.Tensor, w2c: torch.Tensor,
                    K: torch.Tensor) -> torch.Tensor:
    """Depth map → world points [H, W, 3] (deformation.points_from_DRTK)."""
    H, W = depth.shape
    ys, xs = torch.meshgrid(torch.arange(H, device=depth.device),
                            torch.arange(W, device=depth.device), indexing="ij")
    z = depth
    x = (xs.to(torch.float32) + 0.5 - K[0, 2]) / K[0, 0] * z
    y = (ys.to(torch.float32) + 0.5 - K[1, 2]) / K[1, 1] * z
    cam = torch.stack([x, y, z], -1)
    c2w_R = w2c[:3, :3].T
    c2w_t = -c2w_R @ w2c[:3, 3]
    return cam @ c2w_R.T + c2w_t


def inverse_warp(ref_img: torch.Tensor, tgt_depth: torch.Tensor,
                 w2c_tgt: torch.Tensor, w2c_ref: torch.Tensor,
                 K: torch.Tensor):
    """Warp ``ref_img`` into the target view through the target depth
    (deformation.inverse_warp_rt1_rt2, :640-702). Returns
    (warped [..., H, W, 3], in_bounds [..., H, W]).

    ``ref_img`` [R, H, W, 3] with ``w2c_ref`` [R, 4, 4] warps R reference
    views at once; [H, W, 3] with [4, 4] warps one."""
    H, W = tgt_depth.shape
    wpts = unproject_depth(tgt_depth, w2c_tgt, K)          # [H, W, 3]
    R_ref, t_ref = w2c_ref[..., :3, :3], w2c_ref[..., :3, 3]
    cam_ref = (wpts @ R_ref.transpose(-1, -2).unsqueeze(-3)
               + t_ref[..., None, None, :])                # [..., H, W, 3]
    z = torch.clamp(cam_ref[..., 2], min=1e-6)
    u = K[0, 0] * cam_ref[..., 0] / z + K[0, 2]
    v = K[1, 1] * cam_ref[..., 1] / z + K[1, 2]
    inb = (u >= 0) & (u <= W - 1) & (v >= 0) & (v <= H - 1) & (cam_ref[..., 2] > 0)

    u0 = torch.clamp(torch.floor(u - 0.5).to(torch.int64), 0, W - 1)
    v0 = torch.clamp(torch.floor(v - 0.5).to(torch.int64), 0, H - 1)
    wu = torch.clamp(u - 0.5 - u0, 0.0, 1.0)
    wv = torch.clamp(v - 0.5 - v0, 0.0, 1.0)
    u1 = torch.clamp(u0 + 1, 0, W - 1)
    v1 = torch.clamp(v0 + 1, 0, H - 1)

    flat = ref_img.reshape(*ref_img.shape[:-3], H * W, 3)

    def at(iy, ix):
        idx = (iy * W + ix).reshape(*iy.shape[:-2], H * W, 1).expand(
            *iy.shape[:-2], H * W, 3)
        return torch.gather(flat, -2, idx).reshape(*iy.shape, 3)

    top = at(v0, u0) * (1 - wu)[..., None] + at(v0, u1) * wu[..., None]
    bot = at(v1, u0) * (1 - wu)[..., None] + at(v1, u1) * wu[..., None]
    warped = top * (1 - wv)[..., None] + bot * wv[..., None]
    warped = warped * inb[..., None]
    return warped, inb


def photometric_error_masks(images: torch.Tensor, depths: torch.Tensor,
                            w2cs: torch.Tensor, Ks: torch.Tensor) -> torch.Tensor:
    """Per-frame binary inconsistency masks (train.py:91-109).

    Returns [V, H, W] in {0, 1}: 1 = photometrically inconsistent
    (accumulated warp error above its frame mean)."""
    V = images.shape[0]
    out = []
    for tgt in range(V):
        warped, _ = inverse_warp(images, depths[tgt], w2cs[tgt], w2cs, Ks[tgt])
        out_mask = (torch.sum(warped, -1) > 0).to(torch.float32)
        err = out_mask * torch.mean(torch.abs(warped - images[tgt]), -1)  # [V, H, W]
        acc = torch.zeros_like(depths[tgt])
        for ref in range(V):  # the reference order, as the JAX fori_loop adds
            acc = acc + err[ref]
        out.append((acc > torch.mean(acc)).to(torch.float32))
    return torch.stack(out)


def _nearest_tracks(coords: np.ndarray, start: np.ndarray,
                    dev: torch.device) -> np.ndarray:
    """argmin over tracks of the squared distance to each seed, first index
    on ties (numpy's), in chunks of seeds on ``dev``."""
    c = torch.as_tensor(coords, device=dev)
    s = torch.as_tensor(start, device=dev)
    out = [torch.argmin(((c[i:i + _TRACK_CHUNK, None] - s[None]) ** 2).sum(-1), dim=1)
           for i in range(0, len(c), _TRACK_CHUNK)]
    return torch.cat(out).cpu().numpy()


def warm_init(images: np.ndarray, depths: np.ndarray, w2cs: np.ndarray,
              Ks: np.ndarray, times: np.ndarray, motion_masks: np.ndarray,
              tracklet: np.ndarray, stat_npts: int, dyn_npts: int,
              seed: int = 0, device: str | torch.device | None = None) -> PointClouds:
    """Full warm-stage init (train.py:58-199) on ``device`` (the card unless
    ``"cpu"``).

    Args:
      images: [V, H, W, 3]; depths: [V, H, W]; w2cs: [V, 4, 4];
      Ks: [V, 3, 3]; times: [V]; motion_masks: [V, H, W] in {0,1};
      tracklet: [T, P, 2] TAPIR tracks in pixel coords (frame-0 anchored).
    """
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    V, H, W = depths.shape

    def on(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=dev)

    with torch.no_grad():
        d_t, w_t, k_t = on(depths), on(w2cs), on(Ks)
        err = photometric_error_masks(on(images), d_t, w_t, k_t).cpu().numpy()
        point_maps = torch.stack([unproject_depth(d_t[v], w_t[v], k_t[v])
                                  for v in range(V)]).cpu().numpy()  # [V,H,W,3]

    stat_pts, stat_cols, stat_ts = [], [], []
    for v in range(V):
        sel = (err[v].reshape(-1) == 0) & (motion_masks[v].reshape(-1) == 0)
        stat_pts.append(point_maps[v].reshape(-1, 3)[sel])
        stat_cols.append(images[v].reshape(-1, 3)[sel])
        stat_ts.append(np.full(sel.sum(), times[v], np.float32))
    stat_pts = np.concatenate(stat_pts)
    stat_cols = np.concatenate(stat_cols)
    stat_ts = np.concatenate(stat_ts)
    sel = rng.choice(len(stat_pts), size=min(stat_npts, len(stat_pts)),
                     replace=len(stat_pts) < stat_npts)
    stat_pts, stat_cols, stat_ts = stat_pts[sel], stat_cols[sel], stat_ts[sel]

    # dynamic seeds from frame 0 (train.py:126-148)
    dyn_sel = (err[0].reshape(-1) == 1) & (motion_masks[0].reshape(-1) == 1)
    idxs = np.nonzero(dyn_sel)[0]
    if len(idxs) == 0:  # degenerate scene: fall back to masked pixels
        idxs = np.nonzero(motion_masks[0].reshape(-1) > 0)[0]
    if len(idxs) == 0:
        idxs = np.arange(H * W)
    replace = len(idxs) < dyn_npts
    pick = rng.choice(idxs, size=dyn_npts, replace=replace)
    ys, xs = np.divmod(pick, W)
    dyn_coords = np.stack([xs, ys], -1).astype(np.float32)  # [Nd, 2] (x, y)
    dyn_pts = point_maps[0].reshape(-1, 3)[pick]
    dyn_cols = images[0].reshape(-1, 3)[pick]
    dyn_ts = np.full(dyn_npts, times[0], np.float32)

    # nearest TAPIR track per dynamic seed (train.py:171-189)
    nearest = _nearest_tracks(dyn_coords, np.asarray(tracklet[0], np.float32), dev)
    track = tracklet[:, nearest]                            # [T, Nd, 2]
    # nearest-neighbour sample of per-frame world point maps at track pos
    T = track.shape[0]
    traj = np.zeros((dyn_npts, T, 3), np.float32)
    for t in range(T):
        px = np.clip(np.round(track[t, :, 0]).astype(np.int64), 0, W - 1)
        py = np.clip(np.round(track[t, :, 1]).astype(np.int64), 0, H - 1)
        traj[:, t] = point_maps[min(t, V - 1), py, px]

    return PointClouds(stat_points=stat_pts.astype(np.float32),
                       stat_colors=stat_cols.astype(np.float32),
                       stat_times=stat_ts,
                       dyn_points=dyn_pts.astype(np.float32),
                       dyn_colors=dyn_cols.astype(np.float32),
                       dyn_times=dyn_ts,
                       dyn_trajectory=traj)


def seed_from_depths(data, n_points: int, rng: np.random.Generator,
                     device: str | torch.device | None = None):
    """Seed a point cloud by unprojecting the per-view depth priors on
    ``device`` — the registry families without an SfM cloud
    (blender/dycheck) seed this way; mirrors the per-family random/depth
    seeding of ``dataset_readers.py`` (e.g. readNerfSyntheticInfo's random
    cloud, but anchored to the depth priors when they exist).

    Returns (points [N, 3], colors [N, 3]) float32.
    """
    dev = resolve_device(device)
    V = data.w2c.shape[0]
    per_view = max(1, n_points // V)
    pts_l, col_l = [], []
    for v in range(V):
        with torch.no_grad():
            pm = unproject_depth(*(torch.as_tensor(np.asarray(x, np.float32), device=dev)
                                   for x in (data.depths[v], data.w2c[v], data.K[v])))
        flat = pm.cpu().numpy().reshape(-1, 3)
        cols = data.images[v].reshape(-1, 3)
        pick = rng.choice(len(flat), size=min(per_view, len(flat)),
                          replace=False)
        pts_l.append(flat[pick])
        col_l.append(cols[pick])
    return (np.concatenate(pts_l).astype(np.float32),
            np.concatenate(col_l).astype(np.float32))
