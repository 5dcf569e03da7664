"""Synthetic DyBluRF-like scene generator (port of
``mobgs_tpu/data/synthetic.py``).

Builds a ground-truth Gaussian scene (static shell + moving dynamic
blob), renders blurry/sharp frame pairs with known camera motion through
the port's rasterizer, and packages them in host-side numpy arrays. The
scene comes from the seed alone; nothing is downloaded.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from mobgs_tpu_torch import resolve_device
from mobgs_tpu_torch.models import blce as B
from mobgs_tpu_torch.ops.rasterize import RasterConfig, rasterize


class SceneData(NamedTuple):
    """Host-side training data for one scene (arrays stacked over views)."""
    w2c: np.ndarray          # [V, 4, 4]
    K: np.ndarray            # [V, 3, 3]
    time: np.ndarray         # [V]
    images: np.ndarray       # [V, H, W, 3]
    depths: np.ndarray       # [V, H, W]
    blur_feats: np.ndarray   # [V]
    masks: np.ndarray        # [V, H, W] motion masks
    width: int
    height: int
    max_time: float
    # test split (sharp)
    test_w2c: np.ndarray
    test_images: np.ndarray
    # test-split intrinsics/times — None ⇒ reuse the train split's
    test_K: np.ndarray | None = None
    test_time: np.ndarray | None = None
    # optional SfM seed cloud
    points_xyz: np.ndarray | None = None
    points_rgb: np.ndarray | None = None
    # loader-provided scene extent; 0.0 = derive from cameras/points
    extent: float = 0.0


def _orbit_w2c(t: float, radius: float = 8.0, wobble: float = 0.25):
    ang = wobble * np.sin(2 * np.pi * t)
    c = np.cos(ang); s = np.sin(ang)
    R_c2w = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
    center = np.array([radius * np.sin(ang), 0.1 * np.sin(4 * np.pi * t),
                       radius * (np.cos(ang) - 1.0)], np.float32)
    w2c = np.eye(4, dtype=np.float32)
    w2c[:3, :3] = R_c2w.T
    w2c[:3, 3] = -R_c2w.T @ center
    return w2c


@torch.no_grad()
def generate(width: int = 128, height: int = 72, num_frames: int = 12,
             n_static: int = 600, n_dyn: int = 150, seed: int = 0,
             blur_substeps: int = 5, exposure: float = 0.35,
             raster_cfg: RasterConfig = RasterConfig(tile_chunk=12,
                                                     max_per_tile=256),
             device: str | torch.device | None = None,
             return_alpha: bool = False):
    """Render a synthetic scene on ``device`` (the card unless ``"cpu"``).
    Returns (SceneData, gt_dyn_traj [Nd,V,3]); with ``return_alpha`` also
    the frames' alpha maps, (blurry [V,H,W], sharp [V,H,W]), for writers
    of layouts that store RGBA frames."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    f = 0.9 * width
    K = np.array([[f, 0, width / 2], [0, f, height / 2], [0, 0, 1]], np.float32)

    s_pts = rng.normal(size=(n_static, 3)).astype(np.float32) * np.array([3, 1.6, 2.0])
    s_pts[:, 2] += 9.0
    s_cols = rng.uniform(0.1, 0.9, (n_static, 3)).astype(np.float32)
    d_base = rng.normal(size=(n_dyn, 3)).astype(np.float32) * 0.5
    d_base[:, 2] += 8.0
    d_base[:, 0] -= 1.5
    d_cols = rng.uniform(0.2, 1.0, (n_dyn, 3)).astype(np.float32)
    d_vel = np.array([3.0, 0.6, 0.0], np.float32)

    quats = np.zeros((n_static + n_dyn, 4), np.float32); quats[:, 0] = 1
    scales = np.full((n_static + n_dyn, 3), 0.06, np.float32)
    scales[n_static:] = 0.05
    opac = np.full((n_static + n_dyn,), 0.8, np.float32)
    colors = np.concatenate([s_cols, d_cols], 0)

    def on_dev(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=dev)

    q_t, s_t, o_t, c_t, K_t = map(on_dev, (quats, scales, opac, colors, K))
    zero3 = torch.zeros(3, dtype=torch.float32, device=dev)

    alphas_l = []

    def render_posed(means, w2c):
        out = rasterize(on_dev(means), q_t, s_t, o_t, c_t, on_dev(w2c), K_t,
                        width, height, background=zero3, config=raster_cfg)
        alphas_l.append(out.alphas[0])
        return out.images[0], out.depths[0]

    def render_dyn(means_d, w2c):
        out = rasterize(on_dev(means_d), q_t[n_static:], s_t[n_static:],
                        o_t[n_static:], c_t[n_static:], on_dev(w2c), K_t,
                        width, height, background=zero3, config=raster_cfg)
        return out.alphas[0]

    def dyn_at(t):
        return d_base + d_vel[None] * t

    times = np.linspace(0, 1, num_frames).astype(np.float32)
    traj = np.stack([dyn_at(t) for t in times], axis=1)  # [Nd, V, 3]

    sub_ts, sub_w2cs = [], []
    for t in times:
        for k in range(blur_substeps):
            dt = exposure * (k / max(blur_substeps - 1, 1) - 0.5) / \
                max(num_frames - 1, 1)
            tk = float(np.clip(t + dt, 0, 1))
            sub_ts.append(tk)
            sub_w2cs.append(_orbit_w2c(tk))
    sharp_w2cs = np.stack([_orbit_w2c(t) for t in times])

    all_ts = sub_ts + list(times)
    all_w2c = np.concatenate([np.stack(sub_w2cs), sharp_w2cs], 0)
    imgs_l, deps_l = [], []
    for t, w2c in zip(all_ts, all_w2c):
        im, de = render_posed(np.concatenate([s_pts, dyn_at(t)], 0), w2c)
        imgs_l.append(im)
        deps_l.append(de)
    imgs_all = torch.stack(imgs_l).cpu().numpy()
    deps_all = torch.stack(deps_l).cpu().numpy()
    nsub = len(sub_ts)
    blurry_all = imgs_all[:nsub].reshape(
        num_frames, blur_substeps, height, width, 3).mean(axis=1)
    sharp_all = imgs_all[nsub:]
    dep_all = deps_all[nsub:]

    d_alpha_all = torch.stack([
        render_dyn(dyn_at(t), w2c) for t, w2c in zip(times, sharp_w2cs)
    ]).cpu().numpy()
    blurry_t = on_dev(blurry_all)
    bf_all = torch.stack([B.blur_feature(blurry_t[i])
                          for i in range(num_frames)]).cpu().numpy()

    imgs, depths, blur_feats, w2cs, masks = [], [], [], [], []
    test_imgs, test_w2cs = [], []
    for i, t in enumerate(times):
        imgs.append(blurry_all[i])
        depths.append(dep_all[i])
        w2cs.append(sharp_w2cs[i])
        masks.append((d_alpha_all[i] > 0.3).astype(np.float32))
        blur_feats.append(float(bf_all[i]))
        test_imgs.append(sharp_all[i])
        test_w2cs.append(sharp_w2cs[i])

    data = SceneData(
        w2c=np.stack(w2cs), K=np.tile(K[None], (num_frames, 1, 1)),
        time=times, images=np.stack(imgs), depths=np.stack(depths),
        blur_feats=np.asarray(blur_feats, np.float32),
        masks=np.stack(masks), width=width, height=height,
        max_time=float(num_frames - 1),
        test_w2c=np.stack(test_w2cs), test_images=np.stack(test_imgs))
    if return_alpha:
        a_all = torch.stack(alphas_l).cpu().numpy()
        return data, traj, (a_all[:nsub].reshape(num_frames, blur_substeps, height,
                                                   width).mean(axis=1), a_all[nsub:])
    return data, traj


def init_point_clouds(data: SceneData, traj: np.ndarray, n_stat: int,
                      n_dyn: int, seed: int = 0):
    """Seed point clouds from GT depth (stand-in for the warm stage;
    ``synthetic.py:188-265``). Host-side numpy.

    Static seeds: unprojected non-masked depth pixels across all frames.
    Dynamic seeds: unprojected masked (moving-object) depth pixels inside
    the Tukey fences of the frame's masked depths, each given a full
    trajectory by nearest-GT-track displacement transfer. Tiny scenes
    fall back to sampling GT particles."""
    rng = np.random.default_rng(seed)
    V, H, W = data.depths.shape
    stat_pts, stat_cols = [], []
    dyn_pts, dyn_frame = [], []
    for v in range(V):
        dep = data.depths[v]
        img = data.images[v]
        ys, xs = np.mgrid[0:H, 0:W]
        z = dep.reshape(-1)
        ok = z > 0.1
        K = data.K[v]
        x = (xs.reshape(-1) + 0.5 - K[0, 2]) / K[0, 0] * z
        y = (ys.reshape(-1) + 0.5 - K[1, 2]) / K[1, 1] * z
        cam_pts = np.stack([x, y, z], -1)[ok]
        c2w = np.linalg.inv(data.w2c[v])
        wpts = cam_pts @ c2w[:3, :3].T + c2w[:3, 3]
        moving = data.masks[v].reshape(-1)[ok] >= 0.5
        stat_pts.append(wpts[~moving])
        stat_cols.append(img.reshape(-1, 3)[ok][~moving])
        zm = z[ok][moving]
        if zm.size:
            q1, q3 = np.quantile(zm, (0.25, 0.75))
            iqr = max(q3 - q1, 1e-6)
            band = (zm >= q1 - 1.5 * iqr) & (zm <= q3 + 1.5 * iqr)
        else:
            band = np.zeros(0, bool)
        dyn_pts.append(wpts[moving][band])
        dyn_frame.append(np.full(int(band.sum()), v, np.int32))
    stat_pts = np.concatenate(stat_pts)
    stat_cols = np.concatenate(stat_cols)
    sel = rng.choice(len(stat_pts), size=min(n_stat, len(stat_pts)), replace=False)

    dyn_pts = np.concatenate(dyn_pts) if dyn_pts else np.zeros((0, 3))
    if len(dyn_pts) >= max(1, n_dyn // 8):
        dsel = rng.choice(len(dyn_pts), size=n_dyn,
                          replace=len(dyn_pts) < n_dyn)
        pts = dyn_pts[dsel].astype(np.float32)          # [n, 3] at frame v
        frames = np.concatenate(dyn_frame)[dsel]        # [n]
        seed_traj = np.empty((n_dyn, traj.shape[1], 3), np.float32)
        for v in np.unique(frames):
            m = frames == v
            d = np.linalg.norm(pts[m][:, None] - traj[None, :, v], axis=-1)
            nn = np.argmin(d, axis=1)
            disp = traj[nn] - traj[nn, v][:, None]      # [m, T, 3]
            seed_traj[m] = pts[m][:, None] + disp
        return (stat_pts[sel].astype(np.float32),
                stat_cols[sel].astype(np.float32), seed_traj)
    dyn_sel = rng.choice(traj.shape[0], size=min(n_dyn, traj.shape[0]),
                         replace=traj.shape[0] < n_dyn)
    return (stat_pts[sel].astype(np.float32), stat_cols[sel].astype(np.float32),
            traj[dyn_sel].astype(np.float32))
