"""The benchmark's inputs: the synthetic DyBluRF-like scene and its seed
point clouds, made from the seed.

Frozen copies of the program's ``data/synthetic.py::generate`` and
``init_point_clouds`` (the train CLI's ``--synthetic`` path), rendered
through the benchmark's own compositor (``refmodel``), so a change to the
program cannot change the benchmark's inputs.
"""

from __future__ import annotations

import numpy as np
import torch

from harness import refmodel as R


def _orbit_w2c(t: float, radius: float = 8.0, wobble: float = 0.25):
    ang = wobble * np.sin(2 * np.pi * t)
    c, s = np.cos(ang), np.sin(ang)
    R_c2w = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
    center = np.array([radius * np.sin(ang), 0.1 * np.sin(4 * np.pi * t),
                       radius * (np.cos(ang) - 1.0)], np.float32)
    w2c = np.eye(4, dtype=np.float32)
    w2c[:3, :3] = R_c2w.T
    w2c[:3, 3] = -R_c2w.T @ center
    return w2c


@torch.no_grad()
def generate(width: int, height: int, num_frames: int, seed: int, device,
             n_static: int = 600, n_dyn: int = 150, blur_substeps: int = 5,
             exposure: float = 0.35, budgets=(36, 256)):
    """A static shell and a moving blob of Gaussians rendered into blurry
    training frames (the mean of ``blur_substeps`` renders across the
    exposure) with depths, motion masks and blur features, and sharp test
    frames. Returns (scene dict of host arrays, ground-truth dynamic tracks
    [Nd, V, 3])."""
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
    n = n_static + n_dyn
    quats = np.zeros((n, 4), np.float32)
    quats[:, 0] = 1
    scales = np.full((n, 3), 0.06, np.float32)
    scales[n_static:] = 0.05

    def on(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)

    geom = dict(quats=on(quats), scales=on(scales), opacity=on(np.full(n, 0.8)),
                colors=on(np.concatenate([s_cols, d_cols])))
    K_t = on(K)
    zero3 = torch.zeros(3, dtype=torch.float32, device=device)

    def render(means, w2c, sl=slice(None)):
        g = {k: v[sl] for k, v in geom.items()}
        g["means"] = on(means)
        return R.rasterize(g, on(w2c), K_t, width, height, budgets, bg=zero3)

    def dyn_at(t):
        return d_base + d_vel[None] * t

    times = np.linspace(0, 1, num_frames).astype(np.float32)
    traj = np.stack([dyn_at(t) for t in times], axis=1)
    sub_ts, sub_w2cs = [], []
    for t in times:
        for k in range(blur_substeps):
            dt = exposure * (k / max(blur_substeps - 1, 1) - 0.5) / max(num_frames - 1, 1)
            tk = float(np.clip(t + dt, 0, 1))
            sub_ts.append(tk)
            sub_w2cs.append(_orbit_w2c(tk))
    sharp = np.stack([_orbit_w2c(t) for t in times])
    blurry, imgs_sharp, deps, masks, bfs = [], [], [], [], []
    for i, t in enumerate(times):
        acc = 0
        for k in range(blur_substeps):
            j = i * blur_substeps + k
            acc = acc + render(np.concatenate([s_pts, dyn_at(sub_ts[j])]), sub_w2cs[j])["image"]
        blur = acc / blur_substeps
        out = render(np.concatenate([s_pts, dyn_at(t)]), sharp[i])
        dyn = render(dyn_at(t), sharp[i], slice(n_static, None))
        blurry.append(blur)
        imgs_sharp.append(out["image"])
        deps.append(out["depth"])
        masks.append((dyn["alpha"] > 0.3).float())
        bfs.append(R.blur_feature(blur))

    def host(x):
        return torch.stack(x).cpu().numpy()

    scene = dict(w2c=sharp, K=np.tile(K[None], (num_frames, 1, 1)), time=times,
                 images=host(blurry), depths=host(deps), blur_feats=host(bfs).astype(np.float32),
                 masks=host(masks), width=width, height=height,
                 max_time=float(num_frames - 1), test_images=host(imgs_sharp))
    return scene, traj


def init_point_clouds(scene: dict, traj: np.ndarray, n_stat: int, n_dyn: int,
                      seed: int):
    """Seed clouds unprojected from the frames' depths: static seeds off the
    motion masks, dynamic seeds on them (inside the Tukey fences of each
    frame's masked depths), each given a whole track by the nearest ground
    truth track's displacement. Host numpy."""
    rng = np.random.default_rng(seed)
    V, H, W = scene["depths"].shape
    stat_pts, stat_cols, dyn_pts, dyn_frame = [], [], [], []
    ys, xs = np.mgrid[0:H, 0:W]
    for v in range(V):
        z = scene["depths"][v].reshape(-1)
        ok = z > 0.1
        K = scene["K"][v]
        x = (xs.reshape(-1) + 0.5 - K[0, 2]) / K[0, 0] * z
        y = (ys.reshape(-1) + 0.5 - K[1, 2]) / K[1, 1] * z
        cam = np.stack([x, y, z], -1)[ok]
        c2w = np.linalg.inv(scene["w2c"][v])
        wpts = cam @ c2w[:3, :3].T + c2w[:3, 3]
        moving = scene["masks"][v].reshape(-1)[ok] >= 0.5
        stat_pts.append(wpts[~moving])
        stat_cols.append(scene["images"][v].reshape(-1, 3)[ok][~moving])
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
    dyn_pts = np.concatenate(dyn_pts)
    if len(dyn_pts) < max(1, n_dyn // 8):
        raise ValueError(f"{len(dyn_pts)} masked depth pixels for {n_dyn} dynamic seeds")
    dsel = rng.choice(len(dyn_pts), size=n_dyn, replace=len(dyn_pts) < n_dyn)
    pts = dyn_pts[dsel].astype(np.float32)
    frames = np.concatenate(dyn_frame)[dsel]
    seed_traj = np.empty((n_dyn, traj.shape[1], 3), np.float32)
    for v in np.unique(frames):
        m = frames == v
        d = np.linalg.norm(pts[m][:, None] - traj[None, :, v], axis=-1)
        nn = np.argmin(d, axis=1)
        seed_traj[m] = pts[m][:, None] + (traj[nn] - traj[nn, v][:, None])
    return (stat_pts[sel].astype(np.float32), stat_cols[sel].astype(np.float32), seed_traj)


def extent_from_cameras(w2c: np.ndarray) -> float:
    """1.1 x the largest distance of a camera centre from their mean."""
    centers = np.linalg.inv(w2c)[:, :3, 3]
    return float(1.1 * np.linalg.norm(centers - centers.mean(0), axis=1).max())
