"""Training debug visualization (port of ``mobgs_tpu/train/debug_vis.py``).

Parity targets: ``main_utils.py:49-92`` (the debug grids written every 300
iterations) and ``utils/scene_utils.py:14-269`` (``render_training_image``:
per-view panels with the latent sharp frames and flow colour maps). Both
render outside the train step, only when a dump is written; the images
are composed on the host with numpy.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from mobgs_tpu_torch.core import se3
from mobgs_tpu_torch.data.cameras import Camera, pixel_grid
from mobgs_tpu_torch.models import blce as B
from mobgs_tpu_torch.models import render as R
from mobgs_tpu_torch.ops.rasterize import RasterConfig
from mobgs_tpu_torch.utils.observability import save_debug_grid


def flow_to_color(flow: np.ndarray, max_mag: float | None = None) -> np.ndarray:
    """Optical-flow colour coding (the Middlebury/Baker colour wheel of the
    ``flow_vis`` package, ``scene_utils.py:109``). flow: [H, W, 2] → float
    RGB in [0, 1]."""
    # colour wheel: RY=15, YG=6, GC=4, CB=11, BM=13, MR=6 (55 colours)
    seg = [(15, [1, 0, 0], [1, 1, 0]), (6, [1, 1, 0], [0, 1, 0]),
           (4, [0, 1, 0], [0, 1, 1]), (11, [0, 1, 1], [0, 0, 1]),
           (13, [0, 0, 1], [1, 0, 1]), (6, [1, 0, 1], [1, 0, 0])]
    wheel = []
    for n, c0, c1 in seg:
        for i in range(n):
            a = i / n
            wheel.append([(1 - a) * x + a * y for x, y in zip(c0, c1)])
    wheel = np.asarray(wheel)                       # [55, 3]
    ncols = len(wheel)

    u, v = flow[..., 0], flow[..., 1]
    mag = np.sqrt(u * u + v * v)
    if max_mag is None:
        max_mag = max(float(mag.max()), 1e-6)
    u, v = u / max_mag, v / max_mag
    mag = mag / max_mag
    ang = np.arctan2(-v, -u) / np.pi                 # [-1, 1]
    fk = (ang + 1) / 2 * (ncols - 1)
    k0 = np.floor(fk).astype(int) % ncols
    k1 = (k0 + 1) % ncols
    f = (fk - np.floor(fk))[..., None]
    col = (1 - f) * wheel[k0] + f * wheel[k1]        # [H, W, 3]
    # saturate towards white for small magnitudes
    col = 1 - mag[..., None] * (1 - col)
    return np.clip(col, 0.0, 1.0)


def normals_from_depth_screen(depth: np.ndarray, K: np.ndarray) -> np.ndarray:
    """Screen-space normals of an expected-depth map, the finite-difference
    cross product of ``scene_utils.py:130-165`` (dx/du × dx/dv of the
    unprojected coordinates). Returns [H, W, 3] in [-1, 1]."""
    H, W = depth.shape
    fx, fy = K[0, 0], K[1, 1]
    cx, cy = K[0, 2], K[1, 2]
    xs, ys = np.meshgrid(np.arange(W) + 0.5, np.arange(H) + 0.5)
    z = depth + 1e-6
    x = (xs - cx) / fx * z
    y = (ys - cy) / fy * z
    coords = np.stack([x, y, z], axis=-1)            # [H, W, 3]
    du = np.diff(coords, axis=1)
    du = np.concatenate([du, du[:, -1:]], axis=1)
    dv = np.diff(coords, axis=0)
    dv = np.concatenate([dv, dv[-1:]], axis=0)
    n = np.cross(dv, du)
    n /= np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-8)
    return n


def _camera(data, view: int, dev) -> Camera:
    def on(x):
        return torch.as_tensor(np.asarray(x), dtype=torch.float32).to(dev)
    return Camera(w2c=on(data.w2c[view]), K=on(data.K[view]), time=on(data.time[view]))


def _np(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


@torch.no_grad()
def dump_debug_images(ts, data, iteration: int, out_dir: str, view: int = 0,
                      raster_cfg: RasterConfig = RasterConfig()):
    """Render the standard debug panel of one view and write the grid
    [render ‖ gt ‖ depth ‖ gt_depth ‖ d_alpha ‖ s_alpha ‖ s_render] to
    ``<out_dir>/fine_debug/iter_<iteration>.png``. Returns its path."""
    dev = ts.stat.xyz.device
    bg3 = torch.zeros(3, dtype=torch.float32, device=dev)
    out = R.render_view(ts.stat, ts.dyn, ts.sandwich, _camera(data, view, dev),
                        data.width, data.height, bg3, data.max_time,
                        get_static=True, get_dynamic=True, config=raster_cfg)
    depth = _np(out.depth)
    norm = max(float(depth.max()), 1e-6)
    gt_depth = np.asarray(data.depths[view])
    panels = {
        "render": _np(out.image),
        "gt": np.asarray(data.images[view]),
        "depth": depth / norm,
        "gt_depth": gt_depth / max(gt_depth.max(), 1e-6),
        "d_alpha": _np(out.d_alpha),
        "s_alpha": _np(out.s_alpha),
        "s_render": _np(out.s_image),
    }
    path = os.path.join(out_dir, "fine_debug", f"iter_{iteration:06d}.png")
    save_debug_grid(path, panels)
    return path


@torch.no_grad()
def render_training_panels(ts, data, iteration: int, out_dir: str,
                           view: int = 0, num_warp: int = 9,
                           with_latents: bool = True,
                           raster_cfg: RasterConfig = RasterConfig()):
    """``render_training_image`` for one train view (fine stage, BLCE
    active, ``scene_utils.py:88-110,205-210``), into
    ``<out_dir>/fine_render/train/images``:

      <name>_latent_XX.png   the E latent sharp renders (BLCE poses)
      <name>_flow_XX.png     their exp→mid flow colour maps
      <name>.png             [gt ‖ blurry (mean of latents) ‖ mid ‖ d_alpha]
      <name>_decomp.png      [gt_normal? ‖ pred_normal ‖ gt_depth ‖ depth]

    The E latent renders and flows are a loop of ``render_view`` and
    ``get_flow`` calls (the JAX package vmaps them)."""
    from PIL import Image

    W, H = data.width, data.height
    dev = ts.stat.xyz.device
    cam = _camera(data, view, dev)
    bg3 = torch.zeros(3, dtype=torch.float32, device=dev)
    mid = R.render_view(ts.stat, ts.dyn, ts.sandwich, cam, W, H, bg3,
                        data.max_time, get_static=True, get_dynamic=True,
                        config=raster_cfg)

    img_dir = os.path.join(out_dir, "fine_render", "train", "images")
    os.makedirs(img_dir, exist_ok=True)
    name = f"view{view:03d}_it{iteration:06d}"

    latents = None
    if with_latents:
        bf = torch.as_tensor(float(data.blur_feats[view]), device=dev)
        lat_c2w, expo = B.latent_poses(ts.blce, se3.view_to_world(cam.w2c), bf,
                                       view, num_warp)
        lat_w2c = se3.view_to_world(lat_c2w)
        pix = pixel_grid(W, H, use_center=False, device=dev)
        lat_imgs, flows = [], []
        for e in range(num_warp):
            cam_e = Camera(w2c=lat_w2c[e], K=cam.K, time=cam.time)
            out = R.render_view(ts.stat, ts.dyn, ts.sandwich, cam_e, W, H, bg3,
                                data.max_time, expo[e], config=raster_cfg)
            e2m, _, _, _ = R.get_flow(ts.stat, ts.dyn, ts.sandwich, cam, W, H, bg3,
                                      expo[e], data.max_time, config=raster_cfg)
            lat_imgs.append(_np(out.image))
            flows.append(_np(e2m - pix))
        for e in range(num_warp):
            Image.fromarray((np.clip(lat_imgs[e], 0, 1) * 255).astype(np.uint8)).save(
                os.path.join(img_dir, f"{name}_latent_{e:02d}.png"))
            Image.fromarray((flow_to_color(flows[e]) * 255).astype(np.uint8)).save(
                os.path.join(img_dir, f"{name}_flow_{e:02d}.png"))
        latents = np.stack(lat_imgs)

    gt = np.asarray(data.images[view])
    mid_np = _np(mid.image)
    blurry = (latents.sum(0) + mid_np) / (num_warp + 1) if latents is not None \
        else mid_np
    save_debug_grid(os.path.join(img_dir, f"{name}.png"), {
        "gt": gt, "blurry": blurry, "mid": mid_np, "d_alpha": _np(mid.d_alpha)})

    depth = _np(mid.depth)
    pred_n = (normals_from_depth_screen(depth, np.asarray(data.K[view])) + 1) / 2
    gt_depth = np.asarray(data.depths[view])
    decomp = {"pred_normal": pred_n,
              "gt_depth": gt_depth / max(float(gt_depth.max()), 1e-6),
              "depth": depth / max(float(depth.max()), 1e-6)}
    normals = getattr(data, "normals", None)
    if normals is not None:
        decomp = {"gt_normal": (np.asarray(normals[view]) + 1) / 2, **decomp}
    save_debug_grid(os.path.join(img_dir, f"{name}_decomp.png"), decomp)
    return img_dir
