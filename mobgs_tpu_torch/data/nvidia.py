"""Nvidia Dynamic Scenes MONOCULAR loader (port of
``mobgs_tpu/data/nvidia.py``).

Reference: reference `scene/dataset_readers.py:1621-1974`
(`readNvidiaCameras`, registered as the "nvidia" dataset at :2097) —
the non-stereo Nvidia layout: one camera per timestep from
`poses_bounds.npy` at load factor 2, per-frame RAFT flow npz, aligned
UniDepth depths (`align_uni_depth_noclip/%03d.npy`) whose GLOBAL mean
normalizes both depths and camera translations, instance masks unioned
into the motion mask, a `forward_tracks_dynamic.npy` tracklet, and a
fixed-viewpoint test split `gt/v000_t%03d.png` rendered from camera 0.

Differences kept deliberately:
- normals are recomputed from depth + 5x5 average pooling when the
  `uni_normal` cache is absent (reference :1797-1807 caches to disk; we
  only read the cache, never write into the dataset).
- the reference's commented-out code paths (depthcrafter, TAPIR target
  tracks, per-instance depth rescaling) are dead there and omitted.
- test-split poses are normalized ONCE from the raw camera-0 pose. The
  reference mutates `c2ws[0]` in place inside the per-test-frame loop
  (dataset_readers.py:1947-1951), re-subtracting scene_center and
  re-dividing by mean_depth cumulatively — an upstream bug, so
  reference test cameras after frame 0 will NOT match this loader's.

Host-side numpy and PIL, as the JAX package reads the scene; the blur
features come from the port's ``models/blce.py::blur_feature`` on CPU
tensors.
"""

from __future__ import annotations

import glob
import json
import os

import numpy as np
import torch

from mobgs_tpu_torch.data.stereo import StereoScene, _imread, normals_from_depth
from mobgs_tpu_torch.data.synthetic import SceneData


def _load_json(path):
    with open(path) as f:
        return json.load(f)


def _read_flow(flow_path: str, out_hw) -> tuple[np.ndarray, np.ndarray]:
    """reference :1383-1402: normalize flow by its OWN resolution, then
    nearest-resize flow and mask to the target (H, W)."""
    from PIL import Image
    info = np.load(flow_path)
    flow = info["flow"].astype(np.float32)
    mask = info["mask"].astype(np.float32)
    H, W = flow.shape[:2]
    flow[..., 0] /= W
    flow[..., 1] /= H
    oh, ow = int(out_hw[0]), int(out_hw[1])

    def nearest(a):
        if a.shape[:2] == (oh, ow):
            return a
        iy = (np.arange(oh) * (a.shape[0] / oh)).astype(np.int64)
        ix = (np.arange(ow) * (a.shape[1] / ow)).astype(np.int64)
        return a[iy][:, ix]

    return nearest(flow), nearest(mask)


def _avg_pool_5x5(x: np.ndarray) -> np.ndarray:
    """torch F.avg_pool2d(k=5, stride=1, padding=2) with zero padding
    (reference :1810): the window average counts the k*k ZERO-padded
    taps near borders, exactly as torch's count_include_pad default."""
    H, W, C = x.shape
    pad = np.zeros((H + 4, W + 4, C), x.dtype)
    pad[2:-2, 2:-2] = x
    c = np.cumsum(np.cumsum(pad, axis=0), axis=1)
    c = np.pad(c, ((1, 0), (1, 0), (0, 0)))
    s = (c[5:, 5:] - c[:-5, 5:] - c[5:, :-5] + c[:-5, :-5])
    return (s / 25.0).astype(x.dtype)


def load_nvidia_mono_scene(path: str) -> StereoScene:
    poses_arr = np.load(os.path.join(path, "poses_bounds.npy"))
    scene_center = np.asarray(
        _load_json(os.path.join(path, "scene.json"))["center"])

    # LLFF block at load factor 2 (reference :1627-1651; the stereo
    # variant's helper bakes the 720->288 factor, so inline the math)
    poses = poses_arr[:, :15].reshape(-1, 3, 5)
    hwf = poses[0, :, -1]
    sh = hwf[:2] / 2.0
    focal = float(hwf[-1] / 2.0)
    H, W = int(sh[0]), int(sh[1])
    max_time = poses.shape[0] - 1
    V = max_time + 1
    poses = np.concatenate([poses[..., 1:2], -poses[..., :1],
                            poses[..., 2:4]], -1)
    bottoms = np.tile(np.array([0, 0, 0, 1.0]).reshape(1, 1, 4), (V, 1, 1))
    poses = np.concatenate([poses, bottoms], axis=1)
    poses = poses @ np.diag([1.0, -1.0, -1.0, 1.0])
    c2ws = poses[:, :3, :4]

    depth_list = [np.load(os.path.join(path, "align_uni_depth_noclip",
                                       f"{i:03d}.npy")) for i in range(V)]
    mean_depth = float(np.mean(np.stack(depth_list, 0)))
    K = np.array([[focal, 0, W / 2.0], [0, focal, H / 2.0], [0, 0, 1]],
                 np.float32)

    from mobgs_tpu_torch.models.blce import blur_feature

    imgs, depths, masks, w2cs, normals, blur_feats = [], [], [], [], [], []
    fwd_flows, bwd_flows, fwd_masks, bwd_masks = [], [], [], []
    for i in range(V):
        img = _imread(os.path.join(path, "images_2", f"{i:03d}.png"))
        img = img[..., :3].astype(np.float32) / 255.0

        # endpoint frames zero the missing flow direction (:1716-1724)
        fpath = os.path.join(path, "flow", f"{i:03d}_fwd.npz")
        bpath = os.path.join(path, "flow", f"{i:03d}_bwd.npz")
        if i == 0:
            ff, fm = _read_flow(fpath, sh)
            bf_, bm = np.zeros_like(ff), np.zeros_like(fm)
        elif i == max_time:
            bf_, bm = _read_flow(bpath, sh)
            ff, fm = np.zeros_like(bf_), np.zeros_like(bm)
        else:
            ff, fm = _read_flow(fpath, sh)
            bf_, bm = _read_flow(bpath, sh)
        fwd_flows.append(ff); fwd_masks.append(fm)
        bwd_flows.append(bf_); bwd_masks.append(bm)

        c2w = np.eye(4, dtype=np.float32)
        c2w[:3, :4] = c2ws[i]
        c2w[:3, 3] = (c2w[:3, 3] - scene_center) / mean_depth
        w2cs.append(np.linalg.inv(c2w))

        depth = depth_list[i] / mean_depth
        if depth.ndim == 3:
            depth = depth[..., 0]
        depths.append(depth.astype(np.float32))

        npath = os.path.join(path, "uni_normal", f"{i:03d}.npy")
        if os.path.exists(npath):
            normal = np.load(npath)
        else:
            normal = normals_from_depth(depth, K)
        normals.append(_avg_pool_5x5(normal.astype(np.float32)))

        # instance masks union into the motion mask (:1881-1890); each
        # mask is nearest-resized to (H, W) first — the reference
        # resizes via PILtoTorch (:1881-1886), and raw-resolution masks
        # would otherwise fail the union broadcast
        inst = sorted(glob.glob(os.path.join(path, "instance_mask_manual",
                                             f"{i:03d}", "*.png")))
        m = np.zeros((H, W), np.float32)
        for mp in inst:
            a = _imread(mp).astype(np.float32)
            if a.ndim == 3:
                a = a[..., 0]
            if a.shape != (H, W):
                iy = (np.arange(H) * (a.shape[0] / H)).astype(np.int64)
                ix = (np.arange(W) * (a.shape[1] / W)).astype(np.int64)
                a = a[iy][:, ix]
            m = np.maximum(m, (a > 0).astype(np.float32))
        masks.append(m)

        imgs.append(img)
        blur_feats.append(float(blur_feature(torch.as_tensor(img))))

    # fixed-viewpoint test split: every timestep from camera 0 (:1941+)
    test_imgs, test_w2cs, test_times = [], [], []
    c2w0 = np.eye(4, dtype=np.float32)
    c2w0[:3, :4] = c2ws[0]
    c2w0[:3, 3] = (c2w0[:3, 3] - scene_center) / mean_depth
    w2c0 = np.linalg.inv(c2w0)
    for i in range(V):
        p = os.path.join(path, "gt", f"v000_t{i:03d}.png")
        if os.path.exists(p):
            test_imgs.append(
                _imread(p)[..., :3].astype(np.float32) / 255.0)
            test_w2cs.append(w2c0)
            test_times.append(float(i))
    if not test_imgs:
        test_imgs = [imgs[0]]
        test_w2cs = [w2c0]
        test_times = [0.0]

    tracklet = None
    tpath = os.path.join(path, "forward_tracks_dynamic.npy")
    if os.path.exists(tpath):
        tracklet = np.load(tpath)

    times = np.arange(V, dtype=np.float32)
    data = SceneData(
        w2c=np.stack(w2cs).astype(np.float32),
        K=np.tile(K[None], (V, 1, 1)),
        time=times,
        images=np.stack(imgs),
        depths=np.stack(depths),
        blur_feats=np.asarray(blur_feats, np.float32),
        masks=np.stack(masks),
        width=W, height=H, max_time=float(max(max_time, 1)),
        test_w2c=np.stack(test_w2cs).astype(np.float32),
        test_images=np.stack(test_imgs),
        test_K=np.tile(K[None], (len(test_w2cs), 1, 1)),
        test_time=np.asarray(test_times, np.float32))
    return StereoScene(
        data=data, tracklet=tracklet, track_visibles=None,
        normals=np.stack(normals).astype(np.float32),
        fwd_flow=np.stack(fwd_flows), bwd_flow=np.stack(bwd_flows),
        fwd_flow_mask=np.stack(fwd_masks), bwd_flow_mask=np.stack(bwd_masks))
