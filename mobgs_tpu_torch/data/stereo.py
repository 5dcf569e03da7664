"""DyBluRF stereo dataset loader (port of ``mobgs_tpu/data/stereo.py``).

Reference: ``scene/dataset_readers.py:1447-1619`` (``readStereoCameras``)
and ``scene/__init__.py:49-78`` (dataset sniffing via ``poses_bounds.npy``).

Directory layout (per scene, e.g. data/stereo/seesaw/dense):
  poses_bounds.npy          LLFF [2V, 17] pose array, interleaved
                            (even rows = blurry train, odd = sharp test)
  scene.json                {"center": [x, y, z]}
  images_512x288/%05d.png   blurry train frames
  inference_images/%05d.png sharp test frames (any size; resized)
  align_uni_depth_noclip/%05d.npy   monocular depth priors
  motion_masks_manual/%05d.png      dynamic masks
  bootstapir/%05d_%05d.npy          TAPIR tracks (query, target)

The scene is read on the host with numpy and PIL, as the JAX package reads
it: the LLFF axis permutation and diag(1,-1,-1,1) flip, the 720→288 focal
rescale, the hard-wired 512x288, the translation by scene.json's centre and
the scaling by the global mean depth, depths divided by the same mean,
time = idx / max_time with max_time = min(V//2 - 1, 23), and the frame-0
tracklet concatenation over all query frames. The blur features come from
the port's ``models/blce.py::blur_feature`` on CPU tensors.
"""

from __future__ import annotations

import json
import os
from typing import NamedTuple

import numpy as np
import torch

from mobgs_tpu_torch.data.synthetic import SceneData


def _sigmoid(x):
    return 1.0 / (1.0 + np.exp(-x))


def parse_tapir_track_info(occlusions: np.ndarray, expected_dist: np.ndarray):
    """Visible/invisible/confidence masks (dataset_readers.py:1421-1434)."""
    visibility = 1.0 - _sigmoid(occlusions)
    confidence = 1.0 - _sigmoid(expected_dist)
    valid_visible = visibility * confidence > 0.5
    valid_invisible = (1.0 - visibility) * confidence > 0.5
    confidence = confidence * (valid_visible | valid_invisible)
    return valid_visible, valid_invisible, confidence


def load_target_tracks(tracks_dir: str, query_index: int,
                       target_indices: list[int], dim: int = 1,
                       scale: float = 1.0) -> np.ndarray:
    """Stack per-(query,target) TAPIR track files (reference :1404-1418)."""
    q = f"{query_index:05d}"
    all_tracks = []
    for ti in target_indices:
        tr = np.load(os.path.join(tracks_dir, f"{q}_{ti:05d}.npy")).astype(np.float32)
        tr[:, :2] = tr[:, :2] / scale
        all_tracks.append(tr)
    return np.stack(all_tracks, axis=dim)


class StereoScene(NamedTuple):
    """Everything the training pipeline needs, host-side numpy."""
    data: SceneData          # train split (+ test poses/images inside)
    tracklet: np.ndarray     # [T, P, 2] frame-0-anchored TAPIR tracks
    track_visibles: np.ndarray  # [T, P]
    normals: np.ndarray      # [V, H, W, 3]
    test_K: np.ndarray | None = None       # [V, 3, 3]
    test_time: np.ndarray | None = None    # [V]
    # per-frame RAFT flow (Nvidia monocular layout only,
    # dataset_readers.py:1714-1724; the stereo reader has none)
    fwd_flow: np.ndarray | None = None       # [V, H, W, 2]
    bwd_flow: np.ndarray | None = None
    fwd_flow_mask: np.ndarray | None = None  # [V, H, W]
    bwd_flow_mask: np.ndarray | None = None


def _imread(path: str) -> np.ndarray:
    from PIL import Image
    return np.asarray(Image.open(path))


def _llff_to_c2w(poses_arr: np.ndarray):
    """LLFF pose block → c2w mats + focal (reference :1452-1469)."""
    poses = poses_arr[:, :15].reshape(-1, 3, 5)
    hwf = poses[0, :, -1]
    final_height = 288
    factor = 720 / final_height
    focal = hwf[-1] / factor
    poses = np.concatenate([poses[..., 1:2], -poses[..., :1], poses[..., 2:4]], -1)
    bottoms = np.tile(np.array([0, 0, 0, 1.0]).reshape(1, 1, 4),
                      (poses.shape[0], 1, 1))
    poses = np.concatenate([poses, bottoms], axis=1)
    poses = poses @ np.diag([1.0, -1.0, -1.0, 1.0])
    return poses[:, :3, :4], float(focal)


def load_stereo_scene(path: str, max_frames: int = 24) -> StereoScene:
    from mobgs_tpu_torch.models.blce import blur_feature

    H, W = 288, 512
    poses_arr = np.load(os.path.join(path, "poses_bounds.npy"))
    with open(os.path.join(path, "scene.json")) as f:
        scene_center = np.asarray(json.load(f)["center"])
    c2ws, focal = _llff_to_c2w(poses_arr)
    max_time = min(c2ws.shape[0] // 2 - 1, max_frames - 1)
    V = max_time + 1
    train_c2ws = c2ws[::2]
    test_c2ws = c2ws[1::2]

    # global mean depth normalizes both depths and camera translations
    depth_list = [np.load(os.path.join(path, "align_uni_depth_noclip",
                                       f"{i:05d}.npy")) for i in range(V)]
    mean_depth = float(np.mean(np.stack(depth_list, 0)))

    K = np.array([[focal, 0, W / 2.0], [0, focal, H / 2.0], [0, 0, 1]],
                 np.float32)

    # TAPIR tracks: every query frame's tracks onto all targets, concat on
    # the point axis, anchored at frame 0 (reference :1486-1505,1566-1569)
    tracks_dir = os.path.join(path, "bootstapir")
    tracklet = None
    track_vis = None
    if os.path.isdir(tracks_dir):
        cat_tracks, cat_vis = [], []
        targets = list(range(V))
        for q in targets:
            tr = load_target_tracks(tracks_dir, q, targets, dim=0)  # [T,P,4]
            vis, _, _ = parse_tapir_track_info(tr[..., 2], tr[..., 3])
            cat_tracks.append(tr)
            cat_vis.append(vis)
        tracklet = np.concatenate(cat_tracks, axis=1)[..., :2]
        track_vis = np.concatenate(cat_vis, axis=1)

    imgs, depths, masks, w2cs, normals = [], [], [], [], []
    blur_feats = []
    for i in range(V):
        img = _imread(os.path.join(path, "images_512x288", f"{i:05d}.png"))
        img = img[..., :3].astype(np.float32) / 255.0
        c2w = np.eye(4, dtype=np.float32)
        c2w[:3, :4] = train_c2ws[i]
        c2w[:3, 3] = (c2w[:3, 3] - scene_center) / mean_depth
        w2c = np.linalg.inv(c2w)

        depth = depth_list[i] / mean_depth
        if depth.ndim == 3:
            depth = depth[..., 0]

        mpath = os.path.join(path, "motion_masks_manual", f"{i:05d}.png")
        if os.path.exists(mpath):
            m = _imread(mpath).astype(np.float32)
            if m.ndim == 3:
                m = m[..., 0]
            mask = (m / max(m.max(), 1.0))
        else:
            mask = np.zeros((H, W), np.float32)

        normals.append(normals_from_depth(depth, K))
        imgs.append(img); depths.append(depth.astype(np.float32))
        masks.append(mask.astype(np.float32)); w2cs.append(w2c)
        blur_feats.append(float(blur_feature(torch.as_tensor(img))))

    test_imgs, test_w2cs = [], []
    for i in range(V):
        p = os.path.join(path, "inference_images", f"{i:05d}.png")
        if os.path.exists(p):
            img = _imread(p)[..., :3]
            if img.shape[:2] != (H, W):
                from PIL import Image
                img = np.asarray(Image.fromarray(img).resize((W, H)))
            test_imgs.append(img.astype(np.float32) / 255.0)
        else:
            test_imgs.append(np.zeros((H, W, 3), np.float32))
        c2w = np.eye(4, dtype=np.float32)
        c2w[:3, :4] = test_c2ws[i]
        c2w[:3, 3] = (c2w[:3, 3] - scene_center) / mean_depth
        test_w2cs.append(np.linalg.inv(c2w))

    times = (np.arange(V) / max_time).astype(np.float32)
    data = SceneData(
        w2c=np.stack(w2cs).astype(np.float32),
        K=np.tile(K[None], (V, 1, 1)),
        time=times, images=np.stack(imgs), depths=np.stack(depths),
        blur_feats=np.asarray(blur_feats, np.float32),
        masks=np.stack(masks), width=W, height=H, max_time=float(max_time),
        test_w2c=np.stack(test_w2cs).astype(np.float32),
        test_images=np.stack(test_imgs),
        test_K=np.tile(K[None], (V, 1, 1)), test_time=times)
    return StereoScene(data=data, tracklet=tracklet,
                       track_visibles=track_vis,
                       normals=np.stack(normals).astype(np.float32),
                       test_K=np.tile(K[None], (V, 1, 1)), test_time=times)


def normals_from_depth(depth: np.ndarray, K: np.ndarray) -> np.ndarray:
    """Normals from unprojected depth gradients (main_utils.py:95-141
    equivalent, numpy): cross products of central differences of the
    camera-space point map, normalized, z-forward sign convention."""
    H, W = depth.shape
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float32)
    z = depth
    x = (xs + 0.5 - K[0, 2]) / K[0, 0] * z
    y = (ys + 0.5 - K[1, 2]) / K[1, 1] * z
    p = np.stack([x, y, z], -1)
    dx = np.gradient(p, axis=1)
    dy = np.gradient(p, axis=0)
    n = np.cross(dx, dy)
    n /= np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-8)
    flip = (n[..., 2:3] > 0)
    return np.where(flip, -n, n).astype(np.float32)


def sniff_dataset_type(path: str) -> str:
    """Dataset sniffing by marker file (scene/__init__.py:49-78)."""
    if os.path.exists(os.path.join(path, "poses_bounds.npy")):
        return "nvidia"  # DyBluRF stereo rides the nvidia branch
    if os.path.exists(os.path.join(path, "transforms_train.json")):
        return "blender"
    if os.path.exists(os.path.join(path, "dataset.json")):
        return "dycheck"
    if os.path.exists(os.path.join(path, "train_meta.json")):
        return "panoptic"  # PanopticSports (scene/__init__.py:74-76)
    if os.path.exists(os.path.join(path, "sparse")):
        return "colmap"
    raise ValueError(f"could not sniff dataset type at {path}")
