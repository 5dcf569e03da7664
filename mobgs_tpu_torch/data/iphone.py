"""dycheck/iPhone (Record3D) dataset loader (port of
``mobgs_tpu/data/iphone.py``).

Reference: ``readIphoneCameras_record3D`` (dataset_readers.py:841-1375):
scene.json (scale/center), splits/{train,val}.json (time_ids + camera_ids),
per-frame camera/<cam>_<time>.json dycheck cameras, rgb/2x/ images,
depth/2x/ npy priors, bootstapir/cam0 TAPIR tracks. Frame naming is
"{camera_id}_{time_id:05d}". Depths and camera translations are normalized
by the global mean depth like the stereo path.

Host-side numpy and PIL, as the JAX package reads the scene; the blur
features come from the port's ``models/blce.py::blur_feature`` on CPU
tensors.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from mobgs_tpu_torch.data.dycheck_camera import DycheckCamera
from mobgs_tpu_torch.data.stereo import load_target_tracks, parse_tapir_track_info
from mobgs_tpu_torch.data.synthetic import SceneData


def _load_json(path):
    with open(path) as f:
        return json.load(f)


def load_iphone_scene(path: str, scene_factor: int = 2) -> SceneData:
    from PIL import Image

    from mobgs_tpu_torch.models.blce import blur_feature

    scene_json = _load_json(os.path.join(path, "scene.json"))
    coord_scale = float(np.asarray(scene_json["scale"], np.float32))
    train_split = _load_json(os.path.join(path, "splits", "train.json"))
    try:
        test_split = _load_json(os.path.join(path, "splits", "val.json"))
    except FileNotFoundError:
        test_split = train_split

    def frames(split):
        return list(zip(np.asarray(split["time_ids"], np.int64),
                        np.asarray(split["camera_ids"], np.int64)))

    train_frames = frames(train_split)
    max_time = max(t for t, _ in train_frames)

    def frame_name(cam_id, time_id):
        return f"{cam_id}_{time_id:05d}"

    # global mean depth for normalization
    depths = []
    for t, c in train_frames:
        dp = os.path.join(path, "depth", f"{scene_factor}x",
                          frame_name(c, t) + ".npy")
        depths.append(np.load(dp) * coord_scale)
    mean_depth = float(np.mean(np.stack(depths)))

    imgs, w2cs, Ks, times, masks, out_depths = [], [], [], [], [], []
    blur_feats = []
    W = H = None
    for i, (t, c) in enumerate(train_frames):
        name = frame_name(c, t)
        cam = DycheckCamera.from_json(
            _load_json(os.path.join(path, "camera", name + ".json")))
        cam = cam.rescale(scene_factor)
        img = np.asarray(Image.open(
            os.path.join(path, "rgb", f"{scene_factor}x", name + ".png")))
        img = img[..., :3].astype(np.float32) / 255.0
        H, W = img.shape[:2]
        w2c = cam.extrin
        w2c[:3, 3] = w2c[:3, 3] * coord_scale / mean_depth
        depth = (depths[i] / mean_depth).astype(np.float32)
        if depth.ndim == 3:
            depth = depth[..., 0]

        mpath = os.path.join(path, "motion_masks", name + ".png")
        if os.path.exists(mpath):
            m = np.asarray(Image.open(mpath)).astype(np.float32)
            mask = (m[..., 0] if m.ndim == 3 else m) / max(m.max(), 1.0)
        else:
            mask = np.zeros((H, W), np.float32)

        imgs.append(img); w2cs.append(w2c); Ks.append(cam.intrin)
        times.append(t / max(max_time, 1)); masks.append(mask)
        out_depths.append(depth)
        blur_feats.append(float(blur_feature(torch.as_tensor(img))))

    test_imgs, test_w2cs = [], []
    for t, c in frames(test_split):
        name = frame_name(c, t)
        p = os.path.join(path, "rgb", f"{scene_factor}x", name + ".png")
        cam = DycheckCamera.from_json(
            _load_json(os.path.join(path, "camera", name + ".json"))
        ).rescale(scene_factor)
        w2c = cam.extrin
        w2c[:3, 3] = w2c[:3, 3] * coord_scale / mean_depth
        if os.path.exists(p):
            img = np.asarray(Image.open(p))[..., :3].astype(np.float32) / 255
        else:
            img = np.zeros((H, W, 3), np.float32)
        test_imgs.append(img)
        test_w2cs.append(w2c)

    return SceneData(
        w2c=np.stack(w2cs).astype(np.float32),
        K=np.stack(Ks).astype(np.float32),
        time=np.asarray(times, np.float32),
        images=np.stack(imgs), depths=np.stack(out_depths),
        blur_feats=np.asarray(blur_feats, np.float32),
        masks=np.stack(masks), width=W, height=H,
        max_time=float(max_time),
        test_w2c=np.stack(test_w2cs).astype(np.float32),
        test_images=np.stack(test_imgs))


def load_iphone_tracks(path: str, num_frames: int, stride: int = 5):
    """TAPIR tracks for the iPhone layout (bootstapir/cam0, every 5th
    point like the reference :885)."""
    tracks_dir = os.path.join(path, "bootstapir", "cam0")
    if not os.path.isdir(tracks_dir):
        return None, None
    cat_t, cat_v = [], []
    targets = list(range(num_frames))
    for q in targets:
        tr = load_target_tracks(tracks_dir, q, targets, dim=0)[:, ::stride]
        vis, _, _ = parse_tapir_track_info(tr[..., 2], tr[..., 3])
        cat_t.append(tr)
        cat_v.append(vis)
    return (np.concatenate(cat_t, axis=1)[..., :2],
            np.concatenate(cat_v, axis=1))
