"""HyperNeRF dataset loader (port of ``mobgs_tpu/data/hypernerf.py``).

Reference: ``scene/hyper_loader.py::Load_hyper_data``: dataset.json
(ids/train_ids/val_ids, or the every-4th-frame split when val_ids is
empty), metadata.json (warp_id → normalized time, camera_id), per-frame
dycheck camera json, ``rgb/{1/ratio}x/`` images and optional
``depth/{1/ratio}x/`` priors, scene.json near/far/scale/center.

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
from mobgs_tpu_torch.data.synthetic import SceneData


def load_hypernerf_scene(path: str, ratio: float = 0.5) -> SceneData:
    from PIL import Image

    from mobgs_tpu_torch.models.blce import blur_feature

    with open(os.path.join(path, "scene.json")) as f:
        scene_json = json.load(f)
    with open(os.path.join(path, "metadata.json")) as f:
        meta = json.load(f)
    with open(os.path.join(path, "dataset.json")) as f:
        ds = json.load(f)

    all_ids = ds["ids"]
    val_ids = ds.get("val_ids", [])
    if len(val_ids) == 0:
        i_train = np.array([i for i in range(len(all_ids)) if i % 4 == 0])
        i_test = (i_train + 2)[:-1]
    else:
        train_ids = ds["train_ids"]
        i_train = [i for i, x in enumerate(all_ids) if x in train_ids]
        i_test = [i for i, x in enumerate(all_ids) if x in val_ids]

    warp_ids = [meta[x]["warp_id"] for x in all_ids]
    max_warp = max(warp_ids)
    times = np.asarray([w / max(max_warp, 1) for w in warp_ids], np.float32)

    scale_dir = f"{int(1 / ratio)}x"
    coord_scale = float(scene_json.get("scale", 1.0))

    def load_frame(i):
        fid = all_ids[i]
        with open(os.path.join(path, "camera", fid + ".json")) as f:
            cam = DycheckCamera.from_json(json.load(f))
        cam = cam.rescale(1.0 / ratio)
        img = np.asarray(Image.open(
            os.path.join(path, "rgb", scale_dir, fid + ".png")))
        img = img[..., :3].astype(np.float32) / 255.0
        w2c = cam.extrin
        w2c[:3, 3] *= coord_scale
        dpath = os.path.join(path, "depth", scale_dir, fid + ".npy")
        depth = (np.load(dpath).astype(np.float32)
                 if os.path.exists(dpath) else None)
        return img, w2c.astype(np.float32), cam.intrin, depth

    imgs, w2cs, Ks, depths = [], [], [], []
    for i in i_train:
        img, w2c, K, dep = load_frame(i)
        imgs.append(img); w2cs.append(w2c); Ks.append(K)
        H, W = img.shape[:2]
        depths.append(dep if dep is not None else np.ones((H, W), np.float32))
    test_imgs, test_w2cs = [], []
    for i in i_test:
        img, w2c, _, _ = load_frame(i)
        test_imgs.append(img); test_w2cs.append(w2c)

    H, W = imgs[0].shape[:2]
    bf = np.asarray([float(blur_feature(torch.as_tensor(im))) for im in imgs],
                    np.float32)

    return SceneData(
        w2c=np.stack(w2cs), K=np.stack(Ks).astype(np.float32),
        time=times[np.asarray(i_train)],
        images=np.stack(imgs), depths=np.stack(depths),
        blur_feats=bf,
        masks=np.zeros((len(imgs), H, W), np.float32),
        width=W, height=H, max_time=float(max_warp),
        test_w2c=np.stack(test_w2cs), test_images=np.stack(test_imgs))
