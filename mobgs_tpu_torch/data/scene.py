"""Scene orchestrator — dataset sniffing + loader dispatch (port of
``mobgs_tpu/data/scene.py``).

Reference: ``scene/__init__.py:29-147`` (marker-file dataset sniffing,
checkpoint directory layout) and the ``sceneLoadTypeCallbacks`` registry
(``scene/dataset_readers.py:2089-2098``).

``load_scene`` reads every kind of the JAX registry: the DyBluRF stereo
layout and the Nvidia monocular one (``images_2/``) under ``"nvidia"``, the
kind ``poses_bounds.npy`` sniffs as; Blender ``transforms_train.json``
scenes; the dycheck iPhone (``splits/``) and HyperNeRF layouts under
``"dycheck"``; DyNeRF camera videos (``cam00``); COLMAP sparse models; and
PanopticSports captures. All of them are read on the host with numpy and
PIL, as the JAX package reads them; the blur features come from the port's
``models/blce.py::blur_feature`` on CPU tensors.
"""

from __future__ import annotations

import json
import os
from typing import Callable

import numpy as np
import torch

from mobgs_tpu_torch.data.stereo import load_stereo_scene, sniff_dataset_type
from mobgs_tpu_torch.data.synthetic import SceneData


def add_points(points: np.ndarray, colors: np.ndarray, normals: np.ndarray,
               xyz_min: np.ndarray, xyz_max: np.ndarray,
               n_add: int = 100_000, rng: np.random.Generator | None = None):
    """Pad an init point cloud with uniform random points inside a bbox
    (reference ``scene/dataset_readers.py:538-551`` ``add_points`` — library
    code, no caller at the shipped defaults). Colors and normals of the
    padded points are uniform random like the reference's.

    Returns (points, colors, normals) with n_add extra rows.
    """
    rng = rng or np.random.default_rng()
    xyz_min = np.asarray(xyz_min, np.float32)
    xyz_max = np.asarray(xyz_max, np.float32)
    extra = (rng.random((n_add, 3), dtype=np.float32)
             * (xyz_max - xyz_min) + xyz_min)
    return (np.vstack([points, extra]),
            np.vstack([colors, rng.random((n_add, 3), dtype=np.float32)]),
            np.vstack([normals, rng.random((n_add, 3), dtype=np.float32)]))


def load_blender_scene(path: str, white_background: bool = False,
                       half_res: bool = False) -> SceneData:
    """NeRF-synthetic ``transforms_train.json`` loader (reference
    ``readNerfSyntheticInfo`` / ``readCamerasFromTransforms``,
    dataset_readers.py:360-483 lineage)."""
    from PIL import Image

    from mobgs_tpu_torch.models.blce import blur_feature

    def read_split(split):
        with open(os.path.join(path, f"transforms_{split}.json")) as f:
            meta = json.load(f)
        fovx = meta["camera_angle_x"]
        imgs, w2cs, times = [], [], []
        for i, fr in enumerate(meta["frames"]):
            fp = os.path.join(path, fr["file_path"])
            if not os.path.splitext(fp)[1]:
                fp += ".png"
            im = np.asarray(Image.open(fp)).astype(np.float32) / 255.0
            if im.shape[-1] == 4:
                bg = 1.0 if white_background else 0.0
                im = im[..., :3] * im[..., 3:] + bg * (1 - im[..., 3:])
            c2w = np.asarray(fr["transform_matrix"], np.float32)
            # blender → COLMAP convention: flip y, z axes
            c2w[:3, 1:3] *= -1
            imgs.append(im)
            w2cs.append(np.linalg.inv(c2w))
            times.append(fr.get("time", i / max(len(meta["frames"]) - 1, 1)))
        H, W = imgs[0].shape[:2]
        focal = 0.5 * W / np.tan(0.5 * fovx)
        K = np.array([[focal, 0, W / 2], [0, focal, H / 2], [0, 0, 1]],
                     np.float32)
        return (np.stack(imgs), np.stack(w2cs).astype(np.float32),
                np.asarray(times, np.float32), K, W, H)

    imgs, w2cs, times, K, W, H = read_split("train")
    try:
        t_imgs, t_w2cs, _, _, _, _ = read_split("test")
    except FileNotFoundError:
        t_imgs, t_w2cs = imgs, w2cs
    V = len(imgs)
    bf = [float(blur_feature(torch.as_tensor(im))) for im in imgs]
    return SceneData(
        w2c=w2cs, K=np.tile(K[None], (V, 1, 1)), time=times, images=imgs,
        depths=np.ones((V, H, W), np.float32),
        blur_feats=np.asarray(bf, np.float32),
        masks=np.zeros((V, H, W), np.float32), width=W, height=H,
        max_time=float(max(V - 1, 1)), test_w2c=t_w2cs, test_images=t_imgs)


def _load_iphone(path, **kw):
    # dataset.json marks both the Record3D/iPhone layout (splits/ dir)
    # and HyperNeRF (metadata.json); dispatch on the marker files
    if os.path.isdir(os.path.join(path, "splits")):
        from mobgs_tpu_torch.data.iphone import load_iphone_scene
        return load_iphone_scene(path, **kw)
    from mobgs_tpu_torch.data.hypernerf import load_hypernerf_scene
    return load_hypernerf_scene(path, **kw)


def _load_dynerf(path, **kw):
    from mobgs_tpu_torch.data.dynerf import load_dynerf_scene
    return load_dynerf_scene(path, **kw)


def _load_colmap(path, **kw):
    from mobgs_tpu_torch.data.colmap import load_colmap_scene
    return load_colmap_scene(path, **kw)


def _load_panoptic(path, **kw):
    from mobgs_tpu_torch.data.panoptic import load_panoptic_scene
    return load_panoptic_scene(path, **kw)


def _load_nvidia(path, **kw):
    # poses_bounds.npy is shared by the DyBluRF stereo layout
    # (images_512x288/, paired train/test cameras) and the Nvidia
    # MONOCULAR layout (images_2/, fixed-view gt/ split) — reference
    # readNvidiaCameras, dataset_readers.py:1621-1974
    if os.path.isdir(os.path.join(path, "images_2")):
        from mobgs_tpu_torch.data.nvidia import load_nvidia_mono_scene
        return load_nvidia_mono_scene(path).data
    return load_stereo_scene(path).data


SCENE_LOAD_CALLBACKS: dict[str, Callable] = {
    "nvidia": _load_nvidia,
    "stereo": lambda p, **kw: load_stereo_scene(p).data,
    "blender": load_blender_scene,
    "dycheck": _load_iphone,
    "dynerf": _load_dynerf,
    "colmap": _load_colmap,
    "panoptic": _load_panoptic,
}


def load_scene(path: str, kind: str | None = None, **kwargs) -> SceneData:
    if kind is None:
        kind = sniff_dataset_type(path)
        # poses_bounds.npy is shared by the stereo and Neural3D layouts;
        # per-camera video dirs disambiguate DyNeRF
        if kind == "nvidia" and (
                os.path.isdir(os.path.join(path, "cam00"))
                or os.path.exists(os.path.join(path, "cam00.mp4"))):
            kind = "dynerf"
    if kind not in SCENE_LOAD_CALLBACKS:
        raise NotImplementedError(f"dataset type {kind} at {path}")
    return SCENE_LOAD_CALLBACKS[kind](path, **kwargs)


def checkpoint_dir(model_path: str, iteration) -> str:
    """Reference layout: <model>/point_cloud/iteration_<k>/ (scene/__init__.py:116)."""
    return os.path.join(model_path, "point_cloud", f"iteration_{iteration}")


def find_latest_iteration(model_path: str) -> str | None:
    root = os.path.join(model_path, "point_cloud")
    if not os.path.isdir(root):
        return None
    its = [d.split("_", 1)[1] for d in os.listdir(root)
           if d.startswith("iteration_")]
    nums = [i for i in its if i.isdigit()]
    if nums:
        return max(nums, key=int)
    return its[0] if its else None
