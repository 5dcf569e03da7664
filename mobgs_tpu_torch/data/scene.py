"""Scene orchestrator — dataset sniffing + loader dispatch (port of the
DyBluRF part of ``mobgs_tpu/data/scene.py``).

Reference: ``scene/__init__.py:29-147`` (marker-file dataset sniffing,
checkpoint directory layout) and the ``sceneLoadTypeCallbacks`` registry
(``scene/dataset_readers.py:2089-2098``).

The port loads the DyBluRF stereo layout, under ``"stereo"`` and under
``"nvidia"`` (the kind ``poses_bounds.npy`` sniffs as). The Nvidia
monocular layout (``images_2/``) and the other kinds of the JAX registry
(blender, dycheck, dynerf, colmap, panoptic) raise NotImplementedError until
their loaders are ported (ROADMAP A.5).
"""

from __future__ import annotations

import os
from typing import Callable

import numpy as np

from mobgs_tpu_torch.data.stereo import load_stereo_scene, sniff_dataset_type
from mobgs_tpu_torch.data.synthetic import SceneData

# kinds of the JAX package's registry whose loaders the port has not yet
_NOT_PORTED = ("blender", "dycheck", "dynerf", "colmap", "panoptic")


def _not_ported(what: str, path: str):
    raise NotImplementedError(
        f"{what} at {path}: its loader is not ported yet (ROADMAP A.5, the "
        "remaining loaders); the port loads the DyBluRF stereo layout")


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


def _load_nvidia(path, **kw):
    # poses_bounds.npy is shared by the DyBluRF stereo layout
    # (images_512x288/, paired train/test cameras) and the Nvidia
    # MONOCULAR layout (images_2/, fixed-view gt/ split) — reference
    # readNvidiaCameras, dataset_readers.py:1621-1974
    if os.path.isdir(os.path.join(path, "images_2")):
        _not_ported("the Nvidia monocular layout (images_2/)", path)
    return load_stereo_scene(path).data


SCENE_LOAD_CALLBACKS: dict[str, Callable] = {
    "nvidia": _load_nvidia,
    "stereo": lambda p, **kw: load_stereo_scene(p).data,
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
    if kind in _NOT_PORTED:
        _not_ported(f"dataset type {kind}", path)
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
