"""COLMAP binary/text model parsing and the static-scene loader (port of
``mobgs_tpu/data/colmap.py``).

Reference: ``scene/colmap_loader.py`` (the cameras.bin / images.bin /
points3D.bin readers used by the Colmap branch of
``sceneLoadTypeCallbacks``). Standard COLMAP file formats. Host-side numpy
and PIL, as the JAX package reads them; the blur features come from the
port's ``models/blce.py::blur_feature`` on CPU tensors.
"""

from __future__ import annotations

import os
import struct
from typing import NamedTuple

import numpy as np
import torch

CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3), 1: ("PINHOLE", 4),
    2: ("SIMPLE_RADIAL", 4), 3: ("RADIAL", 5),
    4: ("OPENCV", 8), 5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12), 7: ("FOV", 5),
    8: ("SIMPLE_RADIAL_FISHEYE", 4), 9: ("RADIAL_FISHEYE", 5),
    10: ("THIN_PRISM_FISHEYE", 12),
}


class ColmapCamera(NamedTuple):
    id: int
    model: str
    width: int
    height: int
    params: np.ndarray


class ColmapImage(NamedTuple):
    id: int
    qvec: np.ndarray   # wxyz, world→camera rotation
    tvec: np.ndarray   # world→camera translation
    camera_id: int
    name: str


def _read(f, fmt):
    return struct.unpack(fmt, f.read(struct.calcsize(fmt)))


def read_cameras_binary(path: str) -> dict[int, ColmapCamera]:
    out = {}
    with open(path, "rb") as f:
        n = _read(f, "<Q")[0]
        for _ in range(n):
            cid, model_id, w, h = _read(f, "<iiQQ")
            name, nparams = CAMERA_MODELS[model_id]
            params = np.asarray(_read(f, "<" + "d" * nparams))
            out[cid] = ColmapCamera(cid, name, int(w), int(h), params)
    return out


def read_images_binary(path: str) -> dict[int, ColmapImage]:
    out = {}
    with open(path, "rb") as f:
        n = _read(f, "<Q")[0]
        for _ in range(n):
            iid = _read(f, "<i")[0]
            q = np.asarray(_read(f, "<dddd"))
            t = np.asarray(_read(f, "<ddd"))
            cam_id = _read(f, "<i")[0]
            name = b""
            while True:
                c = f.read(1)
                if c == b"\x00":
                    break
                name += c
            npts = _read(f, "<Q")[0]
            f.read(24 * npts)  # skip 2D points
            out[iid] = ColmapImage(iid, q, t, cam_id, name.decode())
    return out


def read_points3d_binary(path: str):
    """Returns (xyz [N,3], rgb [N,3] float in [0,1], err [N])."""
    with open(path, "rb") as f:
        n = _read(f, "<Q")[0]
        xyz = np.empty((n, 3))
        rgb = np.empty((n, 3))
        err = np.empty(n)
        for i in range(n):
            _read(f, "<Q")  # id
            xyz[i] = _read(f, "<ddd")
            rgb[i] = _read(f, "<BBB")
            err[i] = _read(f, "<d")[0]
            track_len = _read(f, "<Q")[0]
            f.read(8 * track_len)
    return xyz.astype(np.float32), (rgb / 255.0).astype(np.float32), err


def read_points3d_text(path: str):
    xyz, rgb = [], []
    with open(path) as f:
        for line in f:
            if line.startswith("#") or not line.strip():
                continue
            el = line.split()
            xyz.append([float(x) for x in el[1:4]])
            rgb.append([float(x) / 255.0 for x in el[4:7]])
    return (np.asarray(xyz, np.float32), np.asarray(rgb, np.float32),
            np.zeros(len(xyz)))


def qvec_to_rotmat(q: np.ndarray) -> np.ndarray:
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])


def read_cameras_text(path: str) -> dict[int, ColmapCamera]:
    out = {}
    with open(path) as f:
        for line in f:
            if line.startswith("#") or not line.strip():
                continue
            el = line.split()
            cid, model, w, h = int(el[0]), el[1], int(el[2]), int(el[3])
            out[cid] = ColmapCamera(cid, model, w, h,
                                    np.asarray([float(x) for x in el[4:]]))
    return out


def read_images_text(path: str) -> dict[int, ColmapImage]:
    out = {}
    with open(path) as f:
        lines = [ln for ln in f if not ln.startswith("#") and ln.strip()]
    for ln in lines[::2]:  # every other line is the 2D point list
        el = ln.split()
        out[int(el[0])] = ColmapImage(
            int(el[0]), np.asarray([float(x) for x in el[1:5]]),
            np.asarray([float(x) for x in el[5:8]]), int(el[8]), el[9])
    return out


def load_colmap_model(sparse_dir: str):
    """Load a COLMAP sparse model dir; returns (cameras, images, points).
    Binary model preferred, text fallback (reference
    `readColmapSceneInfo`, dataset_readers.py:262-271)."""
    cb = os.path.join(sparse_dir, "cameras.bin")
    if os.path.exists(cb):
        cams = read_cameras_binary(cb)
        imgs = read_images_binary(os.path.join(sparse_dir, "images.bin"))
    else:
        cams = read_cameras_text(os.path.join(sparse_dir, "cameras.txt"))
        imgs = read_images_text(os.path.join(sparse_dir, "images.txt"))
    p3d = os.path.join(sparse_dir, "points3D.bin")
    if os.path.exists(p3d):
        pts = read_points3d_binary(p3d)
    else:
        pts = read_points3d_text(os.path.join(sparse_dir, "points3D.txt"))
    return cams, imgs, pts


def _intrinsics(cam: ColmapCamera) -> np.ndarray:
    p = cam.params
    if cam.model == "SIMPLE_PINHOLE" or cam.model.startswith("SIMPLE_RADIAL"):
        fx = fy = p[0]
        cx, cy = p[1], p[2]
    else:  # PINHOLE / OPENCV families: fx fy cx cy ...
        fx, fy, cx, cy = p[0], p[1], p[2], p[3]
    return np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float32)


def load_colmap_scene(path: str, images: str | None = None,
                      eval_split: bool = True, llffhold: int = 8):
    """COLMAP static scene → SceneData (the `sceneLoadTypeCallbacks
    ["Colmap"]` branch, reference dataset_readers.py:261-310): sorted by
    image name; with ``eval_split`` every ``llffhold``-th camera is held
    out for test; points3D seeds the Gaussian cloud."""
    from PIL import Image

    from mobgs_tpu_torch.data.synthetic import SceneData
    from mobgs_tpu_torch.models.blce import blur_feature

    sparse = os.path.join(path, "sparse", "0")
    if not os.path.isdir(sparse):
        sparse = os.path.join(path, "sparse")
    cams, imgs, (xyz, rgb, _) = load_colmap_model(sparse)
    img_dir = os.path.join(path, images if images else "images")

    entries = sorted(imgs.values(), key=lambda im: im.name)
    w2cs, Ks, frames = [], [], []
    for im in entries:
        w2c = np.eye(4, dtype=np.float32)
        w2c[:3, :3] = qvec_to_rotmat(im.qvec)
        w2c[:3, 3] = im.tvec
        cam = cams[im.camera_id]
        K = _intrinsics(cam)
        fp = os.path.join(img_dir, im.name)
        frame = np.asarray(Image.open(fp)).astype(np.float32)[..., :3] / 255.0
        H, W = frame.shape[:2]
        # rescale intrinsics if the images dir holds downscaled copies
        if (W, H) != (cam.width, cam.height):
            K = K.copy()
            K[0] *= W / cam.width
            K[1] *= H / cam.height
        w2cs.append(w2c)
        Ks.append(K)
        frames.append(frame)

    w2cs = np.stack(w2cs)
    Ks = np.stack(Ks)
    frames = np.stack(frames)
    V, H, W = frames.shape[:3]
    if eval_split and V > llffhold:
        test = np.arange(V) % llffhold == 0
    else:
        test = np.zeros(V, bool)
    tr = ~test

    bf = np.asarray([float(blur_feature(torch.as_tensor(f)))
                     for f in frames[tr]], np.float32)

    return SceneData(
        w2c=w2cs[tr], K=Ks[tr], time=np.zeros(int(tr.sum()), np.float32),
        images=frames[tr], depths=np.ones((int(tr.sum()), H, W), np.float32),
        blur_feats=bf, masks=np.zeros((int(tr.sum()), H, W), np.float32),
        width=W, height=H, max_time=1.0,
        test_w2c=w2cs[test] if test.any() else w2cs[tr],
        test_images=frames[test] if test.any() else frames[tr],
        points_xyz=xyz, points_rgb=rgb)
