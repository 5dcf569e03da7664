"""PanopticSports (CMU Panoptic / Dynamic3DGS export) loader (port of
``mobgs_tpu/data/panoptic.py``).

Reference: ``readPanopticmeta`` / ``readPanopticSportsinfos``
(``scene/dataset_readers.py:648-714``): ``train_meta.json`` /
``test_meta.json`` hold per-frame lists of per-camera intrinsics ``k``,
extrinsics ``w2c``, filenames ``fn`` (under ``ims/``), and ``cam_id``;
``time = frame / n_frames``; scene radius = 1.1 x max camera-center spread
of frame 0; the seed cloud comes from ``init_pt_cld.npz["data"]`` (xyz ‖
rgb columns).

Every (frame, camera) pair becomes one SceneData view row with its own K
and w2c, so several views share one timestamp. Host-side numpy and PIL;
the blur features come from the port's ``models/blce.py::blur_feature``.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from mobgs_tpu_torch.data.synthetic import SceneData


def _read_meta(datadir: str, json_name: str, max_views_per_frame: int = 0):
    with open(os.path.join(datadir, json_name)) as f:
        meta = json.load(f)
    w, h = int(meta["w"]), int(meta["h"])
    n_frames = len(meta["fn"])
    imgs, w2cs, Ks, times = [], [], [], []
    from PIL import Image

    for index in range(n_frames):
        t = index / n_frames
        rows = zip(meta["k"][index], meta["w2c"][index], meta["fn"][index])
        for ci, (k, w2c, fn) in enumerate(rows):
            if max_views_per_frame and ci >= max_views_per_frame:
                break
            im = np.asarray(Image.open(os.path.join(datadir, "ims", fn))
                            .convert("RGB"), np.float32) / 255.0
            imgs.append(im)
            Ks.append(np.asarray(k, np.float32))
            w2cs.append(np.asarray(w2c, np.float32))
            times.append(t)

    # scene radius from frame-0 camera centers (dataset_readers.py:679-680)
    c2w0 = np.linalg.inv(np.asarray(meta["w2c"][0], np.float32))
    centers = c2w0[:, :3, 3]
    radius = float(1.1 * np.max(np.linalg.norm(
        centers - centers.mean(0)[None], axis=-1)))
    return (np.stack(imgs), np.stack(w2cs), np.stack(Ks),
            np.asarray(times, np.float32), w, h, n_frames, radius)


def load_panoptic_scene(path: str, max_views_per_frame: int = 0,
                        **_unused) -> SceneData:
    """Load a PanopticSports capture dir into SceneData. A sharp multi-view
    capture: blur features ~0 and unit depth priors."""
    from mobgs_tpu_torch.models.blce import blur_feature

    (imgs, w2cs, Ks, times, w, h, n_frames,
     radius) = _read_meta(path, "train_meta.json", max_views_per_frame)
    try:
        t_imgs, t_w2cs, _, _, _, _, _, _ = _read_meta(
            path, "test_meta.json", max_views_per_frame)
    except FileNotFoundError:
        t_imgs, t_w2cs = imgs, w2cs

    pc = np.load(os.path.join(path, "init_pt_cld.npz"))["data"]
    V = len(imgs)
    bf = np.asarray([float(blur_feature(torch.as_tensor(im))) for im in imgs],
                    np.float32)

    return SceneData(
        w2c=w2cs, K=Ks, time=times, images=imgs,
        depths=np.ones((V, h, w), np.float32),
        blur_feats=bf,
        masks=np.zeros((V, h, w), np.float32),
        width=w, height=h, max_time=1.0,
        test_w2c=t_w2cs, test_images=t_imgs,
        points_xyz=pc[:, :3].astype(np.float32),
        points_rgb=pc[:, 3:6].astype(np.float32),
        extent=radius)
