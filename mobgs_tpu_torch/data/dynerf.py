"""Neural3D / DyNeRF multi-camera video dataset loader (port of
``mobgs_tpu/data/dynerf.py``).

Reference: ``scene/neural_3D_dataset_NDC.py`` + ``readdynerfInfo``
(dataset_readers.py:553-683 lineage): LLFF ``poses_bounds.npy`` with one
row per camera, per-camera videos (``cam00.mp4``, ...) or pre-extracted
frame dirs (``cam00/images/*.png``), camera 0 held out as the test view,
time = frame / (frames - 1). Videos are read through ``cv2``, imported
only when a camera has no frame directory.

Host-side numpy and PIL; the blur features come from the port's
``models/blce.py::blur_feature`` on CPU tensors.
"""

from __future__ import annotations

import glob
import os

import numpy as np
import torch

from mobgs_tpu_torch.data.stereo import _llff_to_c2w
from mobgs_tpu_torch.data.synthetic import SceneData


def _frames_for_cam(path: str, cam: str, max_frames: int,
                    downscale: int) -> np.ndarray:
    """Frames [T, H, W, 3] float in [0,1] from a frame dir or video."""
    from PIL import Image
    fdir = os.path.join(path, cam, "images")
    if os.path.isdir(fdir):
        files = sorted(glob.glob(os.path.join(fdir, "*.png")))[:max_frames]
        frames = [np.asarray(Image.open(f))[..., :3] for f in files]
    else:
        import cv2
        cap = cv2.VideoCapture(os.path.join(path, cam + ".mp4"))
        frames = []
        while len(frames) < max_frames:
            ok, frame = cap.read()
            if not ok:
                break
            frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
        cap.release()
    out = []
    for fr in frames:
        if downscale > 1:
            fr = np.asarray(Image.fromarray(fr).resize(
                (fr.shape[1] // downscale, fr.shape[0] // downscale)))
        out.append(fr.astype(np.float32) / 255.0)
    return np.stack(out)


def load_dynerf_scene(path: str, max_frames: int = 50,
                      downscale: int = 2, test_cam: int = 0) -> SceneData:
    from mobgs_tpu_torch.models.blce import blur_feature

    poses_arr = np.load(os.path.join(path, "poses_bounds.npy"))
    # _llff_to_c2w's focal rescale is stereo-288p-specific; take the raw
    # LLFF focal and divide by this loader's downscale instead
    c2ws, _ = _llff_to_c2w(poses_arr)
    hwf = poses_arr[:, :15].reshape(-1, 3, 5)[0, :, -1]
    focal = float(hwf[-1]) / downscale

    cams = sorted(d for d in os.listdir(path)
                  if d.startswith("cam") and
                  (os.path.isdir(os.path.join(path, d))
                   or d.endswith(".mp4")))
    cams = [c.replace(".mp4", "") for c in cams]
    cams = sorted(set(cams))
    assert len(cams) == c2ws.shape[0], \
        f"{len(cams)} cameras vs {c2ws.shape[0]} poses"

    train_idx = [i for i in range(len(cams)) if i != test_cam]

    all_imgs, w2cs, Ks, times = [], [], [], []
    test_imgs, test_w2cs = [], []
    H = W = None
    for ci in range(len(cams)):
        frames = _frames_for_cam(path, cams[ci], max_frames, downscale)
        T = frames.shape[0]
        H, W = frames.shape[1:3]
        K = np.array([[focal, 0, W / 2], [0, focal, H / 2], [0, 0, 1]],
                     np.float32)
        c2w = np.eye(4, dtype=np.float32)
        c2w[:3, :4] = c2ws[ci]
        w2c = np.linalg.inv(c2w)
        ts = np.arange(T) / max(T - 1, 1)
        if ci == test_cam:
            test_imgs.append(frames)
            test_w2cs.append(np.tile(w2c[None], (T, 1, 1)))
        else:
            all_imgs.append(frames)
            w2cs.append(np.tile(w2c[None], (T, 1, 1)))
            Ks.append(np.tile(K[None], (T, 1, 1)))
            times.append(ts)

    images = np.concatenate(all_imgs)
    V = images.shape[0]
    bf = np.asarray([float(blur_feature(torch.as_tensor(im))) for im in images],
                    np.float32)
    return SceneData(
        w2c=np.concatenate(w2cs).astype(np.float32),
        K=np.concatenate(Ks).astype(np.float32),
        time=np.concatenate(times).astype(np.float32),
        images=images,
        depths=np.ones((V, H, W), np.float32),
        blur_feats=bf,
        masks=np.zeros((V, H, W), np.float32),
        width=W, height=H,
        max_time=float(max(images.shape[0] // max(len(train_idx), 1) - 1, 1)),
        test_w2c=np.concatenate(test_w2cs).astype(np.float32),
        test_images=np.concatenate(test_imgs))
