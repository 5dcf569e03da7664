"""Evaluation metrics: PSNR, SSIM, LPIPS, tOF (port of
``mobgs_tpu/eval/metrics.py``).

Reference: ``metrics.py:14-148`` — per-frame full-image PSNR and SSIM,
LPIPS(AlexNet), and tOF = mean |Farneback(gt pair) − Farneback(pred pair)|
on 8-pixel-cropped grayscale frames.

PSNR/SSIM/LPIPS run on the device given; tOF stays on the host with
OpenCV like the reference (Farneback is an OpenCV algorithm, not a tensor
op) and is None where ``cv2`` does not import.
"""

from __future__ import annotations

import numpy as np
import torch

from mobgs_tpu_torch import resolve_device
from mobgs_tpu_torch.core.image import psnr as _psnr
from mobgs_tpu_torch.core.image import ssim as _ssim
from mobgs_tpu_torch.eval import lpips as _lpips


def crop_8x8(img: np.ndarray) -> np.ndarray:
    """Crop 8 px borders with the reference's odd-size shift
    (metrics.py:36-47)."""
    h, w = img.shape[:2]
    sh = 1 if h % 32 != 0 else 0
    sw = 1 if w % 32 != 0 else 0
    return img[8 + sh:h - 8 + sh, 8 + sw:w - 8 + sw]


def to_gray(img: np.ndarray) -> np.ndarray:
    return (0.299 * img[..., 0] + 0.587 * img[..., 1]
            + 0.114 * img[..., 2])


def tof_pair(gt_prev, gt_cur, pred_prev, pred_cur) -> float:
    """Temporal optical-flow consistency between consecutive frames
    (metrics.py:14-34): L1 between Farneback flows of gt and pred."""
    import cv2
    g0 = (to_gray(crop_8x8(gt_prev)) * 255).astype(np.uint8)
    g1 = (to_gray(crop_8x8(gt_cur)) * 255).astype(np.uint8)
    p0 = (to_gray(crop_8x8(pred_prev)) * 255).astype(np.uint8)
    p1 = (to_gray(crop_8x8(pred_cur)) * 255).astype(np.uint8)
    args = dict(pyr_scale=0.5, levels=3, winsize=15, iterations=3,
                poly_n=5, poly_sigma=1.2, flags=0)
    f_gt = cv2.calcOpticalFlowFarneback(g0, g1, None, **args)
    f_pr = cv2.calcOpticalFlowFarneback(p0, p1, None, **args)
    return float(np.mean(np.abs(f_gt - f_pr)))


@torch.no_grad()
def evaluate_sequence(preds: np.ndarray, gts: np.ndarray,
                      lpips_params=None, compute_tof: bool = True,
                      device: str | torch.device | None = None) -> dict:
    """Per-frame metrics over aligned [V, H, W, 3] float[0,1] sequences, on
    ``device`` (the card unless ``"cpu"``; ``lpips_params`` lives there).

    Returns dict with mean PSNR/SSIM/LPIPS/tOF (reference metrics.py:81-148
    protocol: full-image, frame-averaged).
    """
    dev = resolve_device(device)
    V = preds.shape[0]
    pj = torch.as_tensor(np.asarray(preds, np.float32), device=dev).permute(0, 3, 1, 2)
    gj = torch.as_tensor(np.asarray(gts, np.float32), device=dev).permute(0, 3, 1, 2)
    psnrs = _psnr(pj, gj).cpu().numpy()
    ssims = _ssim(pj, gj, size_average=False).cpu().numpy()

    out = {"psnr": float(psnrs.mean()), "ssim": float(ssims.mean()),
           "per_frame_psnr": psnrs.tolist()}

    if lpips_params is not None:
        d = _lpips.lpips_distance(lpips_params, 2 * pj - 1, 2 * gj - 1)
        key = "lpips" if lpips_params.pretrained_backbone else "lpips_randfeat"
        out[key] = float(d.cpu().numpy().mean())

    if compute_tof and V >= 2:
        try:
            tofs = [tof_pair(gts[i - 1], gts[i], preds[i - 1], preds[i])
                    for i in range(1, V)]
            out["tof"] = float(np.mean(tofs))
        except ImportError:
            out["tof"] = None
    return out
