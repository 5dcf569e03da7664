"""Camera trajectory accuracy: ATE / RPE + Umeyama alignment (port of
``mobgs_tpu/eval/pose_metrics.py``, the same numpy).

Reference: ``utils_poses/comp_ate.py:36-77`` (ATE RMSE over pose
translations, RPE as frame-to-frame relative pose error) and
``utils_poses/align_utils.py`` / ``align_traj.py`` (SE(3)/Sim(3) Umeyama
alignment of a predicted c2w trajectory onto ground truth before ATE).
Evaluation is host-side.
"""

from __future__ import annotations

import numpy as np


def rotation_error(pose_error: np.ndarray) -> float:
    """Geodesic angle of a relative pose error (comp_ate.py:7-19)."""
    d = 0.5 * (np.trace(pose_error[:3, :3]) - 1.0)
    return float(np.arccos(np.clip(d, -1.0, 1.0)))


def translation_error(pose_error: np.ndarray) -> float:
    return float(np.linalg.norm(pose_error[:3, 3]))


def compute_rpe(gt: np.ndarray, pred: np.ndarray):
    """Relative pose error over consecutive frames (comp_ate.py:36-53).

    Args: gt, pred [N, 4, 4] (c2w or w2c, consistent).
    Returns (rpe_trans, rpe_rot) means.
    """
    trans, rot = [], []
    for i in range(len(gt) - 1):
        gt_rel = np.linalg.inv(gt[i]) @ gt[i + 1]
        pr_rel = np.linalg.inv(pred[i]) @ pred[i + 1]
        rel_err = np.linalg.inv(gt_rel) @ pr_rel
        trans.append(translation_error(rel_err))
        rot.append(rotation_error(rel_err))
    return float(np.mean(trans)), float(np.mean(rot))


def compute_ate(gt: np.ndarray, pred: np.ndarray) -> float:
    """RMSE of translation differences (comp_ate.py:56-77)."""
    err = gt[:, :3, 3] - pred[:, :3, 3]
    return float(np.sqrt(np.mean(np.sum(err**2, axis=1))))


def umeyama(src: np.ndarray, dst: np.ndarray, with_scale: bool = True):
    """Least-squares similarity transform dst ≈ s R src + t.

    Standard Umeyama (align_utils.align_umeyama equivalent).
    Returns (s, R [3,3], t [3]).
    """
    mu_s = src.mean(0)
    mu_d = dst.mean(0)
    src_c = src - mu_s
    dst_c = dst - mu_d
    cov = dst_c.T @ src_c / len(src)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    if with_scale:
        var_s = (src_c**2).sum() / len(src)
        s = float(np.trace(np.diag(D) @ S) / var_s)
    else:
        s = 1.0
    t = mu_d - s * R @ mu_s
    return s, R, t


def align_trajectory_c2w(pred_c2w: np.ndarray, gt_c2w: np.ndarray,
                         method: str = "sim3") -> np.ndarray:
    """Align predicted c2w trajectory onto GT (align_ate_c2b_use_a2b
    equivalent): solve Sim(3)/SE(3) on camera centres, apply to poses."""
    s, R, t = umeyama(pred_c2w[:, :3, 3], gt_c2w[:, :3, 3],
                      with_scale=(method == "sim3"))
    out = pred_c2w.copy()
    out[:, :3, 3] = (s * (R @ pred_c2w[:, :3, 3].T)).T + t
    out[:, :3, :3] = np.einsum("ij,njk->nik", R, pred_c2w[:, :3, :3])
    return out


def evaluate_poses(gt_c2w: np.ndarray, pred_c2w: np.ndarray,
                   align: str = "sim3") -> dict:
    """ATE (after alignment) + RPE, the SplineGS-style pose report."""
    aligned = align_trajectory_c2w(pred_c2w, gt_c2w, method=align)
    ate = compute_ate(gt_c2w, aligned)
    rpe_t, rpe_r = compute_rpe(gt_c2w, aligned)
    return {"ate": ate, "rpe_trans": rpe_t,
            "rpe_rot_deg": rpe_r * 180.0 / np.pi}
