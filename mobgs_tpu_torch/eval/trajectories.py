"""Novel-view camera paths + pose smoothing (port of
``mobgs_tpu/eval/trajectories.py``).

Reference: ``dycheck_geometry/trajs.py`` (orbit / lemniscate paths
around a reference camera) and ``utils/pose_utils.py:40``
(``smooth_camera_poses`` SLERP smoothing used by the HyperNeRF video
split). Host-side numpy; outputs w2c stacks for the renderer. The
quaternion conversions are the port's ``core/se3.py`` on CPU tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from mobgs_tpu_torch.core.se3 import quat_to_rotmat, rotmat_to_quat


def _slerp(q0: np.ndarray, q1: np.ndarray, t: float) -> np.ndarray:
    d = float(np.dot(q0, q1))
    if d < 0:
        q1, d = -q1, -d
    d = min(max(d, -1.0), 1.0)
    th = np.arccos(d)
    if th < 1e-6:
        out = (1 - t) * q0 + t * q1
    else:
        out = (np.sin((1 - t) * th) * q0 + np.sin(t * th) * q1) / np.sin(th)
    return out / np.linalg.norm(out)


def _quat_from_R(R: np.ndarray) -> np.ndarray:
    return rotmat_to_quat(torch.as_tensor(np.asarray(R, np.float32))).numpy()


def _R_from_quat(q: np.ndarray) -> np.ndarray:
    return quat_to_rotmat(torch.as_tensor(np.asarray(q, np.float32))).numpy()


def smooth_camera_path(w2cs: np.ndarray, n_per_segment: int = 10) -> np.ndarray:
    """SLERP-interpolated smooth path through a pose sequence
    (utils/pose_utils.smooth_camera_poses equivalent). Returns
    [(N-1)*n, 4, 4] w2c."""
    out = []
    for i in range(len(w2cs) - 1):
        q0 = _quat_from_R(w2cs[i][:3, :3])
        q1 = _quat_from_R(w2cs[i + 1][:3, :3])
        t0, t1 = w2cs[i][:3, 3], w2cs[i + 1][:3, 3]
        for k in range(n_per_segment):
            a = k / n_per_segment
            w = np.eye(4, dtype=np.float32)
            w[:3, :3] = _R_from_quat(_slerp(q0, q1, a))
            w[:3, 3] = (1 - a) * t0 + a * t1
            out.append(w)
    return np.stack(out)


def _look_at_w2c(position: np.ndarray, lookat: np.ndarray,
                 up: np.ndarray) -> np.ndarray:
    fwd = lookat - position
    fwd = fwd / np.linalg.norm(fwd)
    right = np.cross(fwd, up)
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    R_c2w = np.stack([right, down, fwd], axis=1)  # columns = camera axes
    w2c = np.eye(4, dtype=np.float32)
    w2c[:3, :3] = R_c2w.T
    w2c[:3, 3] = -R_c2w.T @ position
    return w2c


def orbit_path(ref_w2c: np.ndarray, lookat: np.ndarray, num_frames: int = 60,
               degree: float = 15.0, up=(0.0, -1.0, 0.0)) -> np.ndarray:
    """Orbit novel-view path around a reference camera (dycheck
    trajs.get_arc_traj equivalent)."""
    c2w = np.linalg.inv(ref_w2c)
    pos0 = c2w[:3, 3]
    up = np.asarray(up, np.float32)
    rad = np.deg2rad(degree)
    angles = np.sin(np.linspace(0, 2 * np.pi, num_frames)) * rad
    out = []
    axis = up / np.linalg.norm(up)
    for a in angles:
        K = np.array([[0, -axis[2], axis[1]],
                      [axis[2], 0, -axis[0]],
                      [-axis[1], axis[0], 0]])
        R = np.eye(3) + np.sin(a) * K + (1 - np.cos(a)) * (K @ K)
        pos = lookat + R @ (pos0 - lookat)
        out.append(_look_at_w2c(pos.astype(np.float32),
                                np.asarray(lookat, np.float32), up))
    return np.stack(out)


def lemniscate_path(ref_w2c: np.ndarray, lookat: np.ndarray,
                    num_frames: int = 60, degree: float = 15.0,
                    up=(0.0, -1.0, 0.0)) -> np.ndarray:
    """Figure-eight novel-view path (dycheck trajs.get_lemniscate_traj)."""
    c2w = np.linalg.inv(ref_w2c)
    pos0 = c2w[:3, 3]
    dist = np.linalg.norm(pos0 - lookat)
    a = dist * np.tan(np.deg2rad(degree))
    up = np.asarray(up, np.float32)
    fwd = (np.asarray(lookat) - pos0) / dist
    right = np.cross(fwd, up)
    right /= np.linalg.norm(right)
    upn = np.cross(right, fwd)
    ts = np.linspace(0, 2 * np.pi, num_frames)
    out = []
    for t in ts:
        dx = a * np.cos(t) / (1 + np.sin(t) ** 2)
        dy = a * np.cos(t) * np.sin(t) / (1 + np.sin(t) ** 2)
        pos = pos0 + dx * right + dy * upn
        out.append(_look_at_w2c(pos.astype(np.float32),
                                np.asarray(lookat, np.float32), up))
    return np.stack(out)
