"""Rotation / rigid-transform math (port of ``mobgs_tpu/core/se3.py``).

Conventions match the JAX package: quaternions are (w, x, y, z) and
``[..., 4]``; rigid transforms are 4x4 world→camera matrices.
"""

from __future__ import annotations

import math

import torch


def normalize(v: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    """Unit-normalize, NaN-safe in the backward pass at ‖v‖ = 0.

    Clamps the *squared* norm before rsqrt (``se3.py:22-31``): dead
    Gaussian slots carry all-zero quaternions, and ``v / max(‖v‖, eps)``
    would back-propagate NaN there."""
    sq = torch.sum(v * v, dim=dim, keepdim=True)
    return v * torch.rsqrt(torch.clamp(sq, min=eps * eps))


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """Unit-normalize quaternion(s) [..., 4] (wxyz) to rotation [..., 3, 3]."""
    q = normalize(q)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    r00 = 1 - 2 * (y * y + z * z)
    r01 = 2 * (x * y - w * z)
    r02 = 2 * (x * z + w * y)
    r10 = 2 * (x * y + w * z)
    r11 = 1 - 2 * (x * x + z * z)
    r12 = 2 * (y * z - w * x)
    r20 = 2 * (x * z - w * y)
    r21 = 2 * (y * z + w * x)
    r22 = 1 - 2 * (x * x + y * y)
    return torch.stack([
        torch.stack([r00, r01, r02], -1),
        torch.stack([r10, r11, r12], -1),
        torch.stack([r20, r21, r22], -1),
    ], -2)


def view_to_world(w2c: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of a rigid 4x4 (``[..., 4, 4]``)."""
    R = w2c[..., :3, :3]
    t = w2c[..., :3, 3:]
    Rt = R.transpose(-1, -2)
    top = torch.cat([Rt, -Rt @ t], dim=-1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=w2c.dtype,
                          device=w2c.device).expand(w2c.shape[:-2] + (1, 4))
    return torch.cat([top, bottom], dim=-2)


def skew(w: torch.Tensor) -> torch.Tensor:
    """[..., 3] → skew-symmetric [..., 3, 3]."""
    zero = torch.zeros_like(w[..., 0])
    w1, w2, w3 = w[..., 0], w[..., 1], w[..., 2]
    return torch.stack([
        torch.stack([zero, -w3, w2], -1),
        torch.stack([w3, zero, -w1], -1),
        torch.stack([-w2, w1, zero], -1),
    ], -2)


def rodrigues(w_skew: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
    """exp(theta * [w]_x) for unit-axis skew matrices. theta: [..., 1, 1]."""
    eye = torch.eye(3, dtype=w_skew.dtype, device=w_skew.device)
    return (eye + torch.sin(theta) * w_skew
            + (1 - torch.cos(theta)) * (w_skew @ w_skew))


def se3_G(w_skew: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
    """The V/G matrix of the SE(3) exponential (reference blce.py:452-459)."""
    eye = torch.eye(3, dtype=w_skew.dtype, device=w_skew.device)
    return (eye * theta + (1 - torch.cos(theta)) * w_skew
            + (theta - torch.sin(theta)) * (w_skew @ w_skew))


def se3_exp_wvtheta(w: torch.Tensor, v: torch.Tensor,
                    theta: torch.Tensor) -> torch.Tensor:
    """SE(3) delta from axis w [..., 3], translation v [..., 3] and angle
    theta [..., 1] (``se3.py:119-134``): w normalized to a unit axis with
    ``rsqrt(max(|w|², 1e-20))``, Rodrigues with the decoded theta, and
    translation ``p = G(w, θ) v``. Returns [..., 4, 4]."""
    w_unit = w * torch.rsqrt(torch.clamp(torch.sum(w * w, dim=-1, keepdim=True),
                                         min=1e-20))
    W = skew(w_unit)
    th = theta[..., None]  # [..., 1, 1]
    R = rodrigues(W, th)
    p = se3_G(W, th) @ v[..., None]
    top = torch.cat([R, p], dim=-1)  # [..., 3, 4]
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=top.dtype,
                          device=top.device).expand(top.shape[:-2] + (1, 4))
    return torch.cat([top, bottom], dim=-2)


def rotmat_to_quat(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix [..., 3, 3] → unit quaternion [..., 4] (wxyz),
    branch-free (``se3.py:54-80``): the four Shepperd constructions,
    selected by the trace and the dominant diagonal term."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    qw0 = torch.sqrt(torch.clamp(1 + tr, min=1e-12)) / 2
    q0 = torch.stack([qw0, (m21 - m12) / (4 * qw0), (m02 - m20) / (4 * qw0),
                      (m10 - m01) / (4 * qw0)], -1)
    qx1 = torch.sqrt(torch.clamp(1 + m00 - m11 - m22, min=1e-12)) / 2
    q1 = torch.stack([(m21 - m12) / (4 * qx1), qx1, (m01 + m10) / (4 * qx1),
                      (m02 + m20) / (4 * qx1)], -1)
    qy2 = torch.sqrt(torch.clamp(1 - m00 + m11 - m22, min=1e-12)) / 2
    q2 = torch.stack([(m02 - m20) / (4 * qy2), (m01 + m10) / (4 * qy2), qy2,
                      (m12 + m21) / (4 * qy2)], -1)
    qz3 = torch.sqrt(torch.clamp(1 - m00 - m11 + m22, min=1e-12)) / 2
    q3 = torch.stack([(m10 - m01) / (4 * qz3), (m02 + m20) / (4 * qz3),
                      (m12 + m21) / (4 * qz3), qz3], -1)
    cond0 = tr > 0
    cond1 = (m00 > m11) & (m00 > m22)
    cond2 = m11 > m22
    q = torch.where(cond0[..., None], q0,
                    torch.where(cond1[..., None], q1,
                                torch.where(cond2[..., None], q2, q3)))
    return normalize(q)


def quat_multiply(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product of quaternions [..., 4] (wxyz)."""
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ], -1)


def world_to_view(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """4x4 world→camera matrix from the reference's (R = camera-to-world
    rotation, t = world-to-camera translation), as ``getWorld2View2`` with
    zero translate and unit scale."""
    R = torch.as_tensor(R)
    t = torch.as_tensor(t, dtype=R.dtype, device=R.device)
    top = torch.cat([R.T, t[:, None]], dim=1)
    bottom = torch.tensor([[0.0, 0.0, 0.0, 1.0]], dtype=R.dtype, device=R.device)
    return torch.cat([top, bottom], dim=0)


def projection_matrix(znear: float, zfar: float, fovx: float, fovy: float,
                      device: str | torch.device | None = None) -> torch.Tensor:
    """OpenGL-style projection, parity with ``getProjectionMatrix``
    (float32, on ``device``; the CPU when None, as it is a host constant)."""
    tan_y = math.tan(fovy / 2)
    tan_x = math.tan(fovx / 2)
    top = tan_y * znear
    right = tan_x * znear
    P = torch.zeros((4, 4), dtype=torch.float32, device=device)
    P[0, 0] = znear / right
    P[1, 1] = znear / top
    P[3, 2] = 1.0
    P[2, 2] = zfar / (zfar - znear)
    P[2, 3] = -(zfar * znear) / (zfar - znear)
    return P


def fov2focal(fov, pixels):
    return pixels / (2 * _tan(fov / 2))


def focal2fov(focal, pixels):
    return 2 * _atan(pixels / (2 * focal))


def _tan(x):
    return torch.tan(x) if isinstance(x, torch.Tensor) else math.tan(x)


def _atan(x):
    return torch.atan(x) if isinstance(x, torch.Tensor) else math.atan(x)
