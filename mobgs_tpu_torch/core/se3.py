"""Rotation / rigid-transform math (port of ``mobgs_tpu/core/se3.py``).

Conventions match the JAX package: quaternions are (w, x, y, z) and
``[..., 4]``; rigid transforms are 4x4 world→camera matrices.
"""

from __future__ import annotations

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
