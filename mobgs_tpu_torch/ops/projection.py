"""Perspective EWA projection of 3D Gaussians to screen space
(port of ``mobgs_tpu/ops/projection.py``).

Plain tensor math over the Gaussian axis, differentiable by autograd.
Semantics matched to gsplat v1.4 defaults, as in the JAX package
(``projection.py:67-116``):

* near-plane cull at z <= 0.01 (radius forced to 0),
* camera-plane coordinates clamped to ±1.3·tan(fov) when building the
  projection Jacobian,
* 2D covariance low-pass: +0.3 on the diagonal (eps2d), clipped to 1e12,
* radius = ceil(3σ_max) with σ_max from the 2D covariance eigenvalues,
* cull where ``det <= 1e-12`` or the bbox misses the image rectangle.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from mobgs_tpu_torch.core import se3


class ProjectedSplats(NamedTuple):
    """Per-Gaussian screen-space records."""
    means2d: torch.Tensor   # [N, 2] pixel coords
    conics: torch.Tensor    # [N, 3] upper-tri of inverse 2D covariance (a, b, c)
    depths: torch.Tensor    # [N] camera-space z
    radii: torch.Tensor     # [N] int32 pixel radius (0 = culled)


def quat_scale_to_cov3d(quats: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """Covariance R S S^T R^T from unit-normalized quats and linear scales."""
    R = se3.quat_to_rotmat(quats)          # [N, 3, 3]
    M = R * scales[..., None, :]           # R @ diag(s)
    return M @ M.transpose(-1, -2)


def project(means: torch.Tensor, quats: torch.Tensor, scales: torch.Tensor,
            viewmat: torch.Tensor, K: torch.Tensor, width: int, height: int,
            eps2d: float = 0.3, near: float = 0.01,
            sigma_cut: float = 3.0) -> ProjectedSplats:
    """Project Gaussians into one camera.

    Args:
      means: [N, 3] world positions.
      quats: [N, 4] rotations (wxyz, unnormalized ok).
      scales: [N, 3] linear (activated) scales.
      viewmat: [4, 4] world→camera.
      K: [3, 3] intrinsics.
      width, height: image size.

    Returns:
      ProjectedSplats; culled Gaussians have radius 0.

    Several cameras of one intrinsics project together: ``viewmat``
    [V, 4, 4] and ``means``, ``quats``, ``scales`` [V, N, ...] (each view's
    rows), giving records [V, N, ...] equal to V calls' to the bit: the ops
    are the one-camera ops over a leading axis, but for the products with a
    camera's rotation, taken per view as one call takes them. A batched
    product rounds by another kernel, and its backward, a [3, N] @ [N, 3]
    reduction a view, runs on one block a view.
    """
    dt = means.dtype
    Rcw = viewmat[..., :3, :3]
    tcw = viewmat[..., :3, 3]
    if viewmat.ndim == 2:
        p_cam = means @ Rcw.T + tcw  # [N, 3]
    else:
        p_cam = torch.stack([m @ R.T for m, R in zip(means, Rcw)]) + tcw[:, None]
    x, y, z = p_cam[..., 0], p_cam[..., 1], p_cam[..., 2]
    fx, fy = K[0, 0], K[1, 1]
    cx, cy = K[0, 2], K[1, 2]

    zs = torch.clamp(z, min=near)
    # Clamp plane coords for the Jacobian like gsplat (±1.3 tan fov).
    tan_fovx = 0.5 * width / fx
    tan_fovy = 0.5 * height / fy
    lim_x = 1.3 * tan_fovx
    lim_y = 1.3 * tan_fovy
    tx = zs * torch.clamp(x / zs, -lim_x, lim_x)
    ty = zs * torch.clamp(y / zs, -lim_y, lim_y)

    cov3d = quat_scale_to_cov3d(quats, scales)  # [N, 3, 3]
    W = Rcw  # world→cam rotation
    if viewmat.ndim == 2:
        covc = W @ cov3d @ W.T  # camera-frame covariance
    else:
        covc = torch.stack([R @ c @ R.T for R, c in zip(W, cov3d)])

    rz = 1.0 / zs
    rz2 = rz * rz
    # J rows: d(u)/d(cam), d(v)/d(cam) for u = fx x/z, v = fy y/z
    j00 = fx * rz
    j02 = -fx * tx * rz2
    j11 = fy * rz
    j12 = -fy * ty * rz2
    c00, c01, c02 = covc[..., 0, 0], covc[..., 0, 1], covc[..., 0, 2]
    c11, c12, c22 = covc[..., 1, 1], covc[..., 1, 2], covc[..., 2, 2]
    # cov2d = J Σc J^T, expanded by hand
    a = j00 * (j00 * c00 + j02 * c02) + j02 * (j00 * c02 + j02 * c22) + eps2d
    b = j00 * (j11 * c01 + j12 * c02) + j02 * (j11 * c12 + j12 * c22)
    c = j11 * (j11 * c11 + j12 * c12) + j12 * (j11 * c12 + j12 * c22) + eps2d
    # bound the 2D covariance: inf - inf = NaN in det otherwise
    big = 1e12
    a = torch.clamp(a, 0.0, big)
    b = torch.clamp(b, -big, big)
    c = torch.clamp(c, 0.0, big)
    det = a * c - b * b
    det = torch.clamp(det, min=1e-12)
    inv_det = 1.0 / det
    conics = torch.stack([c * inv_det, -b * inv_det, a * inv_det], dim=-1)

    mean2d = torch.stack([fx * x * rz + cx, fy * y * rz + cy], dim=-1)

    # radius from the larger eigenvalue of cov2d
    mid = 0.5 * (a + c)
    lam = mid + torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
    radius = torch.ceil(sigma_cut * torch.sqrt(lam))

    inside = ((mean2d[..., 0] + radius > 0) & (mean2d[..., 0] - radius < width)
              & (mean2d[..., 1] + radius > 0) & (mean2d[..., 1] - radius < height))
    valid = (z > near) & inside & (det > 1e-12)
    radius = torch.where(valid, radius, torch.zeros_like(radius)).to(torch.int32)

    return ProjectedSplats(means2d=mean2d.to(dt), conics=conics.to(dt),
                           depths=z.to(dt), radii=radius)
