"""Camera representation (port of ``mobgs_tpu/data/cameras.py``).

A camera is (w2c, K, time): ``w2c`` the 4x4 world→camera matrix, ``K``
the 3x3 pinhole intrinsics, ``time`` the normalized frame time in [0, 1].
Everything derived (rays, pixel grids) is a function of it.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from mobgs_tpu_torch import resolve_device
from mobgs_tpu_torch.core import se3


class Camera(NamedTuple):
    w2c: torch.Tensor   # [4, 4]
    K: torch.Tensor     # [3, 3]
    time: torch.Tensor  # scalar f32, normalized


def camera_from_rt(R, t, K, time, device=None) -> Camera:
    """From the reference convention (R = c2w rotation, t = w2c
    translation), through :func:`se3.world_to_view`, on ``device`` (the
    card unless told otherwise)."""
    dev = resolve_device(device)

    def f32(x):
        return torch.as_tensor(x, dtype=torch.float32, device=dev)

    return Camera(w2c=se3.world_to_view(f32(R), f32(t)), K=f32(K), time=f32(time))


def pixel_grid(width: int, height: int, use_center: bool = False,
               device: torch.device | str = "cpu") -> torch.Tensor:
    """[H, W, 2] pixel coordinates (reference cameras.py:206-213)."""
    yy, xx = torch.meshgrid(
        torch.arange(height, dtype=torch.float32, device=device),
        torch.arange(width, dtype=torch.float32, device=device),
        indexing="ij")
    off = 0.5 if use_center else 0.0
    return torch.stack([xx, yy], dim=-1) + off


def cam_rays(cam: Camera, width: int, height: int) -> torch.Tensor:
    """Per-pixel [H, W, 6] (origin‖world viewdir), parity with
    `scene/cameras.py:132-146` (consumed by the Sandwich decoder); [V, H,
    W, 6] for V poses ``cam.w2c`` [V, 4, 4] of one intrinsics, each view's
    rays equal to its own call's."""
    if cam.w2c.ndim == 2:
        c2w = se3.view_to_world(cam.w2c)
    else:  # each pose inverted alone: its [3, 3] @ [3, 1] rounds as one call's
        c2w = torch.stack([se3.view_to_world(w) for w in cam.w2c])
    origin = c2w[..., :3, 3]
    R = c2w[..., :3, :3]
    pix = pixel_grid(width, height, use_center=True, device=cam.w2c.device)
    fx, fy = cam.K[0, 0], cam.K[1, 1]
    cx, cy = cam.K[0, 2], cam.K[1, 2]
    x = (pix[..., 0] - cx) / fx
    y = (pix[..., 1] - cy) / fy
    local = torch.stack([x, y, torch.ones_like(x)], dim=-1)
    local = se3.normalize(local)
    if R.ndim == 2:
        world = local @ R.T
    else:  # per pose, as ops/projection.py takes the products with a rotation
        world = torch.stack([local @ r.T for r in R])
        origin = origin[:, None, None]
    world = se3.normalize(world)
    org = origin.expand(world.shape)
    return torch.cat([org, world], dim=-1)
