"""Test-time pose optimization (TTO) evaluation (port of
``mobgs_tpu/eval/tto.py``).

Reference ``eval.py:43-166``: per test frame, optimize the w2c pose
(quaternion + translation) with Adam against −PSNR of the render vs the
sharp ground truth, with a cosine learning-rate decay after
``decay_start``, then render the refined view. The JAX package runs the
cameras one after another inside one program (``lax.map`` over a
``fori_loop``); here it is a Python loop over cameras and steps, each step
one ``render_view`` forward and an autograd backward to the 7 pose
scalars (on the card, the CE=11 backward kernel). ``steps=0`` is a plain
render and PSNR.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from mobgs_tpu_torch.core import se3
from mobgs_tpu_torch.data.cameras import Camera
from mobgs_tpu_torch.models import gaussians as G
from mobgs_tpu_torch.models import render as R
from mobgs_tpu_torch.models.sandwich import SandwichParams
from mobgs_tpu_torch.ops.rasterize import RasterConfig

B1, B2, EPS = 0.9, 0.999, 1e-8


class TTOResult(NamedTuple):
    w2c: torch.Tensor      # [V, 4, 4] refined poses
    renders: torch.Tensor  # [V, H, W, 3]
    psnr: torch.Tensor     # [V]


def _psnr(img: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    mse = torch.mean((img - gt) ** 2)
    return 20.0 * torch.log10(1.0 / torch.sqrt(torch.clamp(mse, min=1e-12)))


def pose_objective(stat: G.GaussianState, dyn: G.GaussianState,
                   sandwich: SandwichParams, width: int, height: int,
                   max_time: float = 1.0,
                   raster_cfg: RasterConfig = RasterConfig()):
    """TTO's objective and render at a pose: ``render(q, t, K, time)`` →
    (image [H, W, 3], w2c [4, 4]) for the quaternion ``q`` [4] (wxyz) and
    translation ``t`` [3] of a world→camera pose, and
    ``neg_psnr(q, t, K, time, gt)`` → −PSNR of that render against ``gt``
    (differentiable in ``q`` and ``t``)."""
    def render(q, t, K, time):
        top = torch.cat([se3.quat_to_rotmat(q), t[:, None]], dim=1)
        w2c = torch.cat([top, torch.tensor([[0.0, 0.0, 0.0, 1.0]],
                                           dtype=top.dtype, device=top.device)])
        bg3 = torch.zeros(3, dtype=torch.float32, device=top.device)
        out = R.render_view(stat, dyn, sandwich, Camera(w2c=w2c, K=K, time=time),
                            width, height, bg3, max_time, config=raster_cfg)
        return out.image, w2c

    def neg_psnr(q, t, K, time, gt):
        return -_psnr(render(q, t, K, time)[0], gt)

    return render, neg_psnr


def make_tto(stat: G.GaussianState, dyn: G.GaussianState,
             sandwich: SandwichParams, width: int, height: int,
             max_time: float = 1.0,
             steps: int = 100, decay_start: int = 30,
             lr_q: float = 3e-4, lr_p: float = 3e-4,
             lr_final: float = 1e-6,
             raster_cfg: RasterConfig = RasterConfig()):
    """Build the TTO function over a batch of test cameras.

    Defaults match the reference's shipped call (``eval.py:258-263``:
    tto_steps=100, decay_start=30, lr_p=lr_q=3e-4, lr_final=1e-6, a
    per-camera lr factor of 1.0), as the JAX package's do.
    """
    t_max = max(steps - decay_start, 1)
    render, neg_psnr = pose_objective(stat, dyn, sandwich, width, height,
                                      max_time, raster_cfg)

    def per_cam(w2c0, K, time, gt, lr_s):
        q = se3.rotmat_to_quat(w2c0[:3, :3]).detach()
        t = w2c0[:3, 3].detach().clone()
        mq, vq = torch.zeros_like(q), torch.zeros_like(q)
        mt, vt = torch.zeros_like(t), torch.zeros_like(t)
        for step in range(steps):
            q.requires_grad_(True)
            t.requires_grad_(True)
            gq, gt_ = torch.autograd.grad(neg_psnr(q, t, K, time, gt), (q, t))
            n = min(max(step - decay_start, 0), t_max)
            cos = 0.5 * (1 + math.cos(math.pi * n / t_max))
            lrq = (lr_final + (lr_q - lr_final) * cos) * lr_s
            lrp = (lr_final + (lr_p - lr_final) * cos) * lr_s
            c1, c2 = 1 - B1 ** (step + 1), 1 - B2 ** (step + 1)
            with torch.no_grad():
                mq = B1 * mq + (1 - B1) * gq
                vq = B2 * vq + (1 - B2) * gq * gq
                mt = B1 * mt + (1 - B1) * gt_
                vt = B2 * vt + (1 - B2) * gt_ * gt_
                q = q - lrq * (mq / c1) / (torch.sqrt(vq / c2) + EPS)
                t = t - lrp * (mt / c1) / (torch.sqrt(vt / c2) + EPS)
        with torch.no_grad():
            img, w2c = render(q.detach(), t.detach(), K, time)
            return w2c, torch.clamp(img, 0.0, 1.0), _psnr(img, gt)

    def tto(w2c0: torch.Tensor, K: torch.Tensor, time: torch.Tensor,
            gt: torch.Tensor, lr_scale: torch.Tensor) -> TTOResult:
        """Optimize each camera in turn.

        Args: w2c0 [V,4,4]; K [V,3,3]; time [V]; gt [V,H,W,3];
              lr_scale [V] per-camera lr factor (the reference uses 0.1
              after the first camera when it starts from the previous one).
        """
        res = [per_cam(w2c0[i], K[i], time[i], gt[i], float(lr_scale[i]))
               for i in range(w2c0.shape[0])]
        return TTOResult(w2c=torch.stack([r[0] for r in res]),
                         renders=torch.stack([r[1] for r in res]),
                         psnr=torch.stack([r[2] for r in res]))

    return tto
