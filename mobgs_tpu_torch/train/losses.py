"""Training losses (port of ``mobgs_tpu/train/losses.py``, the terms of the
flow-off step). The flow-warp consistency loss (``warp_images``,
``flow_warp_loss``) comes with the flow-on slice."""

from __future__ import annotations

import torch

from mobgs_tpu_torch.core.image import ssim as _ssim


def l1_loss(pred: torch.Tensor, gt: torch.Tensor,
            mask: torch.Tensor | None = None) -> torch.Tensor:
    """Plain or masked mean absolute error (loss_utils.py:233-239)."""
    if mask is None:
        return torch.mean(torch.abs(pred - gt))
    mask = mask.expand(gt.shape)
    return torch.sum(torch.abs((pred - gt) * mask)) / (torch.sum(mask) + 1e-8)


def ssim_loss_term(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    return _ssim(pred, gt)


def entropy_loss(alpha: torch.Tensor) -> torch.Tensor:
    """Σ binary entropy — pushes alpha to 0/1 (loss_utils.py:264-276)."""
    eps = 1e-6
    alpha = torch.clamp(alpha, 0.0, 1.0)  # guard fp overshoot past 1.0
    return -torch.sum(alpha * torch.log(alpha + eps)
                      + (1 - alpha) * torch.log(1 - alpha + eps))


def sparsity_loss(alpha: torch.Tensor) -> torch.Tensor:
    """Σ alpha² (loss_utils.py:285-295)."""
    return torch.sum(alpha ** 2)
