"""Image quality metrics and losses (port of ``mobgs_tpu/core/image.py``).

SSIM with an 11×11 Gaussian window (σ = 1.5), zero padding and a
per-channel depthwise blur, and the per-batch-item PSNR, as the JAX package
computes them (``image.py:35-89``). The 2D window is the outer product of a
1D Gaussian, so the blur is two 1D depthwise convolutions. They run in full
float32 on the card whatever ``torch.backends.cudnn.allow_tf32`` says
(``fp32_convolutions``), so SSIM is the JAX package's float32 number in every
entry point.
"""

from __future__ import annotations

import contextlib
import functools

import numpy as np
import torch
import torch.nn.functional as F


@functools.lru_cache(maxsize=None)
def _gaussian_1d(window_size: int = 11, sigma: float = 1.5) -> np.ndarray:
    x = np.arange(window_size, dtype=np.float64)
    g = np.exp(-((x - window_size // 2) ** 2) / (2 * sigma**2))
    return (g / g.sum()).astype(np.float32)


@contextlib.contextmanager
def fp32_convolutions():
    """cuDNN convolutions in full float32 inside the block: TF32 off for its
    duration, the caller's cuDNN flags restored after it."""
    cudnn = torch.backends.cudnn
    with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                     deterministic=cudnn.deterministic, allow_tf32=False):
        yield


class _Fp32Conv(torch.autograd.Function):
    """``F.conv2d`` by a constant weight whose forward and backward both run
    under ``fp32_convolutions`` (autograd runs a backward after the forward's
    block has closed)."""

    @staticmethod
    def forward(ctx, x, w, padding, groups):
        ctx.save_for_backward(w)
        ctx.shape, ctx.padding, ctx.groups = x.shape, padding, groups
        with fp32_convolutions():
            return F.conv2d(x, w, padding=padding, groups=groups)

    @staticmethod
    def backward(ctx, g):
        (w,) = ctx.saved_tensors
        with fp32_convolutions():
            gx = torch.nn.grad.conv2d_input(ctx.shape, w, g, padding=ctx.padding,
                                            groups=ctx.groups)
        return gx, None, None, None


def _depthwise_blur(img: torch.Tensor, window_size: int = 11) -> torch.Tensor:
    """Zero-padded depthwise Gaussian blur, img [B, C, H, W]."""
    C = img.shape[1]
    k = window_size
    g = torch.as_tensor(_gaussian_1d(k), device=img.device, dtype=img.dtype)
    kh = g.reshape(1, 1, 1, k).expand(C, 1, 1, k)
    kv = g.reshape(1, 1, k, 1).expand(C, 1, k, 1)
    out = _Fp32Conv.apply(img, kh, (0, k // 2), C)
    return _Fp32Conv.apply(out, kv, (k // 2, 0), C)


def ssim(img1: torch.Tensor, img2: torch.Tensor, window_size: int = 11,
         size_average: bool = True) -> torch.Tensor:
    """SSIM on [B, C, H, W] (or [C, H, W]) images in [0, 1]."""
    if img1.dim() == 3:
        img1, img2 = img1[None], img2[None]
    mu1 = _depthwise_blur(img1, window_size)
    mu2 = _depthwise_blur(img2, window_size)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = _depthwise_blur(img1 * img1, window_size) - mu1_sq
    sigma2_sq = _depthwise_blur(img2 * img2, window_size) - mu2_sq
    sigma12 = _depthwise_blur(img1 * img2, window_size) - mu1_mu2
    C1, C2 = 0.01**2, 0.03**2
    ssim_map = ((2 * mu1_mu2 + C1) * (2 * sigma12 + C2)) / (
        (mu1_sq + mu2_sq + C1) * (sigma1_sq + sigma2_sq + C2))
    if size_average:
        return ssim_map.mean()
    return ssim_map.mean(dim=(1, 2, 3))


def psnr(img1: torch.Tensor, img2: torch.Tensor,
         mask: torch.Tensor | None = None) -> torch.Tensor:
    """PSNR over flattened images; per-batch-item mean like the reference."""
    if img1.dim() == 3:
        img1, img2 = img1[None], img2[None]
    if mask is None:
        mse = torch.mean((img1 - img2) ** 2, dim=(1, 2, 3))
    else:
        if mask.dim() == 3:
            mask = mask[None]
        mask = mask.expand(img1.shape)
        mse = torch.sum(((img1 - img2) * mask) ** 2, dim=(1, 2, 3)) / (
            torch.sum(mask, dim=(1, 2, 3)) + 1e-8)
    return 20.0 * torch.log10(1.0 / torch.sqrt(torch.clamp(mse, min=1e-12)))
