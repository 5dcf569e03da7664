"""Training losses (port of ``mobgs_tpu/train/losses.py``): the photometric
and regulariser terms of the step, and the flow-warp consistency loss with
its bilinear sampler (torch ``F.grid_sample`` semantics: bilinear, border
padding, ``align_corners=False``, on the reference's pixel→grid
normalisation, train.py:660-663)."""

from __future__ import annotations

import torch

from mobgs_tpu_torch.core.image import ssim as _ssim
from mobgs_tpu_torch.ops import cuda_warp
from mobgs_tpu_torch.utils import observability as obs


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


def binary_dice_loss(y_pred: torch.Tensor, y_true: torch.Tensor,
                     batch_dice: bool = False, from_logits: bool = True,
                     log_loss: bool = False, smooth: float = 0.0,
                     eps: float = 1e-7) -> torch.Tensor:
    """Binary Dice loss (``losses.py:44-70``, the reference's
    ``BinaryDiceLoss``, which train.py builds and never calls). y_pred has a
    leading batch axis; y_true is flattened per sample the same way."""
    if from_logits:
        # exp(logsigmoid), not sigmoid: the two differ at extreme logits
        y_pred = torch.exp(torch.nn.functional.logsigmoid(y_pred))
    bs = y_pred.shape[0]
    y_pred = y_pred.reshape(bs, -1)
    y_true = y_true.reshape(bs, -1).to(y_pred.dtype)
    if batch_dice:
        intersection = torch.sum(y_pred * y_true)
        cardinality = torch.sum(y_pred + y_true)
    else:
        intersection = torch.sum(y_pred * y_true, dim=-1)
        cardinality = torch.sum(y_pred + y_true, dim=-1)
    dice = (2.0 * intersection + smooth) / torch.clamp(cardinality + smooth,
                                                       min=eps)
    losses = -torch.log(torch.clamp(dice, min=eps)) if log_loss else 1.0 - dice
    return torch.mean(losses)


def grid_sample_border(img: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """Bilinear sampling with border padding, ``align_corners=False``.

    Args:
      img: [C, H, W].
      grid: [Ho, Wo, 2] normalized coords in [-1, 1] (x, y order).

    Returns:
      [C, Ho, Wo].
    """
    C, H, W = img.shape
    gx, gy = grid[..., 0], grid[..., 1]
    # align_corners=False: -1..1 spans pixel *edges*
    x = ((gx + 1.0) * W - 1.0) * 0.5
    y = ((gy + 1.0) * H - 1.0) * 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    wx = x - x0
    wy = y - y0

    def at(ix, iy):
        ix = torch.clamp(ix.to(torch.int64), 0, W - 1)
        iy = torch.clamp(iy.to(torch.int64), 0, H - 1)
        return img[:, iy, ix]  # [C, Ho, Wo]

    v00 = at(x0, y0)
    v10 = at(x0 + 1, y0)
    v01 = at(x0, y0 + 1)
    v11 = at(x0 + 1, y0 + 1)
    top = v00 * (1 - wx) + v10 * wx
    bot = v01 * (1 - wx) + v11 * wx
    return top * (1 - wy) + bot * wy


def normalize_coords(coords: torch.Tensor, width: int, height: int) -> torch.Tensor:
    """Pixel coord map → grid_sample coords, the reference's normalisation
    (train.py:660-663): c/(S-1) * 2 - 1."""
    gx = coords[..., 0] / (width - 1) * 2.0 - 1.0
    gy = coords[..., 1] / (height - 1) * 2.0 - 1.0
    return torch.stack([gx, gy], dim=-1)


# ---------------------------------------------------------------------------
# The K-warp bilinear sampler of the flow loss (``losses.py:113-234``).
#
# Semantics: grid_sample(bilinear, border, align_corners=False) composed
# with the pixel→grid normalisation, i.e. source coords
# x = c_x * W/(W-1) - 0.5. Each image is flattened to [P, C] and its 2x2
# bilinear footprint packed into one row, C4[i] = img[i] ‖ img[i+1] ‖
# img[i+W] ‖ img[i+W+1] (rolls), so a warp is one row gather; its backward
# is one index_add_ per warp into the packed space, folded back to image
# space with the inverse rolls (the exact adjoint). Clamping x0 to W-2 and
# y0 to H-2 keeps idx + W + 1 inside the image, so the rolls never wrap
# into a read, and wx = clip(x) - x0 saturates to 0/1 at the border, which
# gives border padding's values. Coordinate gradients are zero outside
# [0, W-1] × [0, H-1]; on the far border itself the one-sided derivative.
# This is the plain route, a Python loop over the warps (CPU tensors and
# ``backend="plain"``); CUDA tensors take ``ops/cuda_warp.py``'s kernels,
# one launch a call each way, forward bit-equal to it.
# ---------------------------------------------------------------------------

def _warp_prep(coords_k: torch.Tensor, width: int, height: int):
    """[H,W,2] pixel coords → flat row indices, bilinear weights and the
    in-bounds masks of x and y."""
    P = height * width
    x = coords_k[..., 0] * (width / (width - 1.0)) - 0.5
    y = coords_k[..., 1] * (height / (height - 1.0)) - 0.5
    inb_x = (x >= 0.0) & (x <= width - 1.0)
    inb_y = (y >= 0.0) & (y <= height - 1.0)
    x = torch.clamp(x, 0.0, width - 1.0)
    y = torch.clamp(y, 0.0, height - 1.0)
    x0 = torch.clamp(torch.floor(x).to(torch.int64), 0, width - 2)
    y0 = torch.clamp(torch.floor(y).to(torch.int64), 0, height - 2)
    wx = (x - x0).reshape(P, 1)
    wy = (y - y0).reshape(P, 1)
    idx = (y0 * width + x0).reshape(P)
    return idx, wx, wy, inb_x.reshape(P), inb_y.reshape(P)


def _pack_footprint(img: torch.Tensor, width: int) -> torch.Tensor:
    """[P,C] → [P,4C] rows holding each pixel's 2x2 footprint."""
    r1 = torch.roll(img, -1, dims=0)
    rw = torch.roll(img, -width, dims=0)
    rw1 = torch.roll(img, -width - 1, dims=0)
    return torch.cat([img, r1, rw, rw1], dim=1)


class _WarpImages(torch.autograd.Function):
    """Forward ``_warp_fwd``, backward ``_warp_bwd`` (``losses.py:198-231``);
    the gathered footprints are the residuals the coordinate gradients
    reuse."""

    @staticmethod
    def forward(ctx, imgs, coords, width, height):
        K, H, W, C = imgs.shape
        outs, blks = [], []
        for k in range(K):
            packed = _pack_footprint(imgs[k].reshape(H * W, C), width)
            idx, wx, wy, _, _ = _warp_prep(coords[k], width, height)
            blk = packed[idx]
            blks.append(blk)
            top = blk[:, 0 * C:1 * C] * (1 - wx) + blk[:, 1 * C:2 * C] * wx
            bot = blk[:, 2 * C:3 * C] * (1 - wx) + blk[:, 3 * C:4 * C] * wx
            outs.append((top * (1 - wy) + bot * wy).reshape(H, W, C))
        ctx.save_for_backward(coords, torch.stack(blks))
        ctx.size = (width, height)
        return torch.stack(outs)

    @staticmethod
    def backward(ctx, g):
        coords, blks = ctx.saved_tensors
        width, height = ctx.size
        K, H, W, C = g.shape
        P = H * W
        g_img_l, g_coord_l = [], []
        for k in range(K):
            idx, wx, wy, inb_x, inb_y = _warp_prep(coords[k], width, height)
            gk = g[k].reshape(P, C)
            upd = torch.cat([gk * (1 - wx) * (1 - wy), gk * wx * (1 - wy),
                             gk * (1 - wx) * wy, gk * wx * wy], dim=1)
            S = torch.zeros((P, 4 * C), dtype=gk.dtype, device=gk.device)
            S.index_add_(0, idx, upd)
            g_im = (S[:, 0 * C:1 * C]
                    + torch.roll(S[:, 1 * C:2 * C], 1, dims=0)
                    + torch.roll(S[:, 2 * C:3 * C], W, dims=0)
                    + torch.roll(S[:, 3 * C:4 * C], W + 1, dims=0))
            blk = blks[k]
            v00, v10 = blk[:, 0 * C:1 * C], blk[:, 1 * C:2 * C]
            v01, v11 = blk[:, 2 * C:3 * C], blk[:, 3 * C:4 * C]
            dx = (v10 - v00) * (1 - wy) + (v11 - v01) * wy
            dy = (v01 - v00) * (1 - wx) + (v11 - v10) * wx
            gx = (torch.sum(gk * dx, dim=-1)
                  * (inb_x.to(gk.dtype) * (width / (width - 1.0))))
            gy = (torch.sum(gk * dy, dim=-1)
                  * (inb_y.to(gk.dtype) * (height / (height - 1.0))))
            g_img_l.append(g_im.reshape(H, W, C))
            g_coord_l.append(torch.stack([gx, gy], dim=-1).reshape(H, W, 2))
        return torch.stack(g_img_l), torch.stack(g_coord_l), None, None


def warp_images(imgs: torch.Tensor, coords: torch.Tensor,
                width: int, height: int, backend: str = "auto") -> torch.Tensor:
    """Bilinear-warp K images by K pixel-coord maps (see the note above).

    Args:
      imgs: [K, H, W, C].
      coords: [K, H, W, 2] source pixel coordinates (x, y).
      backend: ``"auto"`` (the kernels of ``ops/cuda_warp.py`` for CUDA
        tensors, the plain route for CPU tensors), ``"cuda"`` (the kernels;
        raises for CPU tensors) or ``"plain"``, as ``RasterConfig.backend``.

    Returns:
      [K, H, W, C]; out[k, i, j] = imgs[k] sampled at coords[k, i, j].

    Counters (while counting is on, kernel route only): ``loss.warp_calls``
    one a call, ``loss.warp_images`` K.
    """
    if backend not in ("auto", "cuda", "plain"):
        raise ValueError(f"unknown backend {backend!r}")
    if backend == "cuda" and imgs.device.type != "cuda":
        raise ValueError(f"backend='cuda' needs CUDA tensors, got {imgs.device}")
    if backend == "plain" or imgs.device.type != "cuda":
        return _WarpImages.apply(imgs, coords, width, height)
    if obs.COUNTING:
        obs.count("loss.warp_calls", host_int=1)
        obs.count("loss.warp_images", host_int=imgs.shape[0])
    return cuda_warp.WarpCuda.apply(imgs.contiguous(), coords.contiguous(), width, height)


def flow_warp_loss(ori_image: torch.Tensor, latent_imgs: torch.Tensor,
                   latent_alphas: torch.Tensor, d_alpha: torch.Tensor,
                   exp2mid_coords: torch.Tensor, mid2exp_coords: torch.Tensor,
                   width: int, height: int, backend: str = "auto") -> torch.Tensor:
    """Bidirectional flow-warp photometric consistency (train.py:659-675),
    one view; its 2E warps are one :func:`warp_images` call on ``backend``.

    Args:
      ori_image: [H, W, 3] mid-exposure render.
      latent_imgs: [E, H, W, 3] latent renders at each exposure.
      latent_alphas: [E, H, W] dynamic alphas at each exposure.
      d_alpha: [H, W] mid-time dynamic alpha.
      exp2mid_coords / mid2exp_coords: [E, H, W, 2] pixel coord maps.
    """
    E = latent_imgs.shape[0]
    ori_rep = ori_image[None].expand((E,) + ori_image.shape)
    imgs_all = torch.cat([ori_rep, latent_imgs], dim=0)
    coords_all = torch.cat([exp2mid_coords, mid2exp_coords], dim=0)
    warped = warp_images(imgs_all, coords_all, width, height, backend)

    # the mid render warped to each exposure by the exp→mid coords, against
    # the latent render, masked by the latent dynamic alpha
    t1 = l1_loss(warped[:E], latent_imgs, mask=latent_alphas[..., None])

    # each latent render warped to mid by the mid→exp coords, against the
    # mid render, masked by the mid dynamic alpha
    mask = d_alpha[None, ..., None].expand((E,) + d_alpha.shape + (1,))
    t2 = l1_loss(warped[E:], ori_rep, mask=mask)
    return t1 + t2
