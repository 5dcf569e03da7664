"""The flow-warp loss's bilinear K-warp on the card: ``csrc/warp.cu``'s
forward and backward kernels, their wrappers and their autograd Function.

What it replaces. ``train/losses.py::_WarpImages``, the plain route, loops
in Python over the K warps of a view: ~39 launches a warp forward, ~65
backward, each over a few hundred kilobytes, so the host's dispatch sets
its time. The kernels compute the same function in one launch a call
forward and one backward (with the zero fill of the image gradient): the
forward bit-equal to the plain route (the same operations, rounded one by
one in its order), the backward with atomics, in another order of
summation (``warp.cu``'s note). No Pallas kernel: the JAX package leaves
the warp to XLA.

What bounds them: bytes, ~32 B a (warp, pixel) forward and ~52 B backward
at C=3. The forward saves only the images and the coordinates for the
backward, which recomputes each footprint; the plain route keeps the
gathered [K, H·W, 4C] rows.

``train/losses.py::warp_images`` routes: CUDA tensors here, CPU tensors
(and ``backend="plain"``) to the plain route. The wrappers take float32,
contiguous CUDA tensors of matching shapes and raise on anything else.
"""

from __future__ import annotations

import torch

from mobgs_tpu_torch.ops import cuda_raster

# Launch counts of the two kernels; the wrappers add one per launch and
# nowhere else.
launches = {"warp_fwd": 0, "warp_bwd": 0}


def reset_launches():
    """Set both launch counts to 0."""
    for key in launches:
        launches[key] = 0


def _check(kernel: str, width: int, height: int, imgs, coords, g=None):
    named = [("imgs", imgs), ("coords", coords)] + ([("g", g)] if g is not None else [])
    for name, t in named:
        if t.device.type != "cuda":
            raise ValueError(f"{kernel}: {name} is on {t.device}, not CUDA")
        if t.dtype != torch.float32:
            raise ValueError(f"{kernel}: {name} is {t.dtype}, expected torch.float32")
        if not t.is_contiguous():
            raise ValueError(f"{kernel}: {name} is not contiguous")
        if t.device != imgs.device:
            raise ValueError(f"{kernel}: operands on different devices")
    if imgs.dim() != 4:
        raise ValueError(f"{kernel}: imgs is {tuple(imgs.shape)}, expected [K, H, W, C]")
    K, H, W, C = imgs.shape
    if (H, W) != (height, width) or W < 2 or H < 2 or C < 1:
        raise ValueError(f"{kernel}: imgs is {tuple(imgs.shape)} for a {width}x{height} "
                         f"warp (W, H >= 2 and C >= 1)")
    if tuple(coords.shape) != (K, H, W, 2):
        raise ValueError(f"{kernel}: coords is {tuple(coords.shape)}, expected "
                         f"{(K, H, W, 2)}")
    if g is not None and g.shape != imgs.shape:
        raise ValueError(f"{kernel}: g is {tuple(g.shape)}, expected {tuple(imgs.shape)}")
    if K * H * W >= 2 ** 31:
        raise ValueError(f"{kernel}: K·H·W = {K * H * W} is not below 2^31")


def warp_fwd(imgs: torch.Tensor, coords: torch.Tensor, width: int,
             height: int) -> torch.Tensor:
    """imgs [K, H, W, C] sampled at coords [K, H, W, 2] (source pixel
    coordinates), one launch on the current stream; returns [K, H, W, C]."""
    _check("warp_fwd", width, height, imgs, coords)
    K, H, W, C = imgs.shape
    out = torch.empty_like(imgs)
    dev = imgs.device
    with torch.cuda.device(dev):
        err = cuda_raster._library("warp").warp_fwd(
            imgs.data_ptr(), coords.data_ptr(), out.data_ptr(), K, H, W, C,
            cuda_raster._stream(dev))
    if err != 0:
        raise RuntimeError(f"warp_fwd launch failed: CUDA error {err}")
    launches["warp_fwd"] += 1
    return out


def warp_bwd(imgs: torch.Tensor, coords: torch.Tensor, g: torch.Tensor,
             width: int, height: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The gradients of :func:`warp_fwd`'s output ``g`` with respect to
    imgs and coords, one launch (after the zero fill of the first) on the
    current stream."""
    _check("warp_bwd", width, height, imgs, coords, g)
    K, H, W, C = imgs.shape
    g_img = torch.zeros_like(imgs)
    g_coord = torch.empty_like(coords)
    dev = imgs.device
    with torch.cuda.device(dev):
        err = cuda_raster._library("warp").warp_bwd(
            imgs.data_ptr(), coords.data_ptr(), g.data_ptr(), g_img.data_ptr(),
            g_coord.data_ptr(), K, H, W, C, cuda_raster._stream(dev))
    if err != 0:
        raise RuntimeError(f"warp_bwd launch failed: CUDA error {err}")
    launches["warp_bwd"] += 1
    return g_img, g_coord


class WarpCuda(torch.autograd.Function):
    """The kernels' route: :func:`warp_fwd`, :func:`warp_bwd`."""

    @staticmethod
    def forward(ctx, imgs, coords, width, height):
        out = warp_fwd(imgs, coords, width, height)
        ctx.save_for_backward(imgs, coords)
        ctx.size = (width, height)
        return out

    @staticmethod
    def backward(ctx, g):
        imgs, coords = ctx.saved_tensors
        g_img, g_coord = warp_bwd(imgs, coords, g.contiguous(), *ctx.size)
        return g_img, g_coord, None, None
