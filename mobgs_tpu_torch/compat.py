"""gsplat-compatible API shim (port of ``mobgs_tpu/compat.py``).

``rasterization(...)`` and ``fully_fused_projection(...)`` with the gsplat
v1.4 call signatures the reference uses (its ``gaussian_renderer/
__init__.py:15`` imports them), on the port's pipeline, so code written
against gsplat ports mechanically. ``rasterization`` composites through
``ops/rasterize.py::rasterize``: on CUDA tensors the hand-written forward
kernel and, under autograd, the backward.

The supported surface is what MoBGS calls: packed=False, one camera,
render_mode "RGB" or "RGB+ED", backgrounds optional, C ∈ {1, 2, 3, 9}; the
info dict carries "means2d" and "radii".
"""

from __future__ import annotations

import torch

from mobgs_tpu_torch.ops import projection as _proj
from mobgs_tpu_torch.ops.rasterize import RasterConfig, rasterize as _rasterize

CHANNELS = (1, 2, 3, 9)


def rasterization(means, quats, scales, opacities, colors,
                  viewmats, Ks, width, height,
                  backgrounds=None, packed=False, render_mode="RGB",
                  config: RasterConfig = RasterConfig()):
    """``gsplat.rendering.rasterization`` for one camera.

    Returns (render [1, H, W, C(+1)], alpha [1, H, W, 1], info dict);
    "RGB+ED" appends the expected depth as the last channel, so the
    composite is C + 2 columns wide (colours ‖ depth ‖ 1)."""
    if packed:
        raise ValueError("packed mode is not used by the reference")
    if viewmats.shape[0] != 1:
        raise ValueError(f"one camera is supported, got {viewmats.shape[0]}")
    if colors.shape[-1] not in CHANNELS:
        raise ValueError(f"C={colors.shape[-1]} is not one of {CHANNELS}")
    if render_mode not in ("RGB", "RGB+ED"):
        raise NotImplementedError(render_mode)
    bg = backgrounds[0] if backgrounds is not None else None
    out = _rasterize(means, quats, scales, opacities, colors,
                     viewmats[0], Ks[0], int(width), int(height),
                     background=bg, config=config)
    img = out.images[0]
    if render_mode == "RGB+ED":
        img = torch.cat([img, out.depths[0][..., None]], dim=-1)
    alpha = out.alphas[0][None, ..., None]
    info = {"means2d": out.means2d[None], "radii": out.radii[None]}
    return img[None], alpha, info


def fully_fused_projection(means, covars, quats, scales, viewmats, Ks,
                           width, height,
                           config: RasterConfig = RasterConfig()):
    """``gsplat.rendering.fully_fused_projection``: the 5-tuple the
    reference destructures as ``(_, means2d, _, _, _)``."""
    if covars is not None:
        raise ValueError("the covars path is not used by the reference")
    splats = _proj.project(means, quats, scales, viewmats[0], Ks[0],
                           int(width), int(height), eps2d=config.eps2d,
                           near=config.near, sigma_cut=config.sigma_cut)
    return (splats.radii[None], splats.means2d[None], splats.depths[None],
            splats.conics[None], None)
