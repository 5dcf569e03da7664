"""Warm-stage pose network (port of ``mobgs_tpu/models/posenet.py``, the
reference's ``scene/deformation.py:306-417``).

A time→pose MLP: positional-encoded time through two 256-wide trunks to a
6-DoF head (euler rotation + translation), a per-frame depth scale
(``instance_scale_list``), a learned ``focal_bias`` and a pixel-wise
depth-refinement MLP. The reference builds it for the legacy warm path and
the MoBGS training flow never calls it: it is here for the inventory and
the checkpoint layout. Parameters are a NamedTuple of tensors, as
``BLCEParams``; linears keep the JAX layout, ``x @ w + b``.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from mobgs_tpu_torch import resolve_device

TIMEBASE_PE = 10
TIMENET_WIDTH = 256
TIMENET_OUTPUT = 6
PIXEL_BASE_PE = 5


def euler2mat(angle: torch.Tensor) -> torch.Tensor:
    """Euler [B, 3] (x, y, z radians) → rotation matrices [B, 3, 3],
    composed xmat @ ymat @ zmat (the reference's deformation.py:441-478)."""
    x, y, z = angle[:, 0], angle[:, 1], angle[:, 2]
    cz, sz = torch.cos(z), torch.sin(z)
    cy, sy = torch.cos(y), torch.sin(y)
    cx, sx = torch.cos(x), torch.sin(x)
    zeros = torch.zeros_like(z)
    ones = torch.ones_like(z)
    zmat = torch.stack([cz, -sz, zeros, sz, cz, zeros, zeros, zeros, ones],
                       dim=1).reshape(-1, 3, 3)
    ymat = torch.stack([cy, zeros, sy, zeros, ones, zeros, -sy, zeros, cy],
                       dim=1).reshape(-1, 3, 3)
    xmat = torch.stack([ones, zeros, zeros, zeros, cx, -sx, zeros, sx, cx],
                       dim=1).reshape(-1, 3, 3)
    return xmat @ ymat @ zmat


def poc_fre(x: torch.Tensor, poc: torch.Tensor) -> torch.Tensor:
    """Positional encoding [x ‖ sin(x·2^i) ‖ cos(x·2^i)]."""
    emb = (x[..., None] * poc).reshape(*x.shape[:-1], -1)
    return torch.cat([x, torch.sin(emb), torch.cos(emb)], dim=-1)


class PoseNetParams(NamedTuple):
    # trunks: tuples of (w [in, out], b [out])
    timenet0: tuple
    timenet1: tuple
    timenet_out_w: torch.Tensor       # [W, 6], init 1e-6
    depth_scale_out_w: torch.Tensor   # [W, 1]
    depth_net: tuple
    depth_out_w: torch.Tensor         # [W, 1]
    focal_bias: torch.Tensor          # [1], init log(500)
    instance_scale: torch.Tensor      # [V, 1], init 1.0
    max_time: float
    H: int
    W: int


def _linear(generator, fan_in: int, fan_out: int, device):
    """xavier_uniform (gain 1) for the weight, the same bound for the bias
    (``posenet.py:70-75``)."""
    lim = math.sqrt(6.0 / (fan_in + fan_out))

    def uniform(shape):
        u = torch.rand(shape, generator=generator, dtype=torch.float32,
                       device=device)
        return u * (2 * lim) - lim

    return uniform((fan_in, fan_out)), uniform((fan_out,))


def init_posenet(generator: torch.Generator | None, num_views: int,
                 height: int, width: int, max_time: float,
                 device: str | torch.device | None = None) -> PoseNetParams:
    """The JAX package's shapes and laws (``posenet.py:78-94``), drawn from
    ``generator`` on ``device`` (the card unless ``"cpu"``)."""
    dev = resolve_device(device)
    times_ch = 2 * TIMEBASE_PE + 1
    pixel_ch = 2 * (2 * PIXEL_BASE_PE + 1)
    Wn = TIMENET_WIDTH

    def lin(d_in, d_out):
        return _linear(generator, d_in, d_out, dev)

    return PoseNetParams(
        timenet0=(lin(times_ch, Wn), lin(Wn, Wn)),
        timenet1=(lin(Wn + times_ch, Wn), lin(Wn, Wn)),
        timenet_out_w=torch.full((Wn, TIMENET_OUTPUT), 1e-6,
                                 dtype=torch.float32, device=dev),
        depth_scale_out_w=lin(Wn, 1)[0],
        depth_net=tuple(lin(d_in, Wn)
                        for d_in in (times_ch + pixel_ch + 1 + 3, Wn, Wn, Wn)),
        depth_out_w=lin(Wn, 1)[0],
        focal_bias=torch.tensor([math.log(500.0)], dtype=torch.float32,
                                device=dev),
        instance_scale=torch.ones((num_views, 1), dtype=torch.float32,
                                  device=dev),
        max_time=float(max_time), H=height, W=width)


def _mlp(layers, x):
    for w, b in layers:
        x = torch.relu(x @ w + b)
    return x


def posenet_forward(p: PoseNetParams, times_sel: torch.Tensor,
                    depth: torch.Tensor | None = None):
    """``pose_network.forward`` (``posenet.py:103-125``).

    times_sel [B] → (R [B, 3, 3], t [B, 3]) and, when depth [B, H*W] is
    given, the instance-scaled CVD depth [B, 1, H, W]. The frame index
    truncates toward zero, then is clipped to the views; the first view's
    scale, the canonical one, takes no gradient."""
    time_poc = 2.0 ** torch.arange(TIMEBASE_PE, dtype=torch.float32,
                                   device=times_sel.device)
    temb = poc_fre(times_sel[:, None], time_poc)          # [B, times_ch]
    h = _mlp(p.timenet0, temb)
    h = _mlp(p.timenet1, torch.cat([h, temb], dim=1))
    pose = h @ p.timenet_out_w                           # [B, 6]
    R = euler2mat(pose[:, 0:3])
    t = pose[:, 3:]
    if depth is None:
        return R, t

    idx = torch.clamp((times_sel * p.max_time).to(torch.int32), 0,
                      p.instance_scale.shape[0] - 1)
    scale = p.instance_scale[idx.long()]                 # [B, 1]
    scale = scale / p.instance_scale[0].detach()[None]
    cvd = depth.reshape(-1, 1, p.H, p.W) * scale[:, :, None, None]
    return R, t, cvd
