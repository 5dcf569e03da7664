"""Deformation field (port of ``mobgs_tpu/models/deformation.py``): HexPlane
features → MLP heads.

The reference instantiates the 4DGS deformation net and saves it as
``deformation.pth``, but MoBGS's fine stage drives motion with the spline
and never renders through it, so its weights never change
(``train/step.py:51-56`` of the JAX package). The field is complete all
the same: the positional encoding, the ``feature_out`` MLP, the
pos/scales/rotations heads with the reference's post-processing (the
quaternion rotation of positions, the scale clamp at log 100, the
quaternion composition of rotations) and the plane regularizers. Linears
keep the JAX layout, ``x @ w + b`` with w [fan_in, fan_out].
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from mobgs_tpu_torch import resolve_device
from mobgs_tpu_torch.core.se3 import quat_multiply, quat_to_rotmat
from mobgs_tpu_torch.models import hexplane as HP


class MLPParams(NamedTuple):
    ws: tuple
    bs: tuple


class DeformationParams(NamedTuple):
    grid: HP.HexPlaneParams
    feature_out: MLPParams       # grid_feat -> W (+ D-1 hidden)
    pos_deform: MLPParams        # W -> W -> 7 (dx3 + quat4)
    scales_deform: MLPParams     # W -> W -> 3
    rotations_deform: MLPParams  # W -> W -> 4
    timenet: MLPParams           # 2*timebase_pe+1 -> timenet_width -> out


def _init_mlp(generator: torch.Generator | None, dims,
              device: torch.device) -> MLPParams:
    """torch ``nn.Linear``'s U(±1/√fan_in) for weights and biases."""
    ws, bs = [], []
    for i in range(len(dims) - 1):
        bound = 1.0 / math.sqrt(dims[i])

        def uniform(shape):
            u = torch.rand(shape, generator=generator, dtype=torch.float32,
                           device=device)
            return u * (2 * bound) - bound

        ws.append(uniform((dims[i], dims[i + 1])))
        bs.append(uniform((dims[i + 1],)))
    return MLPParams(ws=tuple(ws), bs=tuple(bs))


def init_deformation(generator: torch.Generator | None, hidden_cfg,
                     device: str | torch.device | None = None) -> DeformationParams:
    """hidden_cfg: a ``ModelHiddenParams`` (bounds, kplanes_config,
    multires, net_width, defor_depth, timebase_pe, timenet_width,
    timenet_output). The JAX package's shapes and laws
    (``deformation.py:64-83``), drawn from ``generator`` on ``device``."""
    dev = resolve_device(device)
    grid = HP.init_hexplane(generator, hidden_cfg.bounds,
                            hidden_cfg.kplanes_config,
                            list(hidden_cfg.multires), device=dev)
    W = hidden_cfg.net_width
    D = hidden_cfg.defor_depth
    feature_dims = [HP.feat_dim(grid)] + [W] * D
    times_ch = 2 * hidden_cfg.timebase_pe + 1
    return DeformationParams(
        grid=grid,
        feature_out=_init_mlp(generator, feature_dims, dev),
        pos_deform=_init_mlp(generator, [W, W, 7], dev),
        scales_deform=_init_mlp(generator, [W, W, 3], dev),
        rotations_deform=_init_mlp(generator, [W, W, 4], dev),
        timenet=_init_mlp(generator, [times_ch, hidden_cfg.timenet_width,
                                      hidden_cfg.timenet_output], dev),
    )


def _apply_mlp(p: MLPParams, x: torch.Tensor, relu_first: bool = False):
    h = x
    for i, (w, b) in enumerate(zip(p.ws, p.bs)):
        if relu_first or i > 0:
            h = torch.relu(h)
        h = h @ w + b
    return h


def poc_fre(x: torch.Tensor, poc_buf: torch.Tensor) -> torch.Tensor:
    """Positional encoding [x ‖ sin(x·2^k) ‖ cos(x·2^k)] (the reference's
    ``deformation.py:794-799``)."""
    xp = x[..., None] * poc_buf  # [..., C, L]
    s = torch.sin(xp).reshape(*x.shape[:-1], -1)
    c = torch.cos(xp).reshape(*x.shape[:-1], -1)
    return torch.cat([x, s, c], dim=-1)


def apply_deformation(params: DeformationParams, xyz: torch.Tensor,
                      scales: torch.Tensor, rotations: torch.Tensor, t):
    """Deform (xyz, scales, rotations) at time t (``deformation.py:95-120``).

    xyz [N, 3]; scales [N, 3] (log); rotations [N, 4]; t a scalar or [N].
    Returns (xyz', scales', rotations')."""
    N = xyz.shape[0]
    tcol = torch.as_tensor(t, dtype=torch.float32,
                           device=xyz.device).reshape(-1, 1).expand(N, 1)
    feat = HP.query(params.grid, xyz, tcol)
    hidden = _apply_mlp(params.feature_out, feat)

    dx = _apply_mlp(params.pos_deform, hidden, relu_first=True)  # [N, 7]
    pts = xyz + dx[:, 0:3]
    R = quat_to_rotmat(dx[:, 3:7])
    pts = torch.einsum("nij,nj->ni", R, pts)

    ds = _apply_mlp(params.scales_deform, hidden, relu_first=True)
    ds = torch.minimum(ds, torch.tensor(math.log(100.0), dtype=ds.dtype,
                                        device=ds.device))
    new_scales = scales + ds

    dr = _apply_mlp(params.rotations_deform, hidden, relu_first=True)
    new_rot = quat_multiply(rotations, dr)
    return pts, new_scales, new_rot


def regulation_loss(params: DeformationParams, time_smoothness_weight: float,
                    l1_time_planes_weight: float,
                    plane_tv_weight: float) -> torch.Tensor:
    """``compute_regulation`` (the reference's ``gaussian_model.py:1414-1415``)."""
    return (plane_tv_weight * HP.plane_regulation(params.grid)
            + time_smoothness_weight * HP.time_regulation(params.grid)
            + l1_time_planes_weight * HP.l1_time_regulation(params.grid))
