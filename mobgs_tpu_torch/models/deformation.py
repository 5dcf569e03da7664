"""Deformation-network parameters (port of the containers of
``mobgs_tpu/models/deformation.py``).

The reference instantiates the 4DGS deformation net (HexPlane features →
MLP heads) and saves it as ``deformation.pth``, but MoBGS's fine stage
drives motion with the spline and never renders through it, so its
weights never change (``train/step.py:51-56`` of the JAX package). The
port carries the parameters for the checkpoints; ``apply_deformation``
and ``regulation_loss`` are not ported yet. Linears keep the JAX layout,
``x @ w + b`` with w [fan_in, fan_out].
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from mobgs_tpu_torch import resolve_device
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
