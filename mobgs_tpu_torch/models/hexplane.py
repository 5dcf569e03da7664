"""HexPlane (K-planes) feature-field parameters (port of the containers of
``mobgs_tpu/models/hexplane.py``).

Six planes, the C(4, 2) pairs of (x, y, z, t), per multiresolution scale;
the planes that carry time start at 1, the spatial planes at U(0.1, 0.5).
The fine stage never queries the field: the train CLI carries it for the
``deformation.pth`` checkpoint (``cli/train.py:168-176``). The query and
the plane regularizers are not ported yet.
"""

from __future__ import annotations

import itertools
from typing import NamedTuple

import torch

from mobgs_tpu_torch import resolve_device

COO_COMBS = list(itertools.combinations(range(4), 2))
# indices of time-carrying planes within COO_COMBS: (0,3), (1,3), (2,3)
TIME_PLANE_IDS = [i for i, c in enumerate(COO_COMBS) if 3 in c]


class HexPlaneParams(NamedTuple):
    grids: tuple          # per scale: a tuple of 6 tensors [C, r2, r1]
    aabb: torch.Tensor    # [2, 3] (max, min), the reference's order


def init_hexplane(generator: torch.Generator | None, bounds: float,
                  config: dict, multires: list[int],
                  device: str | torch.device | None = None) -> HexPlaneParams:
    """The JAX package's init law (``hexplane.py:31-50``), drawn from
    ``generator`` on ``device`` (the card unless ``"cpu"``): plane shape
    [C, reso[comb[1]], reso[comb[0]]], the spatial resolutions times the
    scale's multiplier."""
    dev = resolve_device(device)
    out_dim = config["output_coordinate_dim"]
    base_res = config["resolution"]
    scales = []
    for res_mult in multires:
        reso = [r * res_mult for r in base_res[:3]] + list(base_res[3:])
        planes = []
        for comb in COO_COMBS:
            shape = (out_dim, reso[comb[1]], reso[comb[0]])
            if 3 in comb:
                g = torch.ones(shape, dtype=torch.float32, device=dev)
            else:
                u = torch.rand(shape, generator=generator, dtype=torch.float32,
                               device=dev)
                g = 0.1 + 0.4 * u
            planes.append(g)
        scales.append(tuple(planes))
    aabb = torch.tensor([[bounds] * 3, [-bounds] * 3], dtype=torch.float32,
                        device=dev)
    return HexPlaneParams(grids=tuple(scales), aabb=aabb)


def feat_dim(params: HexPlaneParams) -> int:
    return sum(s[0].shape[0] for s in params.grids)


def set_aabb(params: HexPlaneParams, xyz_max, xyz_min) -> HexPlaneParams:
    aabb = torch.as_tensor([list(map(float, xyz_max)), list(map(float, xyz_min))],
                           dtype=torch.float32, device=params.aabb.device)
    return params._replace(aabb=aabb)
