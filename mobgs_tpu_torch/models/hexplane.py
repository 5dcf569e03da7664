"""HexPlane (K-planes) feature-field parameters (port of the containers of
``mobgs_tpu/models/hexplane.py``).

Six planes, the C(4, 2) pairs of (x, y, z, t), per multiresolution scale;
the planes that carry time start at 1, the spatial planes at U(0.1, 0.5);
bilinear sampling (align_corners=True, border padding), the product over
the planes in ``COO_COMBS`` order, the concatenation over scales; and the
plane regularizers of ``compute_regulation``. The fine stage never queries
the field: the train CLI carries it for the ``deformation.pth`` checkpoint
(``cli/train.py:168-176``).
"""

from __future__ import annotations

import itertools
from typing import NamedTuple

import torch

from mobgs_tpu_torch import resolve_device

COO_COMBS = list(itertools.combinations(range(4), 2))
# indices of time-carrying planes within COO_COMBS: (0,3), (1,3), (2,3)
TIME_PLANE_IDS = [i for i, c in enumerate(COO_COMBS) if 3 in c]
SPATIAL_PLANE_IDS = [i for i, c in enumerate(COO_COMBS) if 3 not in c]


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


def _bilinear_ac(grid: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """align_corners=True bilinear sample with border padding
    (``hexplane.py:61-79``): grid [C, H, W], uv [N, 2] in [-1, 1] (x
    indexes W, y indexes H) → [N, C]."""
    C, H, W = grid.shape
    x = (uv[:, 0] + 1.0) * 0.5 * (W - 1)
    y = (uv[:, 1] + 1.0) * 0.5 * (H - 1)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    wx = x - x0
    wy = y - y0

    flat = grid.reshape(C, H * W)

    def at(iy, ix):
        iy = torch.clamp(iy.to(torch.int64), 0, H - 1)
        ix = torch.clamp(ix.to(torch.int64), 0, W - 1)
        # index_select's backward is an index_add_; advanced indexing's is
        # a sorted index_put_ that serialises repeated taps (points
        # clamped onto a face of the aabb, a plane's one time row)
        return torch.index_select(flat, 1, iy * W + ix)  # [C, N]

    top = at(y0, x0) * (1 - wx) + at(y0, x0 + 1) * wx
    bot = at(y0 + 1, x0) * (1 - wx) + at(y0 + 1, x0 + 1) * wx
    return (top * (1 - wy) + bot * wy).T


def query(params: HexPlaneParams, pts: torch.Tensor,
          t: torch.Tensor) -> torch.Tensor:
    """Sample features (``hexplane.py:82-110``). pts [N, 3] world, t [N, 1]
    in [0, 1] → [N, feat_dim] (concatenated over scales, the product over
    planes).

    The reference's normalisation, exactly: ``(pts - aabb[0]) · 2 /
    (aabb[1] - aabb[0]) - 1`` with aabb = [max, min], so the coordinate
    comes out mirrored (1 - 2u); planes loaded from a reference
    ``deformation.pth`` sample flipped without it. Time goes in raw, in
    [0, 1], and border padding covers it."""
    amax, amin = params.aabb[0], params.aabb[1]
    ptsn = (pts - amax) * (2.0 / (amin - amax)) - 1.0
    # jnp.clip's minimum(maximum(.)): a point on a face takes half the gradient
    one = torch.ones((), dtype=ptsn.dtype, device=ptsn.device)
    ptsn = torch.minimum(torch.maximum(ptsn, -one), one)
    coords = torch.cat([ptsn, t.reshape(-1, 1)], dim=1)   # [N, 4]
    feats = []
    for planes in params.grids:
        interp = 1.0
        # COO_COMBS order: float32 products are not associative
        for ci, comb in enumerate(COO_COMBS):
            interp = interp * _bilinear_ac(planes[ci], coords[:, list(comb)])
        feats.append(interp)
    return torch.cat(feats, dim=-1)


def plane_smoothness(grid: torch.Tensor) -> torch.Tensor:
    """Second-difference smoothness along the row (time) axis (the
    reference's ``scene/regulation.py:22-28``)."""
    d1 = grid[..., 1:, :] - grid[..., :-1, :]
    d2 = d1[..., 1:, :] - d1[..., :-1, :]
    return torch.mean(torch.square(d2))


def plane_regulation(params: HexPlaneParams) -> torch.Tensor:
    """Spatial-plane smoothness (``_plane_regulation``)."""
    total = 0.0
    for planes in params.grids:
        for i in SPATIAL_PLANE_IDS:
            total = total + plane_smoothness(planes[i])
    return total


def time_regulation(params: HexPlaneParams) -> torch.Tensor:
    """Time-plane smoothness (``_time_regulation``)."""
    total = 0.0
    for planes in params.grids:
        for i in TIME_PLANE_IDS:
            total = total + plane_smoothness(planes[i])
    return total


def l1_time_regulation(params: HexPlaneParams) -> torch.Tensor:
    """L1 pull of the time planes to 1 (``_l1_regulation``)."""
    total = 0.0
    for planes in params.grids:
        for i in TIME_PLANE_IDS:
            total = total + torch.mean(torch.abs(1.0 - planes[i]))
    return total
