"""Dense 3D feature grid (port of ``mobgs_tpu/models/grid.py``, the
reference's ``scene/grid.py::DenseGrid``).

Off in the reference's defaults (``empty_voxel=False``) but part of its
component inventory: a trilinear grid with ``align_corners=True``
semantics, aabb normalisation, a trilinear capacity rescale, and the ``-=``
of the coarse density pruning path. Parameters are a NamedTuple; queries
are eight gathers and a weighted sum, the JAX package's formulation, not
``F.grid_sample``, whose gradient at integer coordinates and at the faces
differs.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from mobgs_tpu_torch import resolve_device


class DenseGridParams(NamedTuple):
    grid: torch.Tensor      # [C, X, Y, Z]
    xyz_min: torch.Tensor   # [3]
    xyz_max: torch.Tensor   # [3]


def init_dense_grid(channels: int, world_size, fill: float = 1.0,
                    xyz_min=None, xyz_max=None,
                    device: str | torch.device | None = None) -> DenseGridParams:
    """The reference's ``torch.ones([1, C, *world_size])`` (as a constant
    ``fill``), the aabb [0, 1]^3 unless given (``grid.py:28-38``)."""
    dev = resolve_device(device)
    X, Y, Z = world_size

    def vec(v, default):
        return torch.as_tensor(default if v is None else v, dtype=torch.float32,
                               device=dev)

    return DenseGridParams(
        grid=torch.full((channels, X, Y, Z), fill, dtype=torch.float32, device=dev),
        xyz_min=vec(xyz_min, [0.0, 0.0, 0.0]),
        xyz_max=vec(xyz_max, [1.0, 1.0, 1.0]))


def set_aabb(params: DenseGridParams, xyz_max, xyz_min) -> DenseGridParams:
    dev = params.grid.device
    return params._replace(
        xyz_min=torch.as_tensor(xyz_min, dtype=torch.float32, device=dev),
        xyz_max=torch.as_tensor(xyz_max, dtype=torch.float32, device=dev))


def _trilinear(grid: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Sample grid [C, X, Y, Z] at continuous indices u [..., 3] (index
    units, 0..dim-1) with border clamping (``grid.py:46-70``). u is clipped
    to [0, dim - 1] and the base index to [0, dim - 2], so at the upper face
    the fraction is 1 and the whole weight goes to the far tap. Returns
    [..., C]."""
    shape = torch.tensor(grid.shape[1:], dtype=torch.int64, device=grid.device)
    dims = shape.to(torch.float32)
    # jnp.clip's minimum(maximum(.)), whose gradient splits at a tie
    u = torch.minimum(torch.maximum(u, torch.zeros_like(dims)), dims - 1.0)
    i0 = torch.floor(u).to(torch.int64)
    i0 = torch.clamp(torch.minimum(i0, shape - 2), min=0)
    f = u - i0.to(torch.float32)                         # [..., 3]

    C, X, Y, Z = grid.shape
    flat = grid.reshape(C, X * Y * Z)

    def tap(dx, dy, dz):
        # index_select, whose backward is an index_add_ (hexplane._bilinear_ac)
        lin = ((i0[..., 0] + dx) * Y + i0[..., 1] + dy) * Z + i0[..., 2] + dz
        v = torch.index_select(flat, 1, lin.reshape(-1)).reshape(C, *lin.shape)
        w = ((f[..., 0] if dx else 1 - f[..., 0])
             * (f[..., 1] if dy else 1 - f[..., 1])
             * (f[..., 2] if dz else 1 - f[..., 2]))
        return v * w[None]

    out = sum(tap(dx, dy, dz)
              for dx in (0, 1) for dy in (0, 1) for dz in (0, 1))
    return torch.movedim(out, 0, -1)                     # [..., C]


def query(params: DenseGridParams, xyz: torch.Tensor) -> torch.Tensor:
    """``DenseGrid.forward``: normalise by the aabb and sample trilinearly;
    xyz [..., 3] → [..., C]."""
    t = (xyz - params.xyz_min) / (params.xyz_max - params.xyz_min)
    dims = torch.tensor(params.grid.shape[1:], dtype=torch.float32,
                        device=params.grid.device)
    return _trilinear(params.grid, t * (dims - 1.0))    # align_corners


def scale_volume_grid(params: DenseGridParams,
                      new_world_size) -> DenseGridParams:
    """``scale_volume_grid``: a trilinear resize with align_corners, i.e.
    the old grid sampled at the new lattice."""
    ax = [torch.linspace(0.0, d - 1.0, n, device=params.grid.device)
          for d, n in zip(params.grid.shape[1:], new_world_size)]
    u = torch.stack(torch.meshgrid(*ax, indexing="ij"), dim=-1)  # [X, Y, Z, 3]
    return params._replace(grid=torch.movedim(_trilinear(params.grid, u), -1, 0))


def isub(params: DenseGridParams, val) -> DenseGridParams:
    """``__isub__``, functional."""
    return params._replace(grid=params.grid - val)
