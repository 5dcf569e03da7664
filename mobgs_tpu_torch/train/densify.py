"""Densification statistics (port of the part of
``mobgs_tpu/train/densify.py`` the train step feeds). Clone, split, prune
and pool growth come with the host-loop slice."""

from __future__ import annotations

from typing import NamedTuple

import torch

from mobgs_tpu_torch import resolve_device


class DensifyStats(NamedTuple):
    xyz_grad_accum: torch.Tensor  # [M]
    denom: torch.Tensor           # [M]
    max_radii2d: torch.Tensor     # [M]


def init_stats(capacity: int, device=None) -> DensifyStats:
    dev = resolve_device(device)
    return DensifyStats(*(torch.zeros((capacity,), dtype=torch.float32,
                                      device=dev) for _ in range(3)))


def add_stats(stats: DensifyStats, means2d_grad: torch.Tensor,
              radii: torch.Tensor, visible: torch.Tensor) -> DensifyStats:
    """Accumulate view-space gradient norms and max radii (reference
    train.py:809-817, gaussian_model.py:1352-1355)."""
    gnorm = torch.linalg.norm(means2d_grad, dim=-1)
    vis = visible.to(torch.float32)
    return DensifyStats(
        xyz_grad_accum=stats.xyz_grad_accum + gnorm * vis,
        denom=stats.denom + vis,
        max_radii2d=torch.maximum(stats.max_radii2d,
                                  radii.to(torch.float32) * vis),
    )
