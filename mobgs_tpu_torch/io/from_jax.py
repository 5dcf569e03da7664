"""Carry weights and training state across from the JAX package.

The JAX NamedTuples' fields arrive as numpy arrays keyed by field name
(``GaussianState._fields``, ``SandwichParams._fields``, ...); a nested
NamedTuple arrives as a nested dict of the same shape. The caller does the
``np.asarray`` on the JAX side, so this module never imports JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from mobgs_tpu_torch import resolve_device
from mobgs_tpu_torch.models.blce import BLCE_FIELDS, BLCEParams, BLCEState
from mobgs_tpu_torch.models.deformation import DeformationParams, MLPParams
from mobgs_tpu_torch.models.grid import DenseGridParams
from mobgs_tpu_torch.models.hexplane import HexPlaneParams
from mobgs_tpu_torch.models.gaussians import DIFF_FIELDS, GaussianState
from mobgs_tpu_torch.models.posenet import PoseNetParams
from mobgs_tpu_torch.models.sandwich import SandwichParams
from mobgs_tpu_torch.train.densify import DensifyStats
from mobgs_tpu_torch.train.optim import AdamState
from mobgs_tpu_torch.train.step import TrainState


def _tensors(fields: dict, names, device) -> dict:
    dev = resolve_device(device)
    missing = set(names) - set(fields)
    if missing:
        raise ValueError(f"missing fields {sorted(missing)}")
    return {k: torch.as_tensor(np.array(fields[k]), device=dev) for k in names}


def gaussian_state_from_numpy(fields: dict, device=None) -> GaussianState:
    return GaussianState(**_tensors(fields, GaussianState._fields, device))


def sandwich_from_numpy(fields: dict, device=None) -> SandwichParams:
    return SandwichParams(**_tensors(fields, SandwichParams._fields, device))


def blce_from_numpy(fields: dict, device=None) -> BLCEState:
    """``{"params": {BLCEParams fields}, "exposure_expo": [V]}``."""
    params = BLCEParams(**_tensors(fields["params"], BLCE_FIELDS, device))
    expo = _tensors(fields, ("exposure_expo",), device)["exposure_expo"]
    return BLCEState(params, expo)


def adam_from_numpy(fields: dict, names, device=None) -> AdamState:
    """``{"mu": {name: array}, "nu": {...}, "step": int}``, the moments
    ordered as ``names`` (the parameter group's field order)."""
    mu = _tensors(fields["mu"], names, device)
    nu = _tensors(fields["nu"], names, device)
    return AdamState(mu=tuple(mu[n] for n in names),
                     nu=tuple(nu[n] for n in names),
                     step=int(np.asarray(fields["step"])))


def _items(node) -> list:
    """A tuple node: a sequence, or a dict keyed "0", "1", ... (the
    pytree path's index)."""
    if isinstance(node, dict):
        return [node[str(i)] for i in range(len(node))]
    return list(node)


def deformation_from_numpy(fields: dict, device=None) -> DeformationParams:
    """``{"grid": {"grids": [[plane] * 6] * scales, "aabb": [2, 3]},
    "feature_out": {"ws": [...], "bs": [...]}, ...}`` (tuples as sequences
    or as dicts keyed by index) → DeformationParams on ``device``."""
    dev = resolve_device(device)

    def on(x):
        return torch.as_tensor(np.array(x), device=dev)

    def mlp(node):
        return MLPParams(ws=tuple(on(w) for w in _items(node["ws"])),
                         bs=tuple(on(b) for b in _items(node["bs"])))

    grid = HexPlaneParams(
        grids=tuple(tuple(on(p) for p in _items(scale))
                    for scale in _items(fields["grid"]["grids"])),
        aabb=on(fields["grid"]["aabb"]))
    return DeformationParams(grid=grid, **{
        f: mlp(fields[f]) for f in DeformationParams._fields if f != "grid"})


def posenet_from_numpy(fields: dict, device=None) -> PoseNetParams:
    """A JAX ``PoseNetParams`` as a nested dict (the trunks as sequences of
    (w, b) pairs, or dicts keyed by index) → PoseNetParams on ``device``;
    ``max_time``, ``H`` and ``W`` stay Python numbers."""
    dev = resolve_device(device)

    def on(x):
        return torch.as_tensor(np.array(x), device=dev)

    def layers(node):
        return tuple(tuple(on(a) for a in _items(pair)) for pair in _items(node))

    return PoseNetParams(
        timenet0=layers(fields["timenet0"]), timenet1=layers(fields["timenet1"]),
        depth_net=layers(fields["depth_net"]),
        **{f: on(fields[f]) for f in ("timenet_out_w", "depth_scale_out_w",
                                      "depth_out_w", "focal_bias", "instance_scale")},
        max_time=float(np.asarray(fields["max_time"])),
        H=int(np.asarray(fields["H"])), W=int(np.asarray(fields["W"])))


def dense_grid_from_numpy(fields: dict, device=None) -> DenseGridParams:
    return DenseGridParams(**_tensors(fields, DenseGridParams._fields, device))


def train_state_from_numpy(fields: dict, device=None) -> TrainState:
    """A JAX ``TrainState`` as a nested dict of numpy arrays (one dict per
    NamedTuple, keyed by its fields) → the port's TrainState, moments,
    step counter and the carried ``deform`` net (when present) included."""
    stats = {k: DensifyStats(**_tensors(fields[k], DensifyStats._fields, device))
             for k in ("stat_stats", "dyn_stats")}
    return TrainState(
        stat=gaussian_state_from_numpy(fields["stat"], device),
        dyn=gaussian_state_from_numpy(fields["dyn"], device),
        sandwich=sandwich_from_numpy(fields["sandwich"], device),
        blce=blce_from_numpy(fields["blce"], device),
        stat_opt=adam_from_numpy(fields["stat_opt"], DIFF_FIELDS, device),
        dyn_opt=adam_from_numpy(fields["dyn_opt"], DIFF_FIELDS, device),
        sandwich_opt=adam_from_numpy(fields["sandwich_opt"],
                                     SandwichParams._fields, device),
        blce_opt=adam_from_numpy(fields["blce_opt"], BLCE_FIELDS, device),
        step=int(np.asarray(fields["step"])),
        deform=(deformation_from_numpy(fields["deform"], device)
                if fields.get("deform") is not None else None), **stats)
