"""Gaussian scene state — fixed capacity with a live mask
(port of ``mobgs_tpu/models/gaussians.py``).

``GaussianState`` is an ``nn.Module``: the float fields are
``nn.Parameter``s in the JAX NamedTuple's field order, ``control_num`` and
``live`` are buffers. Densify and prune write into free slots and flip the
mask in place, as the JAX package does functionally; only pool growth
(:func:`grow_state`, a rare host event) changes the capacity, and it builds
a new module. The activations and time-dependent accessors are free functions
over the module, as they are over the pytree there.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from mobgs_tpu_torch import draw, resolve_device
from mobgs_tpu_torch.core import knn, se3, sh, spline

CONTROL_NUM = 12           # max spline knots (reference control_num)
SPLINE_SCALE = 1e-2        # eval-time position scale (renderer :116)


class DiffFields(NamedTuple):
    """The float (Adam-optimized) fields of a GaussianState, in the JAX
    package's order (``gaussians.py:61-76``)."""
    xyz: torch.Tensor
    control_xyz: torch.Tensor
    features_dc: torch.Tensor
    features_rest: torch.Tensor
    features_t: torch.Tensor
    scaling: torch.Tensor
    rotation: torch.Tensor
    opacity: torch.Tensor
    omega: torch.Tensor
    motion: torch.Tensor
    zeta: torch.Tensor
    trbf_center: torch.Tensor
    trbf_scale: torch.Tensor


DIFF_FIELDS = DiffFields._fields


class GaussianState(nn.Module):
    """All per-Gaussian parameters, capacity ``M`` with ``live`` mask.

    Shapes (``gaussians.py:35-51``): xyz [M,3], control_xyz [M,K,3]
    (x1e2 units), control_num [M] int32, features_dc [M,6],
    features_rest [M,16,3], features_t [M,3], scaling [M,3] log scales,
    rotation [M,4] wxyz, opacity [M,1] logits, omega [M,4], motion [M,9],
    zeta / trbf_center / trbf_scale [M,1], live [M] bool."""

    _fields = ("xyz", "control_xyz", "control_num", "features_dc",
               "features_rest", "features_t", "scaling", "rotation",
               "opacity", "omega", "motion", "zeta", "trbf_center",
               "trbf_scale", "live")

    def __init__(self, **fields: torch.Tensor):
        super().__init__()
        missing = set(self._fields) - set(fields)
        if missing:
            raise ValueError(f"GaussianState missing fields {sorted(missing)}")
        for name in DIFF_FIELDS:
            self.register_parameter(
                name, nn.Parameter(fields[name].to(torch.float32)))
        self.register_buffer("control_num",
                             fields["control_num"].to(torch.int32))
        self.register_buffer("live", fields["live"].to(torch.bool))

    @property
    def capacity(self) -> int:
        return self.xyz.shape[0]

    def num_live(self) -> torch.Tensor:
        return torch.sum(self.live.to(torch.int32))


class AuxFields(NamedTuple):
    control_num: torch.Tensor
    live: torch.Tensor


def split_diff(state: GaussianState) -> tuple[DiffFields, AuxFields]:
    """(the module's Parameters as DiffFields, its buffers). The Parameters
    are the state's own tensors: an optimizer step on them updates the
    state."""
    diff = DiffFields(*(getattr(state, f) for f in DIFF_FIELDS))
    return diff, AuxFields(control_num=state.control_num, live=state.live)


def merge_diff(diff: DiffFields, aux: AuxFields) -> GaussianState:
    """A new GaussianState over the given tensors (storage shared)."""
    return GaussianState(control_num=aux.control_num, live=aux.live,
                         **diff._asdict())


# ---------------------------------------------------------------------------
# activations (reference gaussian_model.py:91-106)

def act_scaling(state: GaussianState) -> torch.Tensor:
    return torch.exp(state.scaling)


def act_opacity(state: GaussianState) -> torch.Tensor:
    """Sigmoid opacity, zeroed on dead slots — dead ⇒ invisible."""
    o = torch.sigmoid(state.opacity[:, 0])
    return o * state.live.to(o.dtype)


def act_rotation(rot: torch.Tensor) -> torch.Tensor:
    return se3.normalize(rot)


def inverse_sigmoid(x):
    return torch.log(x / (1.0 - x))


# time-dependent accessors ---------------------------------------------------

def rotation_at(state: GaussianState, dt: torch.Tensor) -> torch.Tensor:
    """q + Δt·ω then normalize (reference get_rotation_dy :222-224)."""
    return act_rotation(state.rotation + dt * state.omega)


def features_at(state: GaussianState, dt) -> torch.Tensor:
    """[dc ‖ Δt·f_t] 9-channel features (reference get_features :241);
    ``[V, M, 9]`` for a ``[V, M, 1]`` Δt."""
    ft = dt * state.features_t
    dc = state.features_dc
    return torch.cat([dc.expand(ft.shape[:-1] + dc.shape[-1:]), ft], dim=-1)


def positions_at(state: GaussianState, t) -> torch.Tensor:
    """Spline positions at normalized time t (renderer :105-116)."""
    return spline.eval_spline(state.control_xyz, t,
                              state.control_num) * SPLINE_SCALE


def time_offset(state: GaussianState, t) -> torch.Tensor:
    """Δt = t - trbf_center, per point, [M, 1] ([V, M, 1] for V times
    [V, 1, 1])."""
    t = torch.as_tensor(t, dtype=state.trbf_center.dtype,
                        device=state.trbf_center.device)
    return t - state.trbf_center


# ---------------------------------------------------------------------------
# construction

def _padded(x: torch.Tensor, capacity: int) -> torch.Tensor:
    n = x.shape[0]
    if n >= capacity:
        return x[:capacity]
    pad = torch.zeros((capacity - n,) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    return torch.cat([x, pad], dim=0)


def create_state(points: torch.Tensor, colors: torch.Tensor,
                 times: torch.Tensor, capacity: int,
                 trajectory: torch.Tensor | None = None,
                 traj_times: torch.Tensor | None = None,
                 generator: torch.Generator | None = None,
                 device: str | torch.device | None = None) -> GaussianState:
    """Build a GaussianState from a seeded point cloud
    (``gaussians.py:149-212``, mirroring `create_from_pcd[_dynamic]`):

    * log-scales from sqrt(mean 3-NN squared distance),
    * identity rotations, opacity logits at sigmoid⁻¹(0.1),
    * features_dc = [SH(rgb) ‖ SH(rgb)], features_t/omega/motion/zeta = 0,
    * static model: control points ~ N(mean, std) of the cloud, drawn
      from ``generator`` (a seed-0 generator on ``device`` when None),
    * dynamic model: control points = least-squares cubic-Hermite fit of
      the 1e2-scaled input trajectory.

    Args:
      points: [N, 3]; colors: [N, 3] in [0,1]; times: [N] or [N,1].
      capacity: slot count (≥ N).
      trajectory: optional [N, T, 3] world-space tracks (dynamic model).
      traj_times: [T] times of the trajectory samples.
      device: where the state lives (the card unless ``"cpu"``).
    """
    dev = resolve_device(device)
    f32 = torch.float32
    points = torch.as_tensor(points, dtype=f32).to(dev)
    colors = torch.as_tensor(colors, dtype=f32).to(dev)
    times = torch.as_tensor(times, dtype=f32).to(dev)
    N = points.shape[0]
    if capacity < N:
        raise ValueError(f"capacity {capacity} < {N} points")
    fused_color = sh.rgb_to_sh(colors)

    d2 = torch.clamp(knn.mean_knn_sq_dist(points), min=1e-7)
    scales = torch.log(torch.sqrt(d2))[:, None].repeat(1, 3)
    rots = torch.zeros((N, 4), dtype=f32, device=dev)
    rots[:, 0] = 1.0
    opac = inverse_sigmoid(0.1 * torch.ones((N, 1), dtype=f32, device=dev))

    if trajectory is not None:
        if traj_times is None:
            raise ValueError("trajectory needs traj_times")
        control = spline.fit_spline_shared(
            torch.as_tensor(trajectory, dtype=f32).to(dev) / SPLINE_SCALE,
            torch.as_tensor(traj_times, dtype=f32).to(dev),
            CONTROL_NUM, CONTROL_NUM)
    else:
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        mean = torch.mean(points, dim=0)
        std = torch.std(points, dim=0, correction=0)  # jnp.std: ddof=0
        noise = draw(torch.randn, (N, CONTROL_NUM, 3), generator, dev)
        control = noise * std[None, None] + mean[None, None]

    fields = dict(
        xyz=points,
        control_xyz=control.to(f32),
        control_num=torch.full((N,), CONTROL_NUM, dtype=torch.int32,
                               device=dev),
        features_dc=torch.cat([fused_color, fused_color], dim=1),
        features_rest=torch.zeros((N, 16, 3), dtype=f32, device=dev),
        features_t=torch.zeros((N, 3), dtype=f32, device=dev),
        scaling=scales,
        rotation=rots,
        opacity=opac,
        omega=torch.zeros((N, 4), dtype=f32, device=dev),
        motion=torch.zeros((N, 9), dtype=f32, device=dev),
        zeta=torch.zeros((N, 1), dtype=f32, device=dev),
        trbf_center=times.reshape(N, 1),
        trbf_scale=torch.zeros((N, 1), dtype=f32, device=dev),
        live=torch.ones((N,), dtype=torch.bool, device=dev),
    )
    padded = {k: _padded(v, capacity) for k, v in fields.items()}
    # dead slots: control_num=4 keeps spline eval well-defined
    padded["control_num"] = torch.where(
        padded["live"], padded["control_num"],
        torch.full_like(padded["control_num"], 4))
    return GaussianState(**padded)


def grow_state(state: GaussianState, new_capacity: int) -> GaussianState:
    """Pool re-capacity (``gaussians.py:215-231``): a NEW GaussianState with
    every per-Gaussian tensor padded by dead slots up to ``new_capacity``
    (control_num 4 on dead slots, as :func:`create_state` leaves them). The
    old module is left as it was; its holders (the Adam moments, the step
    variants) must take the new one (``train/densify.py::grow_pool``)."""
    if new_capacity < state.capacity:
        raise ValueError(f"new capacity {new_capacity} < {state.capacity}")
    with torch.no_grad():
        grown = {f: _padded(getattr(state, f).detach(), new_capacity)
                 for f in GaussianState._fields}
        grown["control_num"] = torch.where(
            grown["live"], grown["control_num"],
            torch.full_like(grown["control_num"], 4))
    return GaussianState(**grown)
