"""Adam with explicit moments and the exponential learning-rate schedules
(port of ``mobgs_tpu/train/optim.py``).

The reference's per-Gaussian Adam groups (``gaussian_model.py:590-661``,
eps=1e-15) become one moment tensor per parameter tensor, kept in an
``AdamState`` beside the parameters rather than inside a
``torch.optim.Adam``: densify writes into the moments of the slots it
allocates, which needs them as plain tensors. The update is
in place under ``torch.no_grad()``: parameters and moments are overwritten,
where the JAX package returns new arrays. Bias corrections and scheduled
rates are computed in float32 on the host, as the JAX step computes them in
float32 on the device.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from mobgs_tpu_torch.models.gaussians import DiffFields

f32 = np.float32


class AdamState(NamedTuple):
    mu: tuple        # first moments, one per parameter tensor
    nu: tuple        # second moments
    step: int        # updates taken


def init_adam(params: Sequence[torch.Tensor]) -> AdamState:
    return AdamState(mu=tuple(torch.zeros_like(p) for p in params),
                     nu=tuple(torch.zeros_like(p) for p in params), step=0)


def grow_adam(state: AdamState, old_capacity: int,
              new_capacity: int) -> AdamState:
    """Zero-pad the per-Gaussian moments to a grown pool (``optim.py:35-54``;
    the reference's ``cat_tensors_to_optimizer`` extends exp_avg /
    exp_avg_sq with zeros, ``gaussian_model.py:1102-1105``). Moments whose
    leading axis is not ``old_capacity`` pass through; ``step`` is kept.
    Returns new tensors: the old state is left as it was."""
    pad_n = new_capacity - old_capacity

    def pad(x):
        if x.dim() == 0 or x.shape[0] != old_capacity:
            return x
        return torch.cat([x, x.new_zeros((pad_n,) + tuple(x.shape[1:]))])

    return AdamState(mu=tuple(pad(m) for m in state.mu),
                     nu=tuple(pad(v) for v in state.nu), step=state.step)


@torch.no_grad()
def adam_update(params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor],
                state: AdamState, lrs: Sequence, b1: float = 0.9,
                b2: float = 0.999, eps: float = 1e-15) -> AdamState:
    """One Adam step with a learning rate per parameter tensor
    (``optim.py:57-88``), in place on ``params`` and the moments.

    ``lrs`` entries are floats or scalar tensors; an lr of exactly 0.0 still
    updates the moments but leaves the parameter unchanged. Returns the
    state with its step advanced."""
    step = state.step + 1
    bc1 = float(f32(1.0) - f32(b1) ** f32(step))
    bc2 = float(f32(1.0) - f32(b2) ** f32(step))
    for p, g, m, v, lr in zip(params, grads, state.mu, state.nu, lrs,
                              strict=True):
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * (g * g))
        p.sub_(lr * (m / bc1) / (torch.sqrt(v / bc2) + eps))
    return state._replace(step=step)


def expon_lr(step, lr_init: float, lr_final: float, max_steps: int,
             lr_delay_steps: int = 0, lr_delay_mult: float = 1.0) -> float:
    """Log-linear learning-rate interpolation (parity:
    ``get_expon_lr_func``), in float32."""
    t = np.clip(f32(step) / f32(max_steps), f32(0.0), f32(1.0))
    with np.errstate(divide="ignore", invalid="ignore"):  # log(0): zeroed below
        log_lerp = np.exp(np.log(f32(lr_init)) * (f32(1.0) - t)
                          + np.log(f32(lr_final)) * t)
    if lr_delay_steps > 0:
        delay_rate = f32(lr_delay_mult) + f32(1 - lr_delay_mult) * np.sin(
            f32(0.5 * np.pi) * np.clip(f32(step) / f32(lr_delay_steps),
                                       f32(0.0), f32(1.0)))
    else:
        delay_rate = f32(1.0)
    zero = f32(0.0) if (lr_init == 0.0 and lr_final == 0.0) else f32(1.0)
    return float(f32(delay_rate * log_lerp) * zero)


def gaussian_lrs(opt_cfg, step, spatial_lr_scale: float = 5.0) -> DiffFields:
    """Learning rate of each Gaussian field (reference :598-618), as
    DiffFields of floats."""
    slr = spatial_lr_scale
    xyz_lr = expon_lr(step, opt_cfg.position_lr_init * slr,
                      opt_cfg.position_lr_final * slr,
                      opt_cfg.position_lr_max_steps)
    return DiffFields(
        xyz=xyz_lr,
        # the reference's scheduler never matches the "control_xyz" group,
        # so it stays at 10x the initial position rate
        control_xyz=10.0 * opt_cfg.position_lr_init * slr,
        features_dc=opt_cfg.feature_lr,
        features_rest=opt_cfg.feature_lr / 20.0,
        features_t=opt_cfg.featuret_lr,
        scaling=opt_cfg.scaling_lr,
        rotation=opt_cfg.rotation_lr,
        opacity=opt_cfg.opacity_lr,
        omega=opt_cfg.omega_lr,
        motion=opt_cfg.position_lr_init * slr * 0.5 * opt_cfg.movelr,
        zeta=opt_cfg.zeta_lr,
        trbf_center=opt_cfg.trbfc_lr,
        trbf_scale=opt_cfg.trbfs_lr,
    )
