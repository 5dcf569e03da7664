"""Training configuration (the part of ``mobgs_tpu/config.py`` the port
reads so far).

``OptimizationParams`` keeps the reference's field names and defaults
(``config.py:76-140``, reference ``arguments/__init__.py:112-187``) for the
fields that ``train/optim.py``, ``train/step.py``, ``train/densify.py`` and
``train/loop.py`` read; ``BlceParams`` is ``config.py:143-153`` whole.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class OptimizationParams:
    iterations: int = 30_000
    batch_size: int = 1
    position_lr_init: float = 0.00016
    position_lr_final: float = 0.0000016
    position_lr_max_steps: int = 20_000
    feature_lr: float = 0.0025
    featuret_lr: float = 0.001
    opacity_lr: float = 0.05
    scaling_lr: float = 0.005
    rotation_lr: float = 0.001
    percent_dense: float = 0.01
    lambda_dssim: float = 0.2
    opacity_reset_interval: int = 3000
    densification_interval: int = 100
    densify_from_iter: int = 500
    densify_until_iter: int = 15_000
    opthr: float = 0.005
    desicnt: int = 6
    densify_grad_threshold: float = 0.0001
    trbfc_lr: float = 0.0001
    trbfs_lr: float = 0.03
    omega_lr: float = 0.0001
    zeta_lr: float = 0.0001
    movelr: float = 3.5
    rgb_lr: float = 0.0001
    lambda_flow_loss: float = 1e-2


@dataclass
class BlceParams:
    """Reference ``blceParams`` (arguments/__init__.py:211-221)."""
    view_dim: int = 32
    num_warp: int = 9
    method: str = "euler"
    adjoint: bool = False
    start_warp: int = 0
    start_warp_dynamic: int = 0
    start_pixel_weight: int = 300000
    start_warp_exposure: int = 2000
