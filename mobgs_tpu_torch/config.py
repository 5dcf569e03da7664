"""Training configuration (the part of ``mobgs_tpu/config.py`` the port
reads so far).

``OptimizationParams`` keeps the reference's field names and defaults
(``config.py:76-140``, reference ``arguments/__init__.py:112-187``) for the
fields that ``train/optim.py`` and ``train/step.py`` read; the densify and
pruning schedule joins with the host-loop slice.
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
    lambda_dssim: float = 0.2
    trbfc_lr: float = 0.0001
    trbfs_lr: float = 0.03
    omega_lr: float = 0.0001
    zeta_lr: float = 0.0001
    movelr: float = 3.5
    rgb_lr: float = 0.0001
    lambda_flow_loss: float = 1e-2
