"""Configuration tree (port of ``mobgs_tpu/config.py``).

The reference's five ParamGroups (``arguments/__init__.py:47-221``) as
dataclasses with its field names and defaults, plus the port's accepted
knobs (``TPUParams``), and the per-scene python overlays
(``configs/stereo/*.py``, mmengine style with ``_base_``). The field names
are kept so a reference config ports 1:1; an overlay key that no group
has is dropped, as the reference's ``merge_hparams`` drops it.
"""

from __future__ import annotations

import dataclasses
import pathlib
from dataclasses import dataclass, field


@dataclass
class ModelParams:
    """Reference ``ModelParams`` (arguments/__init__.py:47-62)."""
    sh_degree: int = 3
    source_path: str = ""
    model_path: str = ""
    images: str = "images"
    resolution: int = -1
    white_background: bool = False
    data_device: str = "tpu"
    eval: bool = True
    render_process: bool = False
    debug_process: bool = True
    add_points: bool = False
    extension: str = ".png"
    llffhold: int = 8


@dataclass
class PipelineParams:
    """Reference ``PipelineParams`` (arguments/__init__.py:69-74)."""
    convert_SHs_python: bool = False
    compute_cov3D_python: bool = False
    debug: bool = False


@dataclass
class ModelHiddenParams:
    """Reference ``ModelHiddenParams`` (arguments/__init__.py:77-109)."""
    net_width: int = 64
    timebase_pe: int = 4
    defor_depth: int = 1
    posebase_pe: int = 10
    scale_rotation_pe: int = 2
    opacity_pe: int = 2
    timenet_width: int = 64
    timenet_output: int = 32
    bounds: float = 1.6
    plane_tv_weight: float = 0.0001
    time_smoothness_weight: float = 0.01
    l1_time_planes: float = 0.0001
    kplanes_config: dict = field(default_factory=lambda: {
        "grid_dimensions": 2,
        "input_coordinate_dim": 4,
        "output_coordinate_dim": 32,
        "resolution": [64, 64, 64, 25],
    })
    multires: list = field(default_factory=lambda: [1, 2, 4, 8])
    no_dx: bool = False
    no_grid: bool = False
    no_ds: bool = False
    no_dr: bool = False
    no_do: bool = True
    no_dshs: bool = True
    empty_voxel: bool = False
    grid_pe: int = 0
    static_mlp: bool = False
    apply_rotation: bool = False


@dataclass
class OptimizationParams:
    """Reference ``OptimizationParams`` (arguments/__init__.py:112-187),
    every field of the JAX package's (``config.py:76-139``)."""
    dataloader: bool = False
    zerostamp_init: bool = False
    iterations: int = 30_000
    coarse_iterations: int = 1000
    position_lr_init: float = 0.00016
    position_lr_final: float = 0.0000016
    position_lr_delay_mult: float = 0.01
    position_lr_max_steps: int = 20_000
    deformation_lr_init: float = 0.00016
    deformation_lr_final: float = 0.000016
    deformation_lr_delay_mult: float = 0.01
    grid_lr_init: float = 0.0016
    grid_lr_final: float = 0.00016
    pose_lr_init: float = 0.0005
    pose_lr_final: float = 0.00005
    pose_lr_delay_mult: float = 0.01
    feature_lr: float = 0.0025
    featuret_lr: float = 0.001
    opacity_lr: float = 0.05
    scaling_lr: float = 0.005
    rotation_lr: float = 0.001
    percent_dense: float = 0.01
    lambda_dssim: float = 0.2
    p_lambda_dssim: float = 0.0
    lambda_lpips: float = 0.0
    weight_constraint_init: float = 1.0
    weight_constraint_after: float = 0.2
    weight_decay_iteration: int = 5000
    opacity_reset_interval: int = 3000
    densification_interval: int = 100
    densify_from_iter: int = 500
    densify_until_iter: int = 15_000
    densify_grad_threshold_coarse: float = 0.0002
    densify_grad_threshold_fine_init: float = 0.0002
    densify_grad_threshold_after: float = 0.0002
    pruning_from_iter: int = 500
    pruning_interval: int = 100
    opacity_threshold_coarse: float = 0.005
    opacity_threshold_fine_init: float = 0.005
    opacity_threshold_fine_after: float = 0.005
    batch_size: int = 1
    add_point: bool = False
    prevpath: str = "1"
    opthr: float = 0.005
    desicnt: int = 6
    densify_grad_threshold: float = 0.0001
    preprocesspoints: int = 0
    addsphpointsscale: float = 0.8
    raystart: float = 0.7
    soft_depth_start: int = 1000
    hard_depth_start: int = 0
    error_tolerance: float = 0.001
    trbfc_lr: float = 0.0001
    trbfs_lr: float = 0.03
    trbfslinit: float = 0.0
    omega_lr: float = 0.0001
    zeta_lr: float = 0.0001
    movelr: float = 3.5
    rgb_lr: float = 0.0001
    stat_npts: int = 40000
    dyn_npts: int = 20000
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


@dataclass
class TPUParams:
    """The JAX package's build knobs, with its defaults. The port reads
    the raster budgets (``tiles_per_gauss``, ``max_per_tile``) and
    ``capacity_mult``; it accepts ``tile_chunk``, ``mesh_shape`` and
    ``use_pallas`` and ignores them (one card, hand-written kernels)."""
    tiles_per_gauss: int = 9
    max_per_tile: int = 256
    tile_chunk: int = 36
    capacity_mult: float = 2.0
    mesh_shape: tuple = ()
    use_pallas: bool = True


@dataclass
class Config:
    model: ModelParams = field(default_factory=ModelParams)
    pipe: PipelineParams = field(default_factory=PipelineParams)
    hidden: ModelHiddenParams = field(default_factory=ModelHiddenParams)
    opt: OptimizationParams = field(default_factory=OptimizationParams)
    blce: BlceParams = field(default_factory=BlceParams)
    tpu: TPUParams = field(default_factory=TPUParams)
    expname: str = ""
    configs: str = ""


def merge_overlay(cfg: Config, overlay: dict) -> Config:
    """Apply a per-scene overlay dict with the reference's ``merge_hparams``
    semantics (``utils/params_utils.py:1-9``): only keys that already exist
    in a param group are applied; unknown keys are dropped."""
    groups = {"ModelParams": "model", "PipelineParams": "pipe",
              "ModelHiddenParams": "hidden", "OptimizationParams": "opt",
              "blceParams": "blce", "TPUParams": "tpu"}
    out = cfg
    for gname, attr in groups.items():
        if gname not in overlay:
            continue
        group = getattr(out, attr)
        updates = {k: v for k, v in overlay[gname].items() if hasattr(group, k)}
        out = dataclasses.replace(out, **{attr: dataclasses.replace(group, **updates)})
    return out


def load_scene_config(path: str, base: Config | None = None) -> Config:
    """Load a python overlay file (mmengine style; ``_base_`` is loaded
    first, relative to the file)."""
    cfg = base or Config()
    p = pathlib.Path(path)
    ns: dict = {}
    exec(compile(p.read_text(), str(p), "exec"), ns)
    if "_base_" in ns:
        cfg = load_scene_config(str(p.parent / ns["_base_"]), cfg)
    overlay = {k: v for k, v in ns.items() if not k.startswith("_")}
    return merge_overlay(cfg, overlay)
