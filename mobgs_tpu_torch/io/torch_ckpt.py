"""Torch-format checkpoint artifacts in the reference's layout (port of
``mobgs_tpu/io/torch_ckpt.py``).

Per checkpoint directory the reference writes (``scene/__init__.py:116-138``):

  deformation.pth         deform_network.state_dict()
  deformation_table.pth   bool [N] (all True, gaussian_model.py:741)
  deformation_accum.pth   float [N, 3] zeros
  blce.pth                BLCE.state_dict()

and ``eval.py:221-231`` / ``gaussian_model.py:736-753`` load them back with
a strict ``load_state_dict``. The keys, shapes and dtypes here are the JAX
package's exactly, so either package (and the upstream repo) loads the
other's files. Key-layout sources: ``scene/deformation.py:228-249`` and
``:50-73``, ``scene/hexplane.py:50-148``, ``scene/blce.py:322-368`` (the
ODE solver shares its ``ode_func`` with ``wv_derivative``, so those keys
appear twice). Linears are stored as torch's [out, in]; the port's
parameters are [in, out].
"""

from __future__ import annotations

import os

import torch

from mobgs_tpu_torch import resolve_device
from mobgs_tpu_torch.models.blce import BLCEParams, BLCEState
from mobgs_tpu_torch.models.deformation import DeformationParams, MLPParams
from mobgs_tpu_torch.models.hexplane import HexPlaneParams


def _t(x: torch.Tensor) -> torch.Tensor:
    """A CPU tensor with storage of its own (torch.save writes a view's
    whole storage)."""
    return x.detach().cpu().contiguous().clone()


def _mlp_to_seq(sd: dict, prefix: str, mlp: MLPParams, relu_first: bool):
    """An MLPParams as the keys of a torch Sequential of Linear (and ReLU)
    layers."""
    idx = 1 if relu_first else 0
    for w, b in zip(mlp.ws, mlp.bs):
        sd[f"{prefix}.{idx}.weight"] = _t(w.T)
        sd[f"{prefix}.{idx}.bias"] = _t(b)
        idx += 2


def _seq_to_mlp(sd: dict, prefix: str, n_linear: int, relu_first: bool,
                dev) -> MLPParams:
    ws, bs = [], []
    idx = 1 if relu_first else 0
    for _ in range(n_linear):
        ws.append(sd[f"{prefix}.{idx}.weight"].T.contiguous().to(dev))
        bs.append(sd[f"{prefix}.{idx}.bias"].to(dev))
        idx += 2
    return MLPParams(ws=tuple(ws), bs=tuple(bs))


# ---------------------------------------------------------------------------
# deformation.pth


def deformation_state_dict(params: DeformationParams, hidden_cfg) -> dict:
    sd = {}
    _mlp_to_seq(sd, "timenet", params.timenet, relu_first=False)
    # the positional-encoding frequency buffers (deformation.py:245-248)
    for name, pe in (("time_poc", hidden_cfg.timebase_pe),
                     ("pos_poc", hidden_cfg.posebase_pe),
                     ("rotation_scaling_poc", hidden_cfg.scale_rotation_pe),
                     ("opacity_poc", hidden_cfg.opacity_pe)):
        sd[name] = torch.tensor([2.0 ** i for i in range(pe)], dtype=torch.float32)
    # the grid: a ModuleList of ParameterLists, [1, C, r2, r1] each
    sd["deformation_net.grid.aabb"] = _t(params.grid.aabb)
    for s, scale in enumerate(params.grid.grids):
        for p, plane in enumerate(scale):
            sd[f"deformation_net.grid.grids.{s}.{p}"] = _t(plane[None])
    _mlp_to_seq(sd, "deformation_net.feature_out", params.feature_out,
                relu_first=False)
    for head in ("pos_deform", "scales_deform", "rotations_deform"):
        _mlp_to_seq(sd, f"deformation_net.{head}", getattr(params, head),
                    relu_first=True)
    return sd


def save_deformation_pth(ckpt_dir: str, params: DeformationParams,
                         hidden_cfg, num_points: int) -> None:
    """Write deformation.pth, deformation_table.pth (all True) and
    deformation_accum.pth (zeros), ``gaussian_model.py:755-758``."""
    torch.save(deformation_state_dict(params, hidden_cfg),
               os.path.join(ckpt_dir, "deformation.pth"))
    torch.save(torch.ones(num_points, dtype=torch.bool),
               os.path.join(ckpt_dir, "deformation_table.pth"))
    torch.save(torch.zeros(num_points, 3),
               os.path.join(ckpt_dir, "deformation_accum.pth"))


def load_deformation_pth(path: str, hidden_cfg, device=None) -> DeformationParams:
    dev = resolve_device(device)
    sd = torch.load(path, map_location="cpu", weights_only=True)
    grids = tuple(
        tuple(sd[f"deformation_net.grid.grids.{s}.{p}"][0].to(dev) for p in range(6))
        for s in range(len(hidden_cfg.multires)))
    grid = HexPlaneParams(grids=grids, aabb=sd["deformation_net.grid.aabb"].to(dev))
    return DeformationParams(
        grid=grid,
        feature_out=_seq_to_mlp(sd, "deformation_net.feature_out",
                                hidden_cfg.defor_depth, False, dev),
        pos_deform=_seq_to_mlp(sd, "deformation_net.pos_deform", 2, True, dev),
        scales_deform=_seq_to_mlp(sd, "deformation_net.scales_deform", 2, True, dev),
        rotations_deform=_seq_to_mlp(sd, "deformation_net.rotations_deform", 2,
                                     True, dev),
        timenet=_seq_to_mlp(sd, "timenet", 2, False, dev),
    )


# ---------------------------------------------------------------------------
# blce.pth

# (reference module prefix per view, weight field, bias field)
_BLCE_LINEARS = (("blur_feature_encoder.{i}.0", "bf_w0", "bf_b0"),
                 ("blur_feature_encoder.{i}.2", "bf_w1", "bf_b1"),
                 ("blur_feature_encoder.{i}.4", "bf_w2", "bf_b2"),
                 ("Rt_encoder.{i}", "rt_w", "rt_b"),
                 ("view_encoder.{i}", "venc_w", "venc_b"))
_ODE_LINEARS = (("w_linear", "w_lin_w", "w_lin_b"),
                ("v_linear", "v_lin_w", "v_lin_b"))
_DECODERS = (("rot_decoder.{i}", "rot_w", "rot_b"),
             ("trans_decoder.{i}", "trans_w", "trans_b"),
             ("theta_decoder.{i}", "theta_w", "theta_b"))


def blce_state_dict(state: BLCEState) -> dict:
    p = state.params
    V = p.view_embed.shape[0]
    sd = {"view_embedder": _t(p.view_embed),
          "exposure_time_expo": _t(state.exposure_expo)}

    def lin(prefix, w, b):
        sd[f"{prefix}.weight"] = _t(w.T)
        sd[f"{prefix}.bias"] = _t(b)

    for i in range(V):
        for prefix, wf, bf in _BLCE_LINEARS:
            lin(prefix.format(i=i), getattr(p, wf)[i], getattr(p, bf)[i])
        # wv_derivative.{i} and diffeq_solver.{i}.ode_func are one module
        # (blce.py:356-357): the state_dict carries both paths
        for prefix in (f"wv_derivative.{i}", f"diffeq_solver.{i}.ode_func"):
            sd[f"{prefix}.time_embedder"] = _t(p.time_embed[i])
            for name, wf, bf in _ODE_LINEARS:
                lin(f"{prefix}.{name}", getattr(p, wf)[i], getattr(p, bf)[i])
        for prefix, wf, bf in _DECODERS:
            lin(prefix.format(i=i), getattr(p, wf)[i], getattr(p, bf)[i])
    return sd


def save_blce_pth(ckpt_dir: str, state: BLCEState) -> None:
    torch.save(blce_state_dict(state), os.path.join(ckpt_dir, "blce.pth"))


def load_blce_pth(path: str, device=None) -> BLCEState:
    dev = resolve_device(device)
    sd = torch.load(path, map_location="cpu", weights_only=True)
    V = sd["view_embedder"].shape[0]
    f = {"view_embed": sd["view_embedder"],
         "time_embed": torch.stack([sd[f"wv_derivative.{i}.time_embedder"]
                                    for i in range(V)])}
    linears = _BLCE_LINEARS + tuple(
        (f"wv_derivative.{{i}}.{name}", wf, bf) for name, wf, bf in _ODE_LINEARS
    ) + _DECODERS
    for prefix, wf, bf in linears:
        f[wf] = torch.stack([sd[f"{prefix.format(i=i)}.weight"].T for i in range(V)])
        f[bf] = torch.stack([sd[f"{prefix.format(i=i)}.bias"] for i in range(V)])
    params = BLCEParams(**{k: v.contiguous().to(dev) for k, v in f.items()})
    return BLCEState(params, sd["exposure_time_expo"].to(dev))
