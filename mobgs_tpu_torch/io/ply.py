"""Reference-schema PLY checkpoints and the Sandwich decoder's ``.pt``
(port of ``mobgs_tpu/io/ply.py``).

Schema (``gaussian_model.py:696-725``, ``save_ply`` :761-804), float32
vertex properties in this order: x y z, trbf_center, trbf_scale, nx ny nz
(zeros), f_dc_0..5, f_rest_0..47 (features_rest [16, 3] transposed to
[3, 16], then flat), f_t_0..2, motion_0..8, opacity, scale_0..2,
rot_0..3, omega_0..3, zeta_0, control_{x,y,z}_{0..11},
current_control_num. Live rows only. The decoder saves as a torch
state_dict (``mlp1.weight`` [6, 12, 1, 1], ``mlp2.weight`` [3, 6, 1, 1]),
so the files load in the reference, in the JAX package and here.
Binary little-endian, written by the native codec (``io/native.py``)
where it builds, else in Python; both give the same bytes.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from mobgs_tpu_torch import resolve_device
from mobgs_tpu_torch.io import native
from mobgs_tpu_torch.models.gaussians import CONTROL_NUM, GaussianState
from mobgs_tpu_torch.models.sandwich import SandwichParams


def attribute_names() -> list[str]:
    names = ["x", "y", "z", "trbf_center", "trbf_scale", "nx", "ny", "nz"]
    names += [f"f_dc_{i}" for i in range(6)]
    names += [f"f_rest_{i}" for i in range(48)]
    names += [f"f_t_{i}" for i in range(3)]
    names += [f"motion_{i}" for i in range(9)]
    names += ["opacity"]
    names += [f"scale_{i}" for i in range(3)]
    names += [f"rot_{i}" for i in range(4)]
    names += [f"omega_{i}" for i in range(4)]
    names += ["zeta_0"]
    for i in range(CONTROL_NUM):
        names += [f"control_x_{i}", f"control_y_{i}", f"control_z_{i}"]
    names += ["current_control_num"]
    return names


def write_ply(path: str, columns: dict[str, np.ndarray]) -> None:
    """Binary-little-endian PLY with float32 vertex properties, in the
    columns' order."""
    names = list(columns.keys())
    n = len(columns[names[0]])
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    data = np.stack([np.asarray(columns[nm], np.float32).reshape(n)
                     for nm in names], axis=1)
    if native.ply_write(path, names, data):
        return
    header = ["ply", "format binary_little_endian 1.0", f"element vertex {n}"]
    header += [f"property float {nm}" for nm in names]
    header += ["end_header", ""]
    with open(path, "wb") as f:
        f.write("\n".join(header).encode("ascii"))
        f.write(data.astype("<f4").tobytes())


def read_ply(path: str) -> dict[str, np.ndarray]:
    res = native.ply_read(path)
    if res is not None:
        names, data = res
        return {nm: data[:, i].copy() for i, nm in enumerate(names)}
    with open(path, "rb") as f:
        header = b""
        while not header.endswith(b"end_header\n"):
            line = f.readline()
            if not line:
                raise ValueError(f"{path}: no end_header")
            header += line
        n, names, fmt = None, [], None
        for ln in header.decode("ascii").splitlines():
            parts = ln.split()
            if parts[:2] == ["element", "vertex"]:
                n = int(parts[2])
            elif parts and parts[0] == "property":
                if parts[1] not in ("float", "float32"):
                    raise ValueError(f"{path}: only float properties ({ln})")
                names.append(parts[2])
            elif parts and parts[0] == "format":
                fmt = parts[1]
        if fmt != "binary_little_endian" or n is None:
            raise ValueError(f"{path}: format {fmt}, vertex count {n}")
        raw = np.frombuffer(f.read(4 * n * len(names)), "<f4")
    data = raw.reshape(n, len(names))
    return {nm: data[:, i].copy() for i, nm in enumerate(names)}


def state_to_columns(state: GaussianState) -> dict[str, np.ndarray]:
    """Live rows only, in the reference's attribute order."""
    idx = torch.nonzero(state.live).reshape(-1)

    def g(x):
        return x.detach()[idx].cpu().numpy()

    n = int(idx.numel())
    cols: dict[str, np.ndarray] = {}
    xyz = g(state.xyz)
    cols["x"], cols["y"], cols["z"] = xyz[:, 0], xyz[:, 1], xyz[:, 2]
    cols["trbf_center"] = g(state.trbf_center)[:, 0]
    cols["trbf_scale"] = g(state.trbf_scale)[:, 0]
    for nm in ("nx", "ny", "nz"):
        cols[nm] = np.zeros(n, np.float32)
    fdc = g(state.features_dc)
    for i in range(6):
        cols[f"f_dc_{i}"] = fdc[:, i]
    # [16, 3] -> [3, 16] -> flat 48 (reference save_ply :770)
    frest = g(state.features_rest).transpose(0, 2, 1).reshape(n, 48)
    for i in range(48):
        cols[f"f_rest_{i}"] = frest[:, i]
    ft = g(state.features_t)
    for i in range(3):
        cols[f"f_t_{i}"] = ft[:, i]
    mot = g(state.motion)
    for i in range(9):
        cols[f"motion_{i}"] = mot[:, i]
    cols["opacity"] = g(state.opacity)[:, 0]
    sc = g(state.scaling)
    for i in range(3):
        cols[f"scale_{i}"] = sc[:, i]
    rot = g(state.rotation)
    for i in range(4):
        cols[f"rot_{i}"] = rot[:, i]
    om = g(state.omega)
    for i in range(4):
        cols[f"omega_{i}"] = om[:, i]
    cols["zeta_0"] = g(state.zeta)[:, 0]
    ctrl = g(state.control_xyz)  # [n, K, 3]
    for i in range(CONTROL_NUM):
        cols[f"control_x_{i}"] = ctrl[:, i, 0]
        cols[f"control_y_{i}"] = ctrl[:, i, 1]
        cols[f"control_z_{i}"] = ctrl[:, i, 2]
    cols["current_control_num"] = g(state.control_num).astype(np.float32)
    return cols


def save_gaussians(path: str, state: GaussianState,
                   sandwich: SandwichParams | None = None) -> None:
    """Write ``<path>.ply`` (and the decoder's ``.pt`` beside it when
    ``sandwich`` is given)."""
    write_ply(path, state_to_columns(state))
    if sandwich is not None:
        save_sandwich_pt(path.replace(".ply", ".pt"), sandwich)


def save_sandwich_pt(path: str, sandwich: SandwichParams) -> None:
    # w1 is [in=12, out=6]; a Conv2d weight is [out, in, 1, 1]
    w1 = sandwich.w1.detach().cpu()
    w2 = sandwich.w2.detach().cpu()
    torch.save({"mlp1.weight": w1.T.reshape(6, 12, 1, 1).contiguous(),
                "mlp2.weight": w2.T.reshape(3, 6, 1, 1).contiguous()}, path)


def load_sandwich_pt(path: str, device=None) -> SandwichParams:
    sd = torch.load(path, map_location="cpu", weights_only=True)
    dev = resolve_device(device)
    return SandwichParams(w1=sd["mlp1.weight"].reshape(6, 12).T.to(dev),
                          w2=sd["mlp2.weight"].reshape(3, 6).T.to(dev))


def load_gaussians(path: str, capacity: int | None = None,
                   device=None) -> GaussianState:
    """A reference-schema PLY as a GaussianState on ``device`` (the card
    unless ``"cpu"``), padded with dead slots up to ``capacity``
    (opacity logit -10 and control_num 4 there)."""
    cols = read_ply(path)
    n = len(cols["x"])
    cap = capacity or n
    dev = resolve_device(device)

    xyz = np.stack([cols["x"], cols["y"], cols["z"]], -1)
    frest = np.stack([cols[f"f_rest_{i}"] for i in range(48)], -1)
    frest = frest.reshape(n, 3, 16).transpose(0, 2, 1)
    ctrl = np.zeros((n, CONTROL_NUM, 3), np.float32)
    for i in range(CONTROL_NUM):
        ctrl[:, i, 0] = cols[f"control_x_{i}"]
        ctrl[:, i, 1] = cols[f"control_y_{i}"]
        ctrl[:, i, 2] = cols[f"control_z_{i}"]

    def pad(x, fill=0.0):
        x = np.asarray(x, np.float32)
        if cap > n:
            x = np.concatenate([x, np.full((cap - n,) + x.shape[1:], fill, np.float32)])
        return torch.as_tensor(x, device=dev)

    zeta_key = "zeta_0" if "zeta_0" in cols else "zeta"
    return GaussianState(
        xyz=pad(xyz),
        control_xyz=pad(ctrl),
        control_num=pad(cols["current_control_num"], 4).to(torch.int32),
        features_dc=pad(np.stack([cols[f"f_dc_{i}"] for i in range(6)], -1)),
        features_rest=pad(frest),
        features_t=pad(np.stack([cols[f"f_t_{i}"] for i in range(3)], -1)),
        scaling=pad(np.stack([cols[f"scale_{i}"] for i in range(3)], -1)),
        rotation=pad(np.stack([cols[f"rot_{i}"] for i in range(4)], -1)),
        opacity=pad(cols["opacity"][:, None], -10.0),
        omega=pad(np.stack([cols[f"omega_{i}"] for i in range(4)], -1)),
        motion=pad(np.stack([cols[f"motion_{i}"] for i in range(9)], -1)),
        zeta=pad(cols[zeta_key][:, None]),
        trbf_center=pad(cols["trbf_center"][:, None]),
        trbf_scale=pad(cols["trbf_scale"][:, None]),
        live=torch.as_tensor(np.arange(cap) < n, device=dev),
    )
