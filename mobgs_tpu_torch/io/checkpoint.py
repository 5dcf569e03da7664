"""Full training-state checkpoints, resume-capable (port of
``mobgs_tpu/io/checkpoint.py``).

A flat, compressed npz whose keys are the JAX package's pytree paths of its
``TrainState`` (``stat/xyz``, ``stat_opt/mu/xyz``, ``blce/params/rot_w``,
``stat_stats/denom``, ``step``, ...) and whose arrays have its dtypes
(``step`` and ``*_opt/step`` int32 scalars, ``live`` bool, ``control_num``
int32). The carried deformation net, when the state has one, is written
under the same paths (``deform/grid/grids/<scale>/<plane>``,
``deform/feature_out/ws/<i>``, ...). So a checkpoint written here loads
into the JAX package and a JAX checkpoint loads here; either loader keeps
the template's values for leaves a file lacks.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

from mobgs_tpu_torch.io import from_jax
from mobgs_tpu_torch.models.blce import BLCE_FIELDS
from mobgs_tpu_torch.models.gaussians import DIFF_FIELDS, GaussianState
from mobgs_tpu_torch.models.sandwich import SandwichParams
from mobgs_tpu_torch.parallel import mesh as Mx
from mobgs_tpu_torch.train.densify import DensifyStats
from mobgs_tpu_torch.train.step import TrainState

_OPT_FIELDS = {"stat_opt": DIFF_FIELDS, "dyn_opt": DIFF_FIELDS,
               "sandwich_opt": SandwichParams._fields,
               "blce_opt": BLCE_FIELDS}


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _flatten_tree(prefix: str, node, out: dict) -> None:
    """NamedTuples by field name and tuples by index, as JAX's pytree
    paths name them."""
    if hasattr(node, "_fields"):
        for f in node._fields:
            _flatten_tree(f"{prefix}/{f}", getattr(node, f), out)
    elif isinstance(node, (tuple, list)):
        for i, x in enumerate(node):
            _flatten_tree(f"{prefix}/{i}", x, out)
    else:
        out[prefix] = _np(node)


def flatten_train_state(ts: TrainState) -> dict[str, np.ndarray]:
    """{JAX pytree path: numpy array} for every leaf of the state, in the
    JAX ``TrainState``'s leaf order."""
    out = {}
    for pool in ("stat", "dyn"):
        for f in GaussianState._fields:
            out[f"{pool}/{f}"] = _np(getattr(getattr(ts, pool), f))
    for f in SandwichParams._fields:
        out[f"sandwich/{f}"] = _np(getattr(ts.sandwich, f))
    for f, p in zip(BLCE_FIELDS, ts.blce.params.leaves()):
        out[f"blce/params/{f}"] = _np(p)
    out["blce/exposure_expo"] = _np(ts.blce.exposure_expo)
    for opt, names in _OPT_FIELDS.items():
        st = getattr(ts, opt)
        for part in ("mu", "nu"):
            for f, m in zip(names, getattr(st, part)):
                out[f"{opt}/{part}/{f}"] = _np(m)
        out[f"{opt}/step"] = np.asarray(st.step, np.int32)
    for pool in ("stat_stats", "dyn_stats"):
        for f, x in zip(DensifyStats._fields, getattr(ts, pool)):
            out[f"{pool}/{f}"] = _np(x)
    out["step"] = np.asarray(ts.step, np.int32)
    if ts.deform is not None:
        _flatten_tree("deform", ts.deform, out)
    return out


def peek_shape(path: str, key: str):
    """Shape of one leaf in a checkpoint, or None if absent — used to size
    a template's pools before loading (a checkpoint written after pool
    growth has larger pools than a fresh template)."""
    with np.load(path) as data:
        if key not in data:
            return None
        return data[key].shape


def save_train_state(path: str, ts: TrainState, mesh=None) -> None:
    """Write the state. With ``mesh`` the state is a rank's gauss shard
    (``parallel/mesh.py::shard_train_state``): every rank must call, the
    shards are gathered and rank 0 writes the whole state."""
    if mesh is not None:
        ts = Mx.gather_train_state(ts, mesh)
        if dist.get_rank() != 0:
            return
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez_compressed(path, **flatten_train_state(ts))


def unflatten_train_state(flat: dict, device=None) -> TrainState:
    """The TrainState of a :func:`flatten_train_state` dict, on ``device``
    (the card unless ``"cpu"``)."""
    nested: dict = {}
    for key, arr in flat.items():
        node = nested
        *parents, leaf = key.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = arr
    return from_jax.train_state_from_numpy(nested, device=device)


def load_train_state(path: str, template: TrainState) -> TrainState:
    """Load into the structure of ``template`` (same shapes required; grow
    the template first with ``densify.grow_train_state`` and
    :func:`peek_shape` when the checkpoint's pools are larger). Leaves the
    file lacks keep the template's values; leaves the template lacks (a
    ``deform/*`` net where the template carries none) are skipped. Returns
    a new TrainState on the template's device."""
    flat = flatten_train_state(template)
    missing = []
    with np.load(path) as data:
        for key, tmpl in flat.items():
            if key not in data:
                missing.append(key)
                continue
            arr = data[key]
            if arr.shape != tmpl.shape:
                raise ValueError(f"shape mismatch for {key}: ckpt "
                                 f"{arr.shape} vs template {tmpl.shape}")
            flat[key] = arr.astype(tmpl.dtype, copy=False)
    if missing:
        print(f"checkpoint {path}: {len(missing)} leaves not in file, kept "
              f"template values (first: {missing[0]})")
    return unflatten_train_state(flat, device=template.stat.xyz.device)
