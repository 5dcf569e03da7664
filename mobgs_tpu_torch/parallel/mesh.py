"""Device mesh and sharding rules for scale-out (port of
``mobgs_tpu/parallel/mesh.py``), as a ``torch.distributed`` layer.

* axis ``gauss``: the Gaussian capacity axis M. The pools' parameters, Adam
  moments and densify statistics shard their leading axis here
  (:func:`shard_train_state`); projection is elementwise, so each rank
  projects its own rows, and the projected records are all-gathered over
  ``gauss`` before the (replicated) tile binning (:func:`gather_gauss_rows`,
  inside ``ops/rasterize.py`` while :func:`gauss_sharded` is active).
* axis ``data``: the camera-batch axis. Each rank renders B / n_data views;
  the step (``train/step.py``, ``mesh=``) reduces the loss, the gradients
  and the densify statistics over ``data``.

The JAX layer states shardings and lets XLA insert the collectives
(``mobgs_tpu/parallel/README.md``). Here every collective is explicit, and
all of them are ``all_reduce`` (sum or max), so that one code path runs on
``gloo`` with CPU tensors, on ``gloo`` with CUDA tensors (for which PyTorch
documents only broadcast and all_reduce: several ranks sharing one card),
and on NCCL across cards:

* an all-gather of disjoint slices is an all-reduce of a zero-padded
  buffer (exact: x + 0 = x);
* a reduce-scatter is an all-reduce followed by the local slice.

The padded buffer moves n times the bytes of an all-gather; NCCL's
``all_gather_into_tensor`` / ``reduce_scatter_tensor`` are the later
optimisation.

The tile-axis shard of the compositor (:func:`enable_tile_sharding`) reuses
the ``gauss`` axis for the tiles: each rank composites a contiguous range
of T / n_gauss tiles with the kernels' ``tile0`` and the image tiles are
all-gathered (``ops/cuda_raster.py::composite_tiles``, the counterpart of
the ``shard_map`` at ``pallas_raster.py:631-656``).
"""

from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import Replicate, Shard

AXES = ("data", "gauss")


def make_mesh(n_data: int = 1, n_gauss: int | None = None,
              devices=None) -> DeviceMesh:
    """A ``data`` x ``gauss`` mesh over the ranks of the default process
    group (which the caller initialises: ``init_process_group`` with its
    address, world size and rank). ``devices`` is the mesh's device type,
    ``"cpu"`` or ``"cuda"``; by default ``"cuda"`` under NCCL and ``"cpu"``
    otherwise (``gloo`` ranks may share one card: their tensors stay on it,
    the mesh only names the groups). Raises ValueError on a non-positive
    axis or too few ranks."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if n_gauss is None:
        n_gauss = world // n_data
    need = n_data * n_gauss
    if n_data < 1 or n_gauss < 1:
        raise ValueError(f"mesh axes must be positive, got "
                         f"data={n_data} gauss={n_gauss}")
    if world < need:
        raise ValueError(
            f"make_mesh needs {need} ranks for a data={n_data} x "
            f"gauss={n_gauss} mesh but only {world} are available "
            f"(torch.distributed initialised: {dist.is_initialized()}). "
            f"Start {need} processes and call init_process_group with "
            f"world_size={need} in each before make_mesh.")
    if devices is None:
        devices = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(str(devices), (n_data, n_gauss), mesh_dim_names=AXES)


def gauss_sharding(mesh: DeviceMesh):
    """Shard the leading per-Gaussian axis across ``gauss``: placements
    over (``data``, ``gauss``)."""
    return (Replicate(), Shard(0))


def replicated(mesh: DeviceMesh):
    return (Replicate(), Replicate())


def data_sharding(mesh: DeviceMesh):
    """Shard a leading batch axis across ``data``."""
    return (Shard(0), Replicate())


# TrainState fields whose subtree holds per-Gaussian (capacity-axis)
# tensors. Sharding is decided by FIELD NAME, not by shape coincidence:
# a BLCE [V, ...] leaf with V == capacity must stay replicated.
GAUSS_FIELDS = ("stat", "dyn", "stat_opt", "dyn_opt",
                "stat_stats", "dyn_stats")


def _map(fn, node):
    """``fn`` over the leaves of a state subtree, the structure kept:
    tensors, and the scalars (``AdamState.step``) beside them, are
    leaves; NamedTuples and tuples map item by item; a module with
    ``_fields`` (``GaussianState``, ``SandwichParams``) is rebuilt from its
    fields when ``fn`` returns tensors and becomes a dict otherwise; any
    other module becomes a dict of its parameters and buffers."""
    if isinstance(node, torch.Tensor) or node is None or isinstance(node, (int, float)):
        return fn(node)
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return type(node)(*(_map(fn, v) for v in node))
    if isinstance(node, (tuple, list)):
        return type(node)(_map(fn, v) for v in node)
    if hasattr(node, "_fields"):
        parts = {f: _map(fn, getattr(node, f)) for f in node._fields}
        if all(isinstance(v, torch.Tensor) for v in parts.values()):
            return type(node)(**parts)
        return parts
    if isinstance(node, torch.nn.Module):
        return {k: _map(fn, v) for k, v in node.state_dict(keep_vars=True).items()}
    raise TypeError(f"no rule for a {type(node).__name__} in a train state")


def shard_train_state_specs(ts, mesh: DeviceMesh):
    """Placement tree for a TrainState: leaves of the per-Gaussian
    subtrees (GaussianState, its Adam moments, densify stats) shard their
    leading capacity axis on ``gauss``; everything else (Sandwich and BLCE
    parameters, their optimizers, the step counter) is replicated. The
    GaussianState and the other modules become dicts of their fields."""
    gauss = gauss_sharding(mesh)
    rep = replicated(mesh)

    def gauss_leaf(x):
        # rank-0 leaves inside a gauss subtree (AdamState.step) have no
        # capacity axis to shard
        return gauss if getattr(x, "ndim", 0) >= 1 else rep

    def spec(fn):
        return lambda x: None if x is None else fn(x)

    parts = {}
    for f in ts._fields:
        sub = getattr(ts, f)
        if f in GAUSS_FIELDS:
            parts[f] = _map(spec(gauss_leaf), sub)
        else:
            parts[f] = _map(spec(lambda _: rep), sub)
    return type(ts)(**parts)


def shard_batch_specs(batch, mesh: DeviceMesh):
    return type(batch)(*(data_sharding(mesh) for _ in batch))


def _axis(mesh: DeviceMesh, axis: str):
    """(process group, this rank's index, size) of a mesh axis."""
    return mesh.get_group(axis), mesh.get_local_rank(axis), mesh.size(AXES.index(axis))


def _check_rows(what: str, n_rows: int, n: int):
    if n_rows % n:
        raise ValueError(f"{what}: {n_rows} rows do not split over {n} gauss ranks")


def shard_train_state(ts, mesh: DeviceMesh):
    """This rank's train state: each gauss-field leaf with a leading axis
    cut to the rank's contiguous slice (``gauss`` rank r of n holds rows
    [r·M/n, (r+1)·M/n)); the replicated fields are the given objects. The
    port's ``jax.device_put(ts, shard_train_state_specs(ts, mesh))``, and the
    way a whole state (one from ``io/from_jax.py``, a checkpoint, a densify
    round) reaches the ranks."""
    _, r, n = _axis(mesh, "gauss")

    def cut(x):
        if not isinstance(x, torch.Tensor) or x.ndim == 0:
            return x
        _check_rows("shard_train_state", x.shape[0], n)
        m = x.shape[0] // n
        return x.detach()[r * m:(r + 1) * m].clone()

    return ts._replace(**{f: _map(cut, getattr(ts, f)) for f in GAUSS_FIELDS})


def gather_train_state(ts, mesh: DeviceMesh):
    """The whole train state on every rank from the ranks' shards: the
    inverse of :func:`shard_train_state`, each gauss-field leaf all-gathered
    over ``gauss`` (bit for bit)."""
    group, r, n = _axis(mesh, "gauss")

    def whole(x):
        if not isinstance(x, torch.Tensor) or x.ndim == 0:
            return x
        return _gather_slices(x.detach(), group, r, n, 0)

    return ts._replace(**{f: _map(whole, getattr(ts, f)) for f in GAUSS_FIELDS})


# ---------------------------------------------------------------------------
# collectives, all as all_reduce

def _gather_slices(x: torch.Tensor, group, r: int, n: int, dim: int) -> torch.Tensor:
    """Concatenate the ranks' equal slices along ``dim`` (rank order): the
    all-reduce of a zero-padded buffer. bool travels as uint8."""
    shape = list(x.shape)
    m = shape[dim]
    shape[dim] = n * m
    wire = x.to(torch.uint8) if x.dtype == torch.bool else x
    buf = wire.new_zeros(shape)
    buf.narrow(dim, r * m, m).copy_(wire)
    dist.all_reduce(buf, group=group)
    return buf.to(torch.bool) if x.dtype == torch.bool else buf


class _GatherTiles(torch.autograd.Function):
    """All-gather of this rank's tile range. Every rank holds the same
    upstream gradient (the loss after the gather is computed redundantly),
    so the backward returns this rank's slice and does not sum: a sum would
    multiply the gradient by n."""

    @staticmethod
    def forward(ctx, x, group, r, n, dim):
        ctx.r, ctx.m, ctx.dim = r, x.shape[dim], dim
        return _gather_slices(x.contiguous(), group, r, n, dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.r * ctx.m, ctx.m), None, None, None, None


def _row_slices(segments, r: int, n: int):
    """(global start, local start, length) of this rank's rows of each
    segment: segment k, local rows [o_k, o_k + s_k), sits at global rows
    [n·o_k + r·s_k, n·o_k + (r+1)·s_k)."""
    out, o = [], 0
    for s in segments:
        out.append((n * o + r * s, o, s))
        o += s
    return out


class _GatherRows(torch.autograd.Function):
    """All-gather of the gauss-sharded row axis into the unsharded order
    (each segment, a pool, whole in turn). Backward: this rank's rows of
    the gradient. With ``partial`` (the rows feed a tile-sharded
    compositor, where each rank's tile range gives partial gradients for
    every row) the gradient is first summed over ``gauss``: the
    reduce-scatter of the JAX README's step 3, the one place those
    gradients are summed. Without it every rank composites every tile and
    holds the whole gradient."""

    @staticmethod
    def forward(ctx, x, group, r, n, segments, partial):
        x = x.contiguous()
        buf = x.new_zeros((n * x.shape[0],) + tuple(x.shape[1:]))
        ctx.slices, ctx.group, ctx.partial = _row_slices(segments, r, n), group, partial
        for g0, l0, s in ctx.slices:
            buf[g0:g0 + s] = x[l0:l0 + s]
        dist.all_reduce(buf, group=group)
        return buf

    @staticmethod
    def backward(ctx, g):
        if ctx.partial:
            g = g.contiguous().clone()
            dist.all_reduce(g, group=ctx.group)
        parts = [g[g0:g0 + s] for g0, _, s in ctx.slices]
        return (torch.cat(parts) if len(parts) > 1 else parts[0],
                None, None, None, None, None)


class _SumGradOverGauss(torch.autograd.Function):
    """Identity; the backward sums the gradient over ``gauss``. For a
    replicated tensor (a camera) entering per-row work on a rank's own
    rows, whose gradient each rank computes for its rows only."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


# ---------------------------------------------------------------------------
# gauss-sharded rows: the explicit form of GSPMD's propagation

_GAUSS_ROWS: DeviceMesh | None = None


@contextlib.contextmanager
def gauss_sharded(mesh: DeviceMesh | None):
    """Within the block, per-Gaussian tensors handed to ``ops/rasterize.py``
    and ``ops/projection.py`` are this rank's ``gauss`` shard: projection
    runs on them, and the projected records are all-gathered before
    binning. ``None``, or a mesh whose ``gauss`` axis is 1, changes
    nothing."""
    global _GAUSS_ROWS
    prev = _GAUSS_ROWS
    _GAUSS_ROWS = mesh if mesh is not None and mesh.size(1) > 1 else None
    try:
        yield
    finally:
        _GAUSS_ROWS = prev


def gauss_shard_info():
    """(mesh, n_gauss) while :func:`gauss_sharded` is active, else None."""
    return None if _GAUSS_ROWS is None else (_GAUSS_ROWS, _GAUSS_ROWS.size(1))


def gather_gauss_rows(x: torch.Tensor, segments=None,
                      partial_grads: bool = False) -> torch.Tensor:
    """The unsharded rows of ``x`` (this rank's rows of each segment, in
    order) on every gauss rank, differentiable (:class:`_GatherRows`);
    ``x`` itself when gauss sharding is off. ``segments``: the local row
    counts of the pools ``x`` concatenates (static rows, dynamic rows), by
    default one segment. ``partial_grads``: the gathered rows feed work
    split over the gauss ranks (the tile-sharded compositor), so their
    gradients are summed over ``gauss``."""
    if _GAUSS_ROWS is None:
        return x
    group, r, n = _axis(_GAUSS_ROWS, "gauss")
    return _GatherRows.apply(x, group, r, n, tuple(segments or (x.shape[0],)),
                             partial_grads)


def replicated_into_rows(x: torch.Tensor) -> torch.Tensor:
    """``x`` (replicated) as it enters work on this rank's rows: its
    gradient is summed over ``gauss``; ``x`` itself when gauss sharding
    is off or ``x`` needs no gradient."""
    if _GAUSS_ROWS is None or not x.requires_grad:
        return x
    return _SumGradOverGauss.apply(x, _axis(_GAUSS_ROWS, "gauss")[0])


def reduce_over(mesh: DeviceMesh, axis: str, x: torch.Tensor, op: str = "sum"):
    """``x`` summed (``"sum"``), averaged (``"mean"``) or maxed (``"max"``)
    over a mesh axis, in place on a copy; no gradient."""
    group, _, n = _axis(mesh, axis)
    y = x.detach().clone()
    dist.all_reduce(y, op=dist.ReduceOp.MAX if op == "max" else dist.ReduceOp.SUM,
                    group=group)
    return y / n if op == "mean" else y


# ---------------------------------------------------------------------------
# Tile-axis compositing shard: on gauss-sharded rows, each gauss rank
# composites a contiguous range of the tiles and the ranges' images are
# all-gathered; the backward's per-splat gradients, partial per range, are
# summed over gauss by the gather that brought the splats
# (gather_gauss_rows).

_TILE_SHARD: tuple | None = None  # (DeviceMesh, axis_name)


def enable_tile_sharding(mesh: DeviceMesh, axis: str = "gauss") -> None:
    """Turn on the tile-axis shard inside the compositor."""
    global _TILE_SHARD
    _TILE_SHARD = (mesh, axis)


def disable_tile_sharding() -> None:
    global _TILE_SHARD
    _TILE_SHARD = None


def tile_shard_info(n_tiles: int):
    """(mesh, axis_name, n_shards) for the compositor's tile-axis shard, or
    None when tile sharding is off, the axis has one rank, or the tile
    count does not divide over it."""
    if _TILE_SHARD is None:
        return None
    mesh, axis = _TILE_SHARD
    n = mesh.size(AXES.index(axis))
    if n <= 1 or n_tiles % n:
        return None
    return mesh, axis, n


def constrain_tile_axis(x: torch.Tensor, dim: int) -> torch.Tensor:
    """This rank's contiguous slice of ``x`` along ``dim`` on the tile-shard
    axis: the explicit form of the JAX layer's sharding constraint. ``x``
    itself when tile sharding is off or ``dim`` does not split."""
    if _TILE_SHARD is None:
        return x
    mesh, axis = _TILE_SHARD
    n = mesh.size(AXES.index(axis))
    if x.shape[dim] % n:
        return x  # unsplittable (tiny pads)
    m = x.shape[dim] // n
    return x.narrow(dim, mesh.get_local_rank(axis) * m, m)


def gather_tile_axis(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The inverse of :func:`constrain_tile_axis`: the ranks' slices along
    ``dim`` concatenated, differentiable (:class:`_GatherTiles`)."""
    if _TILE_SHARD is None:
        return x
    mesh, axis = _TILE_SHARD
    group, r, n = _axis(mesh, axis)
    return _GatherTiles.apply(x, group, r, n, dim)
