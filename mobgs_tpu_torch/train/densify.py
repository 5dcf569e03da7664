"""Densification and pruning on fixed-capacity pools with a live mask (port
of ``mobgs_tpu/train/densify.py``).

Behavioural reference: ``helper_train.py:183-289`` (controlgaussians) and
``scene/gaussian_model.py`` (densify_and_clone :1480, densify_and_splitv2
:1210, prune_points :1068, reset_opacity :897, add_densification_stats
:1352), as the JAX package implements them:

* clones and split children go into dead slots, the i-th candidate into the
  i-th free slot; the slots they take get zeroed Adam moments;
* pruning clears ``live``; a candidate that finds no free slot is dropped
  and counted, and a split parent is pruned only if ALL its children found
  a slot;
* mode 2 (the shipped mode) counts densify rounds (``flag``) for the static
  pool only and halves the dynamic pool's gradient threshold.

Where the JAX package returns new arrays, these functions write into the
state's own tensors under ``torch.no_grad()`` — the Parameters and buffers of
the ``GaussianState`` module and the Adam moments — and return the same
objects. A rejected candidate's write is masked out before the scatter
(JAX scatters it to index M with ``mode="drop"``; torch has no drop mode and
a CUDA scatter to M would write out of range). Only pool growth
(:func:`grow_pool`, :func:`grow_train_state`) builds new tensors.

The split noise comes from :func:`split_noise`, keyed by (seed, iteration,
pool): a resumed run draws what an uninterrupted one draws, and the CPU and
the card draw the same numbers.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from mobgs_tpu_torch import resolve_device
from mobgs_tpu_torch.core import se3
from mobgs_tpu_torch.models import gaussians as G
from mobgs_tpu_torch.train.optim import AdamState, grow_adam

OPACITY = G.DIFF_FIELDS.index("opacity")
OMEGA = G.DIFF_FIELDS.index("omega")


class DensifyStats(NamedTuple):
    xyz_grad_accum: torch.Tensor  # [M]
    denom: torch.Tensor           # [M]
    max_radii2d: torch.Tensor     # [M]


def init_stats(capacity: int, device=None) -> DensifyStats:
    dev = resolve_device(device)
    return DensifyStats(*(torch.zeros((capacity,), dtype=torch.float32,
                                      device=dev) for _ in range(3)))


def add_stats(stats: DensifyStats, means2d_grad: torch.Tensor,
              radii: torch.Tensor, visible: torch.Tensor) -> DensifyStats:
    """Accumulate view-space gradient norms and max radii (reference
    train.py:809-817, gaussian_model.py:1352-1355)."""
    gnorm = torch.linalg.norm(means2d_grad, dim=-1)
    vis = visible.to(torch.float32)
    return DensifyStats(
        xyz_grad_accum=stats.xyz_grad_accum + gnorm * vis,
        denom=stats.denom + vis,
        max_radii2d=torch.maximum(stats.max_radii2d,
                                  radii.to(torch.float32) * vis),
    )


def split_noise(key: tuple, child: int, shape) -> torch.Tensor:
    """Standard normal draws for child ``child`` of the splits made under
    ``key`` (the train loop's (seed, iteration, pool)), drawn on the CPU
    from a generator seeded by the key alone."""
    seed = np.random.SeedSequence([int(k) for k in key] + [child])
    gen = torch.Generator().manual_seed(int(seed.generate_state(1, np.uint64)[0]))
    return torch.randn(tuple(shape), generator=gen, dtype=torch.float32)


def _alloc_slots(live: torch.Tensor, want: torch.Tensor):
    """Map the i-th wanted candidate to the i-th free slot.

    Returns (dest [M] int64, ok [M] bool): dest[j] is a unique dead slot
    where ok[j], and M (out of range, never written) where the candidate
    was not wanted or capacity ran out."""
    M = live.shape[0]
    free_slots = torch.argsort(live.to(torch.int8), stable=True)  # dead first
    n_free = M - torch.sum(live.to(torch.int64))
    rank = torch.cumsum(want.to(torch.int64), 0) - 1
    ok = want & (rank < n_free)
    dest = free_slots[torch.clamp(rank, 0, M - 1)]
    return torch.where(ok, dest, torch.full_like(dest, M)), ok


@torch.no_grad()
def _scatter_rows(state: G.GaussianState, src_idx: torch.Tensor,
                  dest: torch.Tensor, ok: torch.Tensor,
                  overrides: dict | None = None) -> G.GaussianState:
    """Copy rows src→dest where ``ok`` (with optional per-field override
    rows, indexed like ``src_idx``), in place; the dest slots turn live."""
    overrides = overrides or {}
    sel = torch.nonzero(ok).squeeze(1)
    d = dest[sel]
    for f in G.GaussianState._fields:
        if f == "live":
            continue
        x = getattr(state, f)
        rows = overrides[f][sel] if f in overrides else x[src_idx[sel]]
        x[d] = rows
    state.live[d] = True
    return state


@torch.no_grad()
def _zero_moments_at(opt_state: AdamState, dest: torch.Tensor,
                     ok: torch.Tensor) -> AdamState:
    """Zero the Adam moments of newly allocated slots, in place."""
    d = dest[torch.nonzero(ok).squeeze(1)]
    for m in opt_state.mu + opt_state.nu:
        if m.dim() and m.shape[0] == ok.shape[0]:
            m[d] = 0.0
    return opt_state


@torch.no_grad()
def densify_clone_split(state: G.GaussianState, stats: DensifyStats,
                        opt_state: AdamState, key: tuple,
                        grad_threshold: float, percent_dense: float,
                        scene_extent: float, split_n: int = 2):
    """Clone small high-gradient Gaussians; split big ones into ``split_n``
    children (``densify.py:106-157``; densify_and_clone :1480 +
    densify_and_splitv2 :1210). Children are drawn around the parent with
    :func:`split_noise` under ``key`` and take log(scale / (0.8·split_n));
    a parent is pruned only if all its children were allocated.

    Returns (state, opt_state, new zeroed stats, n_dropped as a 0-dim
    tensor); state and opt_state are the arguments, written in place."""
    M = state.capacity
    dev = state.xyz.device
    grads = stats.xyz_grad_accum / torch.clamp(stats.denom, min=1e-12)
    grads = torch.where(torch.isnan(grads), torch.zeros_like(grads), grads)
    max_scale = torch.amax(G.act_scaling(state), dim=1)
    hi = (grads >= grad_threshold) & state.live
    big = max_scale > percent_dense * scene_extent

    # clone: small Gaussians copied verbatim
    clone_mask = hi & ~big
    idx = torch.arange(M, device=dev)
    dest, ok = _alloc_slots(state.live, clone_mask)
    _scatter_rows(state, idx, dest, ok)
    _zero_moments_at(opt_state, dest, ok)
    dropped = torch.sum(clone_mask.to(torch.int64)) - torch.sum(ok.to(torch.int64))

    # split: parents read before any child is written (children only take
    # dead slots, so the parents' rows never change in the loop)
    split_mask = hi & big & state.live
    scales = G.act_scaling(state)
    rot = se3.quat_to_rotmat(state.rotation)
    new_scaling = torch.log(scales / (0.8 * split_n))
    all_ok = split_mask.clone()
    for c in range(split_n):
        samples = split_noise(key, c, (M, 3)).to(dev) * scales
        new_xyz = torch.einsum("nij,nj->ni", rot, samples) + state.xyz
        dest, ok = _alloc_slots(state.live, split_mask)
        _scatter_rows(state, idx, dest, ok,
                      overrides={"xyz": new_xyz, "scaling": new_scaling})
        _zero_moments_at(opt_state, dest, ok)
        all_ok &= ok
        dropped = dropped + torch.sum(split_mask.to(torch.int64)) \
            - torch.sum(ok.to(torch.int64))
    state.live &= ~all_ok
    return state, opt_state, init_stats(M, dev), dropped


def grow_stats(stats: DensifyStats, new_capacity: int) -> DensifyStats:
    """Zero-pad the accumulators to a grown pool capacity (new tensors)."""
    def pad(x):
        return torch.cat([x, x.new_zeros((new_capacity - x.shape[0],))])
    return DensifyStats(*(pad(x) for x in stats))


def grow_pool(state: G.GaussianState, opt_state: AdamState,
              stats: DensifyStats, dropped: int,
              max_capacity: int = 400_000, headroom: float = 0.5):
    """Pool re-capacity on densify pressure (``densify.py:171-204``): size
    the new capacity to cover the dropped candidates plus ``headroom``,
    rounded up to 1024 slots and capped at ``max_capacity``, and pad the
    state, the moments and the stats.

    Returns (state, opt_state, stats, new_capacity): new objects when the
    pool grew (the inputs are left as they were), else the inputs and the
    old capacity."""
    cap = state.capacity
    if dropped <= 0 or cap >= max_capacity:
        return state, opt_state, stats, cap
    want = cap + dropped
    new_cap = int(min(max_capacity, (1.0 + headroom) * want))
    new_cap = -(-new_cap // 1024) * 1024  # round up to 1024 slots
    new_cap = min(new_cap, max_capacity)
    if new_cap <= cap:
        return state, opt_state, stats, cap
    return (G.grow_state(state, new_cap), grow_adam(opt_state, cap, new_cap),
            grow_stats(stats, new_cap), new_cap)


def grow_train_state(ts, cap_stat: int, cap_dyn: int):
    """Grow both pools of a TrainState to explicit capacities (≥ current),
    as resume does before loading a checkpoint written after growth."""
    new = ts
    if cap_stat > ts.stat.capacity:
        new = new._replace(
            stat=G.grow_state(ts.stat, cap_stat),
            stat_opt=grow_adam(ts.stat_opt, ts.stat.capacity, cap_stat),
            stat_stats=grow_stats(ts.stat_stats, cap_stat))
    if cap_dyn > ts.dyn.capacity:
        new = new._replace(
            dyn=G.grow_state(ts.dyn, cap_dyn),
            dyn_opt=grow_adam(ts.dyn_opt, ts.dyn.capacity, cap_dyn),
            dyn_stats=grow_stats(ts.dyn_stats, cap_dyn))
    return new


@torch.no_grad()
def prune_by_opacity(state: G.GaussianState, min_opacity: float) -> G.GaussianState:
    state.live &= G.act_opacity(state) >= min_opacity
    return state


@torch.no_grad()
def reset_opacity(state: G.GaussianState, opt_state: AdamState):
    """Clamp activated opacity to ≤ 0.01 and zero the opacity moments
    (:897-903), in place."""
    o = torch.clamp(torch.sigmoid(state.opacity), max=0.01)
    state.opacity.copy_(torch.log(o / (1.0 - o)))
    opt_state.mu[OPACITY].zero_()
    opt_state.nu[OPACITY].zero_()
    return state, opt_state


@torch.no_grad()
def zero_omega_by_motion(state: G.GaussianState, opt_state: AdamState,
                         threshold: float = 0.15):
    """The mode-1 freeze mask at iteration 8001 (gaussian_model.py:920-932):
    True where a Gaussian keeps a trainable ω — it moves (Σ|motion[:3]| >
    0.3), is mid-sized (0.2 < max scale < 0.6) and opaque (α > 0.7). ω is
    zeroed elsewhere and the ω moments are reset, in place. ``threshold``
    mirrors the reference's unused argument. Returns (state, opt_state,
    omega_mask [M] bool)."""
    del threshold
    ms = torch.amax(G.act_scaling(state), dim=1)
    moving = torch.sum(torch.abs(state.motion[:, 0:3]), dim=1) > 0.3
    mask = (moving & (ms > 0.2) & (ms < 0.6)
            & (G.act_opacity(state) > 0.7) & state.live)
    state.omega.mul_(mask[:, None].to(state.omega.dtype))
    opt_state.mu[OMEGA].zero_()
    opt_state.nu[OMEGA].zero_()
    return state, opt_state, mask


def apply_omega_freeze(grads: G.DiffFields,
                       omega_mask: torch.Tensor) -> G.DiffFields:
    """Mode 1 past iteration 8001 (helper_train.py:158-164,191-194): the
    rotation gradient is zeroed where ω stays trainable (mask True), the ω
    gradient elsewhere — applied to each iteration's fresh gradient before
    Adam, as the JAX package does."""
    m = omega_mask.to(grads.omega.dtype)
    return grads._replace(omega=grads.omega * m[:, None],
                          rotation=grads.rotation * (1.0 - m)[:, None])


@torch.no_grad()
def remove_min_max(state: G.GaussianState, maxbounds, minbounds):
    """Prune Gaussians outside the init-time xyz box (helper_train.py:
    167-180), in place."""
    mx = torch.as_tensor(np.asarray(maxbounds), dtype=state.xyz.dtype,
                         device=state.xyz.device)
    mn = torch.as_tensor(np.asarray(minbounds), dtype=state.xyz.dtype,
                         device=state.xyz.device)
    outside = torch.any((state.xyz > mx[None]) | (state.xyz < mn[None]), dim=1)
    state.live &= ~outside
    return state


@torch.no_grad()
def prune_z_below(state: G.GaussianState, z_thresh: float = 4.5):
    """Mode-1 stability prune of xyz.z < 4.5 (helper_train.py:212-215)."""
    state.live &= ~(state.xyz[:, 2] < z_thresh)
    return state


def control_gaussians(state: G.GaussianState, stats: DensifyStats,
                      opt_state: AdamState, key: tuple,
                      iteration: int, flag: int, opt_cfg,
                      scene_extent: float, is_dynamic: bool,
                      mode: int = 2, omega_mask: torch.Tensor | None = None,
                      maxbounds=None, minbounds=None,
                      total_iterations: int = 10_000):
    """The host-level controller, ``controlgaussians`` (helper_train.py:
    183-289; ``densify.py:300-394``). Mode 2 is what the shipped train path
    hardcodes; modes 1 (N3D, with the ω freeze past iteration 8001) and 3
    (Technicolor thresholds) are there for inventory. ``key`` is the split
    noise's key (:func:`split_noise`).

    Returns (state, opt_state, stats, flag, omega_mask, n_dropped);
    ``omega_mask`` is not None only in mode 1 past iteration 8001, and the
    caller then runs the step's ω-freeze variant."""
    if mode not in (1, 2, 3):
        raise ValueError(f"unknown densify mode {mode}")
    dropped = 0

    def _densify(thr):
        nonlocal state, opt_state, stats, dropped
        state, opt_state, stats, n_drop = densify_clone_split(
            state, stats, opt_state, key, grad_threshold=thr,
            percent_dense=opt_cfg.percent_dense, scene_extent=scene_extent)
        dropped += int(n_drop)

    at_interval = (iteration > opt_cfg.densify_from_iter
                   and iteration % opt_cfg.densification_interval == 0)

    if mode == 2:  # helper_train.py:222-258
        if iteration < opt_cfg.densify_until_iter:
            if at_interval:
                if flag < opt_cfg.desicnt:
                    _densify(opt_cfg.densify_grad_threshold
                             * (0.5 if is_dynamic else 1.0))
                    if not is_dynamic:
                        flag += 1
                else:
                    state = prune_by_opacity(state, opt_cfg.opthr)
            if iteration % opt_cfg.opacity_reset_interval == 0:
                state, opt_state = reset_opacity(state, opt_state)
        return state, opt_state, stats, flag, None, dropped

    if mode == 1:  # helper_train.py:185-217
        if iteration < opt_cfg.densify_until_iter:
            if iteration == 8001:
                state, opt_state, omega_mask = zero_omega_by_motion(
                    state, opt_state)
            if at_interval:
                if flag < opt_cfg.desicnt:
                    _densify(opt_cfg.densify_grad_threshold)
                    flag += 1
                elif iteration < 7000:
                    state = prune_by_opacity(state, opt_cfg.opthr)
            if iteration % 3000 == 0:
                state, opt_state = reset_opacity(state, opt_state)
        else:
            if iteration % 1000 == 500:
                state = prune_z_below(state)
            if iteration == total_iterations and maxbounds is not None:
                state = remove_min_max(state, maxbounds, minbounds)
        return state, opt_state, stats, flag, omega_mask, dropped

    # mode 3 — helper_train.py:265-289 (Technicolor)
    if iteration < opt_cfg.densify_until_iter:
        if at_interval:
            if flag < opt_cfg.desicnt:
                _densify(opt_cfg.densify_grad_threshold
                         * (1.0 if is_dynamic else 1e-2))
                flag += 1
            elif iteration < 7000:
                state = prune_by_opacity(state, opt_cfg.opthr)
        if iteration % opt_cfg.opacity_reset_interval == 0:
            state, opt_state = reset_opacity(state, opt_state)
    else:
        if iteration == total_iterations and maxbounds is not None:
            state = remove_min_max(state, maxbounds, minbounds)
    return state, opt_state, stats, flag, None, dropped
