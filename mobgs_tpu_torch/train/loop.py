"""The host training loop (port of ``mobgs_tpu/train/loop.py``).

Mirrors reference ``scene_reconstruction`` (train.py:202-823) as the JAX
package's ``train`` does: a step per iteration, the exposure re-estimation
every 10 iterations past ``start_warp_exposure``, densification through
``densify.control_gaussians`` every ``densification_interval``, opacity
resets, pool growth on densify pressure, the tile-capacity drift check and
the budget de-escalation, resume, and the hooks. The device work is in
``train/step.py`` and ``train/densify.py``; this file samples batches and
sequences calls.

Where the JAX package re-jits, this loop builds a new step closure (cheap:
nothing is compiled); where it donates buffers, the step and densify write
into the state's tensors in place, and pool growth hands the loop new ones.
The split noise is keyed by (seed, iteration, pool) instead of a PRNG key
split at every boundary, so a resumed run needs no replay of it.
"""

from __future__ import annotations

import random
import time as _time
from typing import Callable

import numpy as np
import torch

from mobgs_tpu_torch import resolve_device
from mobgs_tpu_torch.data.synthetic import SceneData
from mobgs_tpu_torch.models import render as R
from mobgs_tpu_torch.ops import projection as P
from mobgs_tpu_torch.ops import tiles as T
from mobgs_tpu_torch.ops.rasterize import (RasterConfig, rasterize,
                                           validate_max_per_tile)
from mobgs_tpu_torch.train import densify as D
from mobgs_tpu_torch.train.step import (Batch, TrainState, make_exposure_update,
                                        make_train_step)
from mobgs_tpu_torch.utils import observability as obs

DYN_POOL, STAT_POOL = 0, 1  # the last element of a split-noise key


class BatchSampler:
    """Without-replacement view sampler (train.py:330-350 semantics). A
    numpy generator, so a seed gives the JAX package's view ids."""

    def __init__(self, num_views: int, batch_size: int, seed: int = 0):
        self.num_views = num_views
        self.batch_size = batch_size
        self.rng = np.random.default_rng(seed)
        self.pool: list[int] = []

    def next_ids(self) -> np.ndarray:
        ids = []
        for _ in range(self.batch_size):
            if not self.pool:
                self.pool = list(range(self.num_views))
            j = self.rng.integers(len(self.pool))
            ids.append(self.pool.pop(j))
        return np.asarray(ids, np.int64)


class FineSampler:
    """Temporal-coherence epoch sampler (``loop.py:49-80``, the reference's
    ``utils/loader_utils.py:20-50``; library code that the shipped defaults
    do not use). For each timestamp a random pose permutation with, after
    every second element, 2 samples replayed from the epoch so far. The
    reference's inner loop overwrites ``now_list`` on each of its 4 passes
    and appends after the loop, so only the last permutation survives; kept.
    The draws come from ``np.random.default_rng(seed)`` and
    ``random.Random(seed)``, so a seed gives the JAX package's list."""

    def __init__(self, num_views: int, frame_length: int, seed: int = 0):
        self.rng = np.random.default_rng(seed)
        py_rng = random.Random(seed)
        sample_list: list[int] = []
        for i in range(frame_length):
            for _ in range(4):
                idx = self.rng.permutation(num_views) * frame_length + i
                now_list: list[int] = []
                cnt = 0
                for item in idx.tolist():
                    now_list.append(int(item))
                    cnt += 1
                    if cnt % 2 == 0 and len(sample_list) > 2:
                        now_list += py_rng.sample(sample_list, 2)
            sample_list += now_list
        self.sample_list = sample_list

    def __iter__(self):
        return iter(self.sample_list)

    def __len__(self):
        return len(self.sample_list)


def make_batch(data: SceneData, ids: np.ndarray, device=None) -> Batch:
    """The views ``ids`` of ``data`` as a Batch on ``device``."""
    dev = resolve_device(device)

    def on(x, dtype=torch.float32):
        return torch.as_tensor(np.asarray(x), dtype=dtype).to(dev)

    return Batch(view_idx=on(ids, torch.int64), w2c=on(data.w2c[ids]),
                 K=on(data.K[ids]), time=on(data.time[ids]),
                 image=on(data.images[ids]), depth=on(data.depths[ids]),
                 blur_feat=on(data.blur_feats[ids]))


class DeviceBatcher:
    """Device-resident batch source: every view is uploaded once and
    batches are gathered on the device (``loop.py:99-125``)."""

    def __init__(self, data: SceneData, device=None):
        dev = self.device = resolve_device(device)

        def on(x):
            return torch.as_tensor(np.asarray(x), dtype=torch.float32).to(dev)

        self.w2c, self.K, self.time = on(data.w2c), on(data.K), on(data.time)
        self.images, self.depths = on(data.images), on(data.depths)
        self.blur_feats = on(data.blur_feats)

    def __call__(self, ids: np.ndarray) -> Batch:
        i = torch.as_tensor(np.asarray(ids), dtype=torch.int64).to(self.device)
        return Batch(view_idx=i, w2c=self.w2c[i], K=self.K[i],
                     time=self.time[i], image=self.images[i],
                     depth=self.depths[i], blur_feat=self.blur_feats[i])


def _view0(data: SceneData, dev):
    return (torch.as_tensor(np.asarray(data.time[0]), dtype=torch.float32).to(dev),
            torch.as_tensor(np.asarray(data.w2c[0]), dtype=torch.float32).to(dev),
            torch.as_tensor(np.asarray(data.K[0]), dtype=torch.float32).to(dev))


@torch.no_grad()
def revalidate_capacity(ts: TrainState, data: SceneData,
                        raster_cfg: RasterConfig, max_time: float,
                        observed_peak: int = 0) -> int:
    """The measured per-tile capacity validation on the CURRENT state
    (camera 0, ``loop.py:128-147``). Returns the validated max_per_tile
    (≥ raster_cfg.max_per_tile)."""
    t0, w2c, K = _view0(data, ts.stat.xyz.device)
    g = R.assemble(ts.stat, ts.dyn, t0, max_time)
    return validate_max_per_tile(
        g.means, g.quats, g.scales, g.opacity, g.colors, w2c, K,
        data.width, data.height, raster_cfg, observed_peak=observed_peak)


def scene_extent_of(points: np.ndarray) -> float:
    """Point-cloud bounding-sphere extent (fallback when no cameras)."""
    c = points.mean(0)
    return float(1.1 * np.linalg.norm(points - c, axis=1).max())


def scene_extent_from_cameras(w2cs: np.ndarray) -> float:
    """Reference `getNerfppNorm` (dataset_readers.py:106-130): 1.1 x the
    max distance of any camera centre from the average camera centre."""
    c2ws = np.linalg.inv(w2cs)
    centers = c2ws[:, :3, 3]
    avg = centers.mean(0)
    diag = np.linalg.norm(centers - avg, axis=1).max()
    return float(diag * 1.1)


def train(ts: TrainState, data: SceneData, opt_cfg, blce_cfg,
          iterations: int, raster_cfg: RasterConfig = RasterConfig(),
          scene_extent: float = 5.0, seed: int = 0,
          log_every: int = 50, on_log: Callable | None = None,
          eval_every: int = 0, on_eval: Callable | None = None,
          debug_every: int = 0, on_debug: Callable | None = None,
          viewer=None, viewer_render: Callable | None = None,
          checkpoint_every: int = 0, on_checkpoint: Callable | None = None,
          densify_mode: int = 2, start_iter: int = 1,
          pool_growth: bool = True, max_capacity: int = 400_000,
          base_raster_cfg: RasterConfig | None = None,
          deescalate_every: int = 500, device=None):
    """Run the fine-stage loop (``loop.py:162-503``). Returns (ts, history).

    The signature and defaults are the JAX package's, plus ``device``: the
    state must live there (the card unless ``"cpu"``; no card raises).

    start_iter: the first iteration to run. A run restored from a
    full-state checkpoint (``io/checkpoint.py``) continues at
    ``ts.step + 1``; the batch sampler and the desicnt flags are
    fast-forwarded, so it draws the batches and the split noise of an
    uninterrupted run.

    densify_mode: the controlgaussians dispatch (helper_train.py:183-289);
    the reference train path hardcodes 2. Mode 1 swaps in the ω-freeze
    step variant past iteration 8001.

    History: one entry per ``log_every`` iterations and at the last, with
    the step's Metrics as floats and ``tile_max``, ``max_per_tile``,
    ``iter``, ``elapsed``, ``n_stat``, ``n_dyn``, ``densify_dropped_stat``
    and ``densify_dropped_dyn``, the JAX package's keys; and
    ``tiles_per_gauss``, which the JAX package's entries lack, so that the
    budgets a step ran at can be read back. A non-finite loss there raises
    FloatingPointError. ``tile_max`` is read from the device only at those
    iterations and at densify boundaries, as in the JAX loop.

    Spans (``utils/observability.py``, off unless ``tracing`` turned them
    on): each iteration runs in ``iteration``, its stages in its children
    ``batch``, ``step`` (with the step's ``forward``, ``backward`` and
    ``update``), ``expo_update``, ``budgets``, ``densify`` and ``read``
    (the log iterations' device reads); the hooks run after it in the root
    spans ``eval``, ``debug`` and ``checkpoint``.
    """
    want, dev = resolve_device(device), ts.stat.xyz.device
    if dev.type != want.type or want.index not in (None, dev.index):
        raise ValueError(f"the state is on {dev}, not {want}")
    V = data.w2c.shape[0]
    E = blce_cfg.num_warp
    # start_warp staging (reference train.py:471,503-507): before start_warp
    # the step trains on the mid render alone; between start_warp and
    # start_warp_dynamic the latent renders use no exposure shift
    sw = getattr(blce_cfg, "start_warp", 0)
    swd = getattr(blce_cfg, "start_warp_dynamic", 0)
    _step_cache: dict = {}

    def step_for(it: int, freeze: bool = False):
        wl = it > sw
        key = (wl, wl and it > swd, freeze)
        if key not in _step_cache:
            # spatial_lr_scale = cameras_extent (scene/__init__.py:81,113)
            _step_cache[key] = make_train_step(
                opt_cfg, data.width, data.height, data.max_time, E,
                raster_cfg, spatial_lr_scale=scene_extent,
                with_latents=key[0], with_exposure_delta=key[1],
                with_omega_freeze=key[2])
        return _step_cache[key]
    expo_fn = make_exposure_update(data.width, data.height, data.max_time,
                                   E, raster_cfg)

    def maybe_escalate_capacity(ts_now, it, observed_tile_max):
        """When the pre-clamp occupancy outgrew max_per_tile in the last
        window, re-validate the capacity on the current state and escalate
        it if truncation is not transmittance-saturated."""
        nonlocal raster_cfg, expo_fn
        if observed_tile_max <= raster_cfg.max_per_tile:
            return False
        new_k = revalidate_capacity(ts_now, data, raster_cfg, data.max_time,
                                    observed_peak=observed_tile_max)
        if new_k <= raster_cfg.max_per_tile:
            print(f"[tile_max] occupancy peaked at {observed_tile_max} > "
                  f"max_per_tile={raster_cfg.max_per_tile} at iter {it}, "
                  f"but truncation is transmittance-saturated (validated "
                  f"lossless) — keeping the capacity")
            return False
        print(f"[tile_max] occupancy {observed_tile_max} > max_per_tile="
              f"{raster_cfg.max_per_tile} at iter {it} and truncation is "
              f"NOT saturated; escalating max_per_tile -> {new_k}")
        raster_cfg = raster_cfg._replace(max_per_tile=new_k)
        _step_cache.clear()
        expo_fn = make_exposure_update(data.width, data.height,
                                       data.max_time, E, raster_cfg)
        return True

    # measured budget de-escalation (loop.py:246-318): every
    # `deescalate_every` iterations while the budgets sit above the base
    # config, composite view 0 at the current budgets and at candidate
    # budgets (the tile span suggested by the current radii, the capacity
    # ladder from the base up) and adopt the cheapest candidate within 60 dB.
    # This mirrors the JAX code, guard included: the suggested span can
    # raise tiles_per_gauss, and then the guard below stops the descent
    # short of the base (the JAX suite's
    # test_budget_deescalation_returns_to_base fails on it; the port keeps
    # the reference package's behaviour rather than the test's intent).
    @torch.no_grad()
    def _render_view0(ts_now, cfg):
        t0, w2c, K = _view0(data, dev)
        g = R.assemble(ts_now.stat, ts_now.dyn, t0, data.max_time)
        return rasterize(g.means, g.quats, g.scales, g.opacity, g.colors,
                         w2c, K, data.width, data.height,
                         config=cfg).images[0]

    @torch.no_grad()
    def maybe_deescalate_budgets(ts_now, it):
        nonlocal raster_cfg, expo_fn
        base = base_raster_cfg
        if base is None:
            return False
        cur_t, cur_k = raster_cfg.tiles_per_gauss, raster_cfg.max_per_tile
        if cur_t <= base.tiles_per_gauss and cur_k <= base.max_per_tile:
            return False
        t0, w2c, K = _view0(data, dev)
        g = R.assemble(ts_now.stat, ts_now.dyn, t0, data.max_time)
        sp = P.project(g.means, g.quats, g.scales, w2c, K, data.width,
                       data.height, eps2d=raster_cfg.eps2d,
                       near=raster_cfg.near, sigma_cut=raster_cfg.sigma_cut)
        cand_t = max(base.tiles_per_gauss,
                     T.suggest_tiles_per_gauss(sp.radii))
        ladder = [b for b in (256, 384, 512, 768, 1024, 1536)
                  if base.max_per_tile <= b]
        cand_ks = [k for k in ladder if k < cur_k or cand_t < cur_t]
        if cand_t >= cur_t and not any(k < cur_k for k in cand_ks):
            return False
        ref = _render_view0(ts_now, raster_cfg)
        for k in cand_ks:
            if cand_t == cur_t and k >= cur_k:
                continue
            cand = raster_cfg._replace(tiles_per_gauss=cand_t,
                                       max_per_tile=k)
            img = _render_view0(ts_now, cand)
            mse = float(torch.mean((img - ref) ** 2))
            if 10.0 * np.log10(1.0 / max(mse, 1e-12)) < 60.0:
                continue
            print(f"[budgets] splat distribution shrank: tiles_per_gauss "
                  f"{cur_t} -> {cand_t}, max_per_tile {cur_k} -> {k} "
                  f"validated lossless at iter {it}", flush=True)
            raster_cfg = cand
            _step_cache.clear()
            expo_fn = make_exposure_update(data.width, data.height,
                                           data.max_time, E, raster_cfg)
            return True
        return False

    sampler = BatchSampler(V, opt_cfg.batch_size, seed)
    batcher = DeviceBatcher(data, dev)
    flag_s, flag_d = 0, 0
    # modes 1/3: init-time xyz extremes for the end-of-train remove_min_max
    # prune (reference train.py:216-228)
    omega_mask_s = omega_mask_d = None
    bounds_s = bounds_d = (None, None)
    if densify_mode != 2:
        def _bounds(st):
            pts = st.xyz.detach()[st.live].cpu().numpy()
            return pts.max(0), pts.min(0)
        bounds_s, bounds_d = _bounds(ts.stat), _bounds(ts.dyn)
    # candidates the pools rejected since the run began
    dropped_s, dropped_d = 0, 0
    # max tile occupancy seen at logged iterations since the last
    # densify-boundary drift check
    tile_max_seen = 0

    # resume fast-forward: replay the sampler and the desicnt flags up to
    # start_iter (the split noise is keyed by iteration and needs none).
    # The mode-1 ω-freeze mask past 8001 is re-derived from the state.
    if start_iter > 1 and densify_mode == 1 and start_iter > 8001:
        _, _, omega_mask_s = D.zero_omega_by_motion(ts.stat, ts.stat_opt)
        _, _, omega_mask_d = D.zero_omega_by_motion(ts.dyn, ts.dyn_opt)
    for _it in range(1, start_iter):
        sampler.next_ids()
        at_int = (_it > opt_cfg.densify_from_iter
                  and _it % opt_cfg.densification_interval == 0)
        if _it < opt_cfg.densify_until_iter and at_int:
            if flag_s < opt_cfg.desicnt:
                flag_s += 1
            if densify_mode != 2 and flag_d < opt_cfg.desicnt:
                flag_d += 1

    history = []
    t0 = _time.time()

    for it in range(start_iter, iterations + 1):
        with obs.span("iteration"):
            with obs.span("batch"):
                # SIBR viewer poll (reference train.py:293-309)
                if viewer is not None and viewer_render is not None:
                    viewer.poll(lambda msg: viewer_render(ts, msg))
                ids = sampler.next_ids()
                batch = batcher(ids)
            freeze = densify_mode == 1 and omega_mask_s is not None
            with obs.span("step"):
                if freeze:
                    ts, metrics = step_for(it, True)(ts, batch, omega_mask_s,
                                                     omega_mask_d)
                else:
                    ts, metrics = step_for(it)(ts, batch)

            # exposure re-estimation every 10 iterations for every batch view
            # (reference train.py:474-492)
            if it > blce_cfg.start_warp_exposure and it % 10 == 0:
                with obs.span("expo_update"):
                    i = batch.view_idx
                    fwd = torch.clamp(i + 1, max=V - 1)
                    bwd = torch.clamp(i - 1, min=0)
                    ts = expo_fn(ts, i, batcher.w2c[i], batcher.K[i],
                                 batcher.time[i], batcher.blur_feats[i],
                                 batcher.w2c[fwd], batcher.w2c[bwd],
                                 (i == 0) | (i == V - 1))

            with obs.span("budgets"):
                # capacity drift check at every densify interval, on the
                # boundary iteration's tile_max and the logged iterations'
                # since the last boundary (a device read every iteration
                # would sync every step)
                if it % opt_cfg.densification_interval == 0:
                    observed = max(tile_max_seen, int(metrics.tile_max))
                    tile_max_seen = 0
                    maybe_escalate_capacity(ts, it, observed)
                if deescalate_every and it % deescalate_every == 0:
                    maybe_deescalate_budgets(ts, it)

            with obs.span("densify"):
                # densification (helper_train.py:183-289), the dynamic pool
                # first, each pool with its own split-noise key
                dyn, dyn_opt, dyn_stats, flag_d, omega_mask_d, nd = \
                    D.control_gaussians(
                        ts.dyn, ts.dyn_stats, ts.dyn_opt, (seed, it, DYN_POOL),
                        it, flag_d, opt_cfg, scene_extent, is_dynamic=True,
                        mode=densify_mode, omega_mask=omega_mask_d,
                        maxbounds=bounds_d[0], minbounds=bounds_d[1],
                        total_iterations=iterations)
                stat, stat_opt, stat_stats, flag_s, omega_mask_s, ns = \
                    D.control_gaussians(
                        ts.stat, ts.stat_stats, ts.stat_opt,
                        (seed, it, STAT_POOL), it, flag_s, opt_cfg,
                        scene_extent, is_dynamic=False, mode=densify_mode,
                        omega_mask=omega_mask_s, maxbounds=bounds_s[0],
                        minbounds=bounds_s[1], total_iterations=iterations)
                dropped_d += nd
                dropped_s += ns
                # pool growth on densify pressure (the reference grows its
                # tensors without bound, gaussian_model.py:1093-1123): new,
                # padded tensors for the state, its moments and its stats;
                # the TrainState below is the only holder the loop keeps
                if pool_growth and (nd > 0 or ns > 0):
                    if ns > 0:
                        stat, stat_opt, stat_stats, cap2 = D.grow_pool(
                            stat, stat_opt, stat_stats, ns,
                            max_capacity=max_capacity)
                        if cap2 > ts.stat.capacity:
                            print(f"[grow] static pool {ts.stat.capacity} -> "
                                  f"{cap2} at iter {it} ({ns} candidates dropped)")
                    if nd > 0:
                        dyn, dyn_opt, dyn_stats, cap2 = D.grow_pool(
                            dyn, dyn_opt, dyn_stats, nd,
                            max_capacity=max_capacity)
                        if cap2 > ts.dyn.capacity:
                            print(f"[grow] dynamic pool {ts.dyn.capacity} -> "
                                  f"{cap2} at iter {it} ({nd} candidates dropped)")
                ts = ts._replace(stat=stat, stat_opt=stat_opt,
                                 stat_stats=stat_stats, dyn=dyn,
                                 dyn_opt=dyn_opt, dyn_stats=dyn_stats)

            if it % log_every == 0 or it == iterations:
                with obs.span("read"):
                    m = {k: float(v) for k, v in metrics._asdict().items()}
                    if not np.isfinite(m["loss"]):
                        # fail-stop on NaN like the reference
                        # (train.py:681-683)
                        raise FloatingPointError(
                            f"loss is non-finite at iteration {it}: {m}")
                    m["tile_max"] = int(m.pop("tile_max", 0))
                    tile_max_seen = max(tile_max_seen, m["tile_max"])
                    m["max_per_tile"] = raster_cfg.max_per_tile
                    m["tiles_per_gauss"] = raster_cfg.tiles_per_gauss
                    m.update(iter=it, elapsed=_time.time() - t0,
                             n_stat=int(ts.stat.num_live()),
                             n_dyn=int(ts.dyn.num_live()),
                             densify_dropped_stat=dropped_s,
                             densify_dropped_dyn=dropped_d)
                    history.append(m)
                if on_log:
                    on_log(m)
        if eval_every and on_eval and it % eval_every == 0:
            with obs.span("eval"):
                on_eval(ts, it)
        if debug_every and on_debug and (it == 1 or it % debug_every == 0):
            with obs.span("debug"):
                on_debug(ts, it)
        if checkpoint_every and on_checkpoint and it % checkpoint_every == 0:
            with obs.span("checkpoint"):
                on_checkpoint(ts, it, history)
    return ts, history
