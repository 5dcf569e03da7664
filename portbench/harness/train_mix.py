"""The general generator of training traffic: the fine-stage loop of the
program (``mobgs_tpu_torch.train.loop.train``) driven through its public
arguments.

A training mix (``traffic/<mix>.json``) gives ``start_iter`` (the first
iteration; the state's counter sits one before it), ``warm_until`` (the
last iteration of set-up), optionally ``pools`` (live seeds and capacities
of the static and dynamic pools; the configuration's seeds at its capacity
factor otherwise) and the traced run's ``timed_iters`` (an untraced stretch
that times an iteration) and ``traced_iters`` (the profiled stretch after
it).

Set-up makes the configuration's scene and seed clouds (fixed by the
configuration, as a dataset is) and the weights from the run's seed,
builds the program's state, lets the program validate its raster budgets
as the train CLI does, and runs iterations ``start_iter`` ..
``warm_until`` through the window's own call: the first three are the
steps the reference follows. The window is then one call of the loop, as a
user's run makes it, closed once ``--seconds`` have passed at the end of an
iteration whose next holds no exposure update or boundary of the loop. The
program takes that next step after the window, and the reference takes it
too, from a copy of the program's state before it.
"""

from __future__ import annotations

import dataclasses
import sys
import time

import numpy as np
import torch

from harness import compare, costs, refmodel as R, sampler, scene as S, state as ST

# the train CLI's log interval: the loop reads the device there
LOG_EVERY = 50


class _WindowClosed(Exception):
    """Raised at an iteration's end to close the window."""


class Cell:
    """A training cell's inputs and the program's state."""

    def __init__(self, cfg, mix, seed, dev):
        from mobgs_tpu_torch.config import BlceParams, OptimizationParams
        from mobgs_tpu_torch.data.synthetic import SceneData
        from mobgs_tpu_torch.ops import projection as PJ
        from mobgs_tpu_torch.ops import tiles as TL
        from mobgs_tpu_torch.ops.rasterize import RasterConfig, validate_max_per_tile
        from mobgs_tpu_torch.models import render as RD

        self.dev, self.seed, self.mix = dev, seed, mix
        self.opt = OptimizationParams(**cfg["OptimizationParams"])
        self.blce = BlceParams(**cfg["blceParams"])
        tpu = cfg["TPUParams"]
        sc = cfg["scene"]
        W, H, V = sc["width"], sc["height"], sc["frames"]
        self.scene, traj = S.generate(W, H, V, sc["seed"], dev, sc["gt_static_gaussians"],
                                      sc["gt_dynamic_gaussians"], sc["blur_substeps"],
                                      sc["exposure"])
        pools = mix.get("pools") or dict(
            stat_live=self.opt.stat_npts, dyn_live=self.opt.dyn_npts,
            stat_capacity=int(self.opt.stat_npts * tpu["capacity_mult"]),
            dyn_capacity=int(self.opt.dyn_npts * tpu["capacity_mult"]))
        clouds = S.init_point_clouds(self.scene, traj, pools["stat_live"], pools["dyn_live"],
                                      sc["seed"])
        P = ST.initial_params(self.scene, clouds, (pools["stat_capacity"], pools["dyn_capacity"]),
                              V, self.blce.view_dim, self.blce.num_warp, seed, dev)
        self.P0 = ST.copy_params(P, "cpu")
        self.start = mix["start_iter"]
        if self.opt.densification_interval % LOG_EVERY:
            raise ValueError("the loop's boundaries must fall on its log iterations, where the "
                             "window reads the budgets they set")
        if any(it > self.opt.densify_from_iter and it % self.opt.densification_interval == 0
               for it in range(self.start, self.start + 3)):
            raise ValueError("the reference's three steps hold no densify boundary")
        self.ts = ST.to_program(P, self.start - 1)
        del P
        sd = self.scene
        self.data = SceneData(w2c=sd["w2c"], K=sd["K"], time=sd["time"], images=sd["images"],
                              depths=sd["depths"], blur_feats=sd["blur_feats"], masks=sd["masks"],
                              width=W, height=H, max_time=sd["max_time"], test_w2c=sd["w2c"],
                              test_images=sd["test_images"])
        self.extent = S.extent_from_cameras(sd["w2c"])
        # the train CLI's init validation: the tile-box budget from the
        # splats' radii, the per-tile capacity by a measured composite
        self.base = RasterConfig(tiles_per_gauss=tpu["tiles_per_gauss"],
                                 max_per_tile=tpu["max_per_tile"], tile_chunk=tpu["tile_chunk"])
        rc = self.base
        with torch.no_grad():
            w2c0, K0 = (torch.as_tensor(sd[k][0], device=dev) for k in ("w2c", "K"))
            t0 = torch.as_tensor(sd["time"][0], device=dev)
            g = RD.assemble(self.ts.stat, self.ts.dyn, t0, sd["max_time"])
            sp = PJ.project(g.means, g.quats, g.scales, w2c0, K0, W, H)
            rc = rc._replace(tiles_per_gauss=max(rc.tiles_per_gauss,
                                                 TL.suggest_tiles_per_gauss(sp.radii)))
            k = validate_max_per_tile(g.means, g.quats, g.scales, g.opacity, g.colors,
                                      w2c0, K0, W, H, rc)
        self.rc = rc._replace(max_per_tile=max(k, rc.max_per_tile))
        self.init_budgets = (self.rc.tiles_per_gauss, self.rc.max_per_tile)
        self.batches = sampler.batches(V, self.opt.batch_size, seed, mix["warm_until"] + 5000)

    def chunk(self, a, b, log_every=50):
        """Iterations a..b through the program's loop."""
        from mobgs_tpu_torch.train import loop as L
        self.ts, hist = L.train(self.ts, self.data, self.opt, self.blce, iterations=b,
                                raster_cfg=self.rc, scene_extent=self.extent, seed=self.seed,
                                log_every=log_every, start_iter=a, base_raster_cfg=self.base,
                                device=self.dev)
        last = hist[-1]
        self.rc = self.rc._replace(tiles_per_gauss=last["tiles_per_gauss"],
                                   max_per_tile=last["max_per_tile"])
        return hist

    def expo_at(self, it):
        return it > self.blce.start_warp_exposure and it % 10 == 0

    def boundary(self, it):
        """Whether iteration ``it`` holds an exposure update or a boundary of
        the loop's densify, capacity or budget checks."""
        return self.expo_at(it) or it % self.opt.densification_interval == 0 or it % 500 == 0

    def window(self, seconds, min_iters=0, on_iter=None):
        """One call of the program's loop from the iteration after set-up,
        as the train CLI makes it, closed at the end of the first iteration
        at which ``seconds`` have passed and ``min_iters`` have run, and
        whose next holds no exposure update or boundary (the compared step
        follows it). ``on_iter(k, ts)`` runs at the end of the window's
        k-th iteration (from 1); where it returns true, the ``seconds``
        count again from there. Returns (iterations, seconds, error)."""
        from mobgs_tpu_torch.train import loop as L
        first = self.mix["warm_until"] + 1
        self.last, hist = first - 1, []
        t0 = time.perf_counter()
        clock = [t0]

        def at_end(ts, it):
            self.ts, self.last = ts, it
            if hist:
                self.rc = self.rc._replace(tiles_per_gauss=hist[-1]["tiles_per_gauss"],
                                           max_per_tile=hist[-1]["max_per_tile"])
            k = it - first + 1
            if on_iter is not None and on_iter(k, ts):
                clock[0] = time.perf_counter()
            if (k >= min_iters and time.perf_counter() - clock[0] >= seconds
                    and not self.boundary(it + 1)):
                raise _WindowClosed
        error = None
        try:
            L.train(self.ts, self.data, self.opt, self.blce, iterations=self.opt.iterations,
                    raster_cfg=self.rc, scene_extent=self.extent, seed=self.seed,
                    log_every=LOG_EVERY, on_log=hist.append, eval_every=1, on_eval=at_end,
                    start_iter=first, base_raster_cfg=self.base, device=self.dev)
            error = "the loop ended before the window closed"
        except _WindowClosed:
            pass
        except Exception as exc:  # a raise or a non-finite loss fails the iteration
            error = repr(exc)
        torch.cuda.synchronize(self.dev)
        elapsed = time.perf_counter() - t0
        return self.last - first + 1, elapsed, error

    def post_step(self):
        """The program's step after the window. Returns its readings (the
        loss; each leaf's gradient, from its Adam first moment before and
        after) and a copy of its state before the step, the step and its
        budgets, for the reference."""
        it = self.last + 1
        P, adam = ST.program_snapshot(self.ts)
        budgets = (self.rc.tiles_per_gauss, self.rc.max_per_tile)
        h = self.chunk(it, it, log_every=1)
        names, _, mus = ST.program_leaves(self.ts)
        grad = compare.norms({n: (m.double() - 0.9 * adam["m"][n].double()) / 0.1
                              for n, m in zip(names, mus)})
        return dict(loss=h[-1]["loss"], grad=grad), (P, adam, it, budgets)

    def warm(self):
        """Set-up's iterations. Returns the program's readings of the first
        three."""
        s = self.start
        h1 = self.chunk(s, s, log_every=1)
        names, _, mus = ST.program_leaves(self.ts)
        grad = compare.norms({n: m / 0.1 for n, m in zip(names, mus)})
        h2 = self.chunk(s + 1, s + 2, log_every=1)
        names, params, _ = ST.program_leaves(self.ts)
        p0 = dict(R.leaves(self.P0))
        change = compare.norms({n: p.detach() - p0[n].to(self.dev) for n, p in zip(names, params)})
        expo = None
        for it in range(s, s + 3):
            if self.expo_at(it):
                e = self.ts.blce.exposure_expo.detach().cpu()
                expo = {int(v): float(e[v]) for v in self.batches[it]}
        if self.mix["warm_until"] > s + 2:
            self.chunk(s + 3, self.mix["warm_until"])
        torch.cuda.synchronize(self.dev)
        return dict(losses=[h1[0]["loss"], h2[0]["loss"], h2[1]["loss"]], grad=grad,
                    change=change, expo=expo)

    def batch(self, it, half=False):
        ids = self.batches[it][:1] if half else self.batches[it]
        sd = self.scene

        def on(x, dt=torch.float32):
            return torch.as_tensor(np.asarray(x), dtype=dt, device=self.dev)
        return dict(view=on(ids, torch.int64), w2c=on(sd["w2c"][ids]), K=on(sd["K"][ids]),
                    time=on(sd["time"][ids]), image=on(sd["images"][ids]),
                    depth=on(sd["depths"][ids]), blur=on(sd["blur_feats"][ids]))

    def ref_cfg(self):
        sd = self.scene
        return dict(width=sd["width"], height=sd["height"], num_warp=self.blce.num_warp,
                    max_time=sd["max_time"], lambda_flow_loss=self.opt.lambda_flow_loss,
                    lambda_dssim=self.opt.lambda_dssim, opt=dataclasses.asdict(self.opt),
                    extent=self.extent)

    def own_budgets(self):
        """The budgets of the init validation, worked out by the reference
        on its own projection and composites of view 0."""
        sd = self.scene
        w2c0, K0 = (torch.as_tensor(sd[k][0], device=self.dev) for k in ("w2c", "K"))
        return R.validated_budgets(ST.copy_params(self.P0, self.dev), w2c0, K0, sd["width"],
                                   sd["height"], sd["time"][0], sd["max_time"],
                                   (self.base.tiles_per_gauss, self.base.max_per_tile))

    def reference(self, budgets, post=None, tf32=False, half=False):
        """The reference's readings of the first three steps, from the same
        initial parameters and batches at ``budgets``, and, given ``post``
        (``post_step``'s copy), of the step after the window (TF32 on: the
        control; ``half``: the fault of a step that leaves half of its
        batch out)."""
        R.set_precision(tf32)
        try:
            P = ST.copy_params(self.P0, self.dev)
            p0 = dict(R.leaves(self.P0))
            cfg, adam = self.ref_cfg(), dict(t=0, m={}, v={})
            nbr = torch.as_tensor(self.scene["w2c"], device=self.dev)
            losses, grad, expo = [], None, None
            for it in range(self.start, self.start + 3):
                b = self.batch(it, half)
                loss, g = R.train_step(P, adam, b, cfg, budgets, it)
                losses.append(loss)
                if grad is None:
                    grad = compare.norms(g)
                del g
                if self.expo_at(it):
                    R.exposure_update(P, b, nbr, cfg, budgets)
                    expo = {int(v): float(P["exposure"][v]) for v in self.batches[it]}
            change = compare.norms({n: x - p0[n].to(self.dev) for n, x in R.leaves(P)})
            out = dict(losses=losses, grad=grad, change=change, expo=expo)
            del P, adam
            if post is not None:
                Pp, adam, it, post_budgets = post
                adam = dict(t=adam["t"], m={k: x.clone() for k, x in adam["m"].items()},
                            v={k: x.clone() for k, x in adam["v"].items()})
                loss, g = R.train_step(ST.copy_params(Pp, self.dev), adam, self.batch(it, half),
                                       cfg, post_budgets, it)
                out["post"] = dict(loss=loss, grad=compare.norms(g))
            return out
        finally:
            R.set_precision(False)

    def work(self, P, budgets, iters):
        """The benchmark's own count of the compositor's work in iterations
        ``iters``, on parameters ``P`` (the program's state then) at
        ``budgets``."""
        P = ST.copy_params(P, self.dev)
        cfg, works = self.ref_cfg(), []
        nbr = torch.as_tensor(self.scene["w2c"], device=self.dev)
        with torch.no_grad():
            for it in iters:
                b = self.batch(it)
                R.forward(P, b, cfg, budgets, works=works)
                if self.expo_at(it):
                    R.exposure_update(dict(P, exposure=P["exposure"].clone()), b, nbr, cfg,
                                      budgets, works=works)
        return works


def _log(t_start, msg):
    print(f"[{time.perf_counter() - t_start:8.2f} s] {msg}", file=sys.stderr, flush=True)


def _quantiles(xs):
    """(min, 10th, 50th, 90th percentile, max) of ``xs``."""
    return [float(v) for v in np.percentile(np.asarray(xs), [0, 10, 50, 90, 100])]


def run(cfg, mix, limits, seed, seconds, trace, dev, t_start):
    """One run of a training cell. Returns the harness's result parts."""
    import gc

    from mobgs_tpu_torch.ops import cuda_raster
    cuda_raster.build_kernels()
    _log(t_start, "kernels built")
    cell = Cell(cfg, mix, seed, dev)
    _log(t_start, f"state built, budgets {cell.init_budgets}")
    prog = cell.warm()
    _log(t_start, "set-up iterations done")
    res = dict(attempted=0, failed=0, budgets=cell.init_budgets, layer={})
    setup_s = time.perf_counter() - t_start
    setup_peak = torch.cuda.max_memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    cuda_raster.reset_launches()
    # the host's side of each iteration and of the collector, for the
    # spread of the rate
    ends, gc_s, gc_t = [], [0.0], [0.0]

    def on_gc(phase, info):
        if phase == "start":
            gc_t[0] = time.perf_counter()
        else:
            gc_s[0] += time.perf_counter() - gc_t[0]
    gc.callbacks.append(on_gc)
    try:
        if not trace:
            t0 = time.perf_counter()
            n, elapsed, error = cell.window(
                seconds, on_iter=lambda k, ts: ends.append(time.perf_counter() - t0))
            res["e2e"] = dict(train_it_s=n / elapsed,
                              peak_mem_gib=torch.cuda.max_memory_allocated(dev) / 2**30,
                              setup_s=setup_s)
        else:
            from harness import trace as TR
            nt, nprof = mix["timed_iters"], mix["traced_iters"]
            marks, traced = {}, {}

            # an untraced stretch times an iteration, the profiled one after
            # it reads the device, and the window then runs ``seconds`` more
            # untraced, so that the compared step follows the same
            # boundaries as an untraced run's
            def on_iter(k, ts):
                if k not in (1, 1 + nt, 1 + nt + nprof):
                    return False
                torch.cuda.synchronize(dev)
                marks[k] = time.perf_counter()
                if k == 1 + nt:
                    # the profiler's start (seconds: CUPTI's set-up) lies
                    # outside both stretches
                    marks["untraced_end"] = marks[k]
                    traced["prof"] = TR.Profiler()
                    traced["prof"].start()
                    marks[k] = time.perf_counter()
                if k < 1 + nt + nprof:
                    return False
                traced["prof"].stop()
                traced.update(P=ST.copy_params(ST.from_program(ts), "cpu"),
                              budgets=(cell.rc.tiles_per_gauss, cell.rc.max_per_tile),
                              iters=range(cell.last - nprof + 1, cell.last + 1))
                return True
            n, elapsed, error = cell.window(seconds, min_iters=1 + nt + nprof, on_iter=on_iter)
            if error is None:
                window_s = marks[1 + nt + nprof] - marks[1 + nt]
                tr = TR.reduce(traced["prof"].events(), window_s, nprof)
                _log(t_start, "trace read")
                works = cell.work(traced["P"], traced["budgets"], traced["iters"])
                _log(t_start, "work counted")
                unit_s = (marks["untraced_end"] - marks[1]) / nt
                res["host_trace"] = dict(unit_s=unit_s, traced_unit_s=window_s / nprof)
                res["layer"] = dict(kind="train", trace=tr, unit_s=unit_s,
                                    bound_s=costs.compositor_bound_s(works),
                                    flops_per_unit=costs.flops(works) / nprof)
                res["breakdown"] = tr["breakdown"]
                res["busy_s"], res["window_s"] = tr["busy_s"], tr["window_s"]
    finally:
        gc.callbacks.remove(on_gc)
    res["attempted"] = n + (error is not None)
    res["failed"] = int(error is not None)
    _log(t_start, f"window: {n} iterations in {elapsed:.3f} s, to iteration {cell.last}")
    res["memory_peak_bytes"] = max(setup_peak, torch.cuda.max_memory_allocated(dev))
    res["launches"] = dict(cuda_raster.instance_launches)
    res["final_budgets"] = (cell.rc.tiles_per_gauss, cell.rc.max_per_tile)
    res["error"] = error
    res["host"] = dict(gc_s=gc_s[0], threads=torch.get_num_threads())
    if ends:
        res["host"]["iter_s_quantiles"] = _quantiles(np.diff([0.0] + ends))
    post = None
    if error is None:
        prog["post"], post = cell.post_step()
    # the program's state goes before the reference runs
    cell.ts = None
    torch.cuda.empty_cache()
    budgets = cell.own_budgets()
    ref = cell.reference(budgets, post)
    _log(t_start, f"reference done, its budgets {budgets}")
    numbers = compare.train_numbers(prog, ref)
    numbers["budgets_differ"] = float(sum(a != b for a, b in zip(budgets, cell.init_budgets)))
    res["loss_gap_by_step"] = compare.loss_gaps(prog, ref)
    res["worst_leaves"] = compare.worst_leaves(prog, ref)
    res["correct"], res["checks"] = compare.checks(numbers, limits)
    res["correct"] = res["correct"] and error is None
    return res


def readings(cfg, mix, seed, dev, control=True, seconds=0.0):
    """The compared numbers of one seed for the program (``sound``) and,
    with ``control``, for the control (the reference in TF32 in the
    program's place) and the fault of a step that leaves half of its batch
    out (the reference on the batch's first view in the program's place),
    the step after the window included (a window of ``seconds``)."""
    cell = Cell(cfg, mix, seed, dev)
    prog = cell.warm()
    _, _, error = cell.window(seconds)
    if error is not None:
        raise RuntimeError(error)
    prog["post"], post = cell.post_step()
    cell.ts = None
    torch.cuda.empty_cache()
    budgets = cell.own_budgets()
    ref = cell.reference(budgets, post)
    sound = compare.train_numbers(prog, ref)
    sound["budgets_differ"] = float(sum(a != b for a, b in zip(budgets, cell.init_budgets)))
    out = dict(sound=sound, loss_gap_by_step=compare.loss_gaps(prog, ref), post_iter=post[2],
               worst_leaves=compare.worst_leaves(prog, ref),
               budgets=dict(program=cell.init_budgets, reference=budgets, final=post[3]))
    if control:
        ctl = cell.reference(budgets, post, tf32=True)
        half = cell.reference(budgets, post, half=True)
        out.update(control=compare.train_numbers(ctl, ref),
                   half_batch=compare.train_numbers(half, ref),
                   control_loss_gap_by_step=compare.loss_gaps(ctl, ref),
                   half_batch_loss_gap_by_step=compare.loss_gaps(half, ref))
    return out
