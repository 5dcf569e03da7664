"""The general generator of viewer traffic: one client in a closed loop
with no think time, each request a SIBR camera message whose answer is the
host image of ``mobgs_tpu_torch.viewer.make_viewer_render``'s callback.

A viewer mix (``traffic/<mix>.json``) gives ``pools`` (the scene state's
live seeds and capacities), ``jitter_rad`` and ``jitter_m`` (the seeded
rotation and translation noise on the orbit's poses, which the requests
visit in turn), ``time`` (the scene time the viewer shows), ``warm_requests``
(served in set-up), ``sample`` (requests kept for the comparison, drawn
from the seed by reservoir) and ``traced_requests`` (served untraced to time
a request, then again under the profiler).
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from harness import compare, costs, refmodel as R, scene as S, state as ST


def _rotation(v):
    th = float(np.linalg.norm(v))
    if th < 1e-12:
        return np.eye(3)
    k = v / th
    Kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(th) * Kx + (1 - np.cos(th)) * Kx @ Kx


class Cameras:
    """The request stream: the orbit's poses in turn, each with a seeded
    jitter, as SIBR messages (the view matrix transposed, its y and z
    columns negated), decoded as the viewer bridge decodes them."""

    def __init__(self, w2c, W, H, mix, seed):
        self.w2c, self.W, self.H = w2c, W, H
        self.jr, self.jm = mix["jitter_rad"], mix["jitter_m"]
        self.rng = np.random.default_rng(seed)
        self.i = 0

    def next(self):
        base = self.w2c[self.i % len(self.w2c)].astype(np.float64)
        self.i += 1
        d = np.eye(4)
        d[:3, :3] = _rotation(self.rng.normal(0.0, self.jr, 3))
        d[:3, 3] = self.rng.normal(0.0, self.jm, 3)
        w2c = (d @ base).astype(np.float32)
        view = w2c.T.copy()
        view[:, 1] *= -1
        view[:, 2] *= -1
        msg = {"resolution_x": self.W, "resolution_y": self.H, "train": True,
               "shs_python": False, "rot_scale_python": False, "keep_alive": False,
               "scaling_modifier": 1.0, "view_matrix": view.reshape(-1).tolist()}
        dec = np.asarray(msg["view_matrix"], np.float32).reshape(4, 4)
        dec[:, 1] *= -1
        dec[:, 2] *= -1
        msg["_w2c"] = dec.T
        return msg


def setup(cfg, mix, seed, dev):
    """The scene, the state (the benchmark's parameters and the program's
    copy), the program's validated budgets, its viewer callback and the
    request stream."""
    from mobgs_tpu_torch.models import render as RD
    from mobgs_tpu_torch.ops import projection as PJ
    from mobgs_tpu_torch.ops import tiles as TL
    from mobgs_tpu_torch.ops.rasterize import RasterConfig, validate_max_per_tile
    from mobgs_tpu_torch.viewer import make_viewer_render

    sc, tpu, pools = cfg["scene"], cfg["TPUParams"], mix["pools"]
    W, H, V = sc["width"], sc["height"], sc["frames"]
    scene, traj = S.generate(W, H, V, sc["seed"], dev, sc["gt_static_gaussians"],
                             sc["gt_dynamic_gaussians"], sc["blur_substeps"], sc["exposure"])
    clouds = S.init_point_clouds(scene, traj, pools["stat_live"], pools["dyn_live"], sc["seed"])
    P = ST.initial_params(scene, clouds, (pools["stat_capacity"], pools["dyn_capacity"]), V,
                          cfg["blceParams"]["view_dim"], cfg["blceParams"]["num_warp"], seed, dev)
    P0 = ST.copy_params(P, "cpu")
    ts = ST.to_program(P, 0)
    del P
    rc = RasterConfig(tiles_per_gauss=tpu["tiles_per_gauss"], max_per_tile=tpu["max_per_tile"],
                      tile_chunk=tpu["tile_chunk"])
    with torch.no_grad():
        w2c0, K0 = (torch.as_tensor(scene[k][0], device=dev) for k in ("w2c", "K"))
        g = RD.assemble(ts.stat, ts.dyn, torch.as_tensor(scene["time"][0], device=dev),
                        scene["max_time"])
        sp = PJ.project(g.means, g.quats, g.scales, w2c0, K0, W, H)
        rc = rc._replace(tiles_per_gauss=max(rc.tiles_per_gauss,
                                             TL.suggest_tiles_per_gauss(sp.radii)))
        rc = rc._replace(max_per_tile=max(rc.max_per_tile, validate_max_per_tile(
            g.means, g.quats, g.scales, g.opacity, g.colors, w2c0, K0, W, H, rc)))
    render = make_viewer_render(ts.stat, ts.dyn, ts.sandwich, scene["K"][0], W, H,
                                scene["max_time"], config=rc)
    return scene, P0, ts, (rc.tiles_per_gauss, rc.max_per_tile), render, \
        Cameras(scene["w2c"], W, H, mix, seed)


def readings(cfg, mix, seed, dev, control=True, seconds=0.0):
    """The program's and (with ``control``) the control's compared numbers
    on ``sample`` requests of one seed (``seconds``, the training mix's
    window, is not used: these requests need none)."""
    scene, P0, ts, budgets, render, cams = setup(cfg, mix, seed, dev)
    kept = []
    for _ in range(mix["warm_requests"] + mix["sample"]):
        msg = cams.next()
        kept.append((msg["_w2c"], render(msg)))
    kept = kept[mix["warm_requests"]:]
    del ts, render
    torch.cuda.empty_cache()
    out = dict(sound={"image_gap": reference_gap(P0, kept, scene, budgets, mix, dev)})
    if control:
        out["control"] = {"image_gap": _control_gap(P0, kept, scene, budgets, mix, dev)}
    return out


def _log(t_start, msg):
    print(f"[{time.perf_counter() - t_start:8.2f} s] {msg}", file=sys.stderr, flush=True)


def run(cfg, mix, limits, seed, seconds, trace, dev, t_start):
    """One run of a viewer cell. Returns the harness's result parts."""
    from mobgs_tpu_torch.ops import cuda_raster

    cuda_raster.build_kernels()
    _log(t_start, "kernels built")
    scene, P0, ts, budgets, render, cams = setup(cfg, mix, seed, dev)
    _log(t_start, f"state built, budgets {budgets}")
    W, H = scene["width"], scene["height"]
    for _ in range(mix["warm_requests"]):
        render(cams.next())
    torch.cuda.synchronize(dev)
    res = dict(attempted=0, failed=0, budgets=budgets, layer={}, error=None)
    setup_s = time.perf_counter() - t_start
    setup_peak = torch.cuda.max_memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    cuda_raster.reset_launches()
    keep_rng = np.random.default_rng([seed, 1])
    kept, lat = [], []

    def serve():
        msg = cams.next()
        t = time.perf_counter()
        try:
            img = render(msg)
            ok = img.shape == (H, W, 3) and bool(np.isfinite(img).all())
        except Exception as exc:  # a raise fails the request
            res["error"], img, ok = repr(exc), None, False
        lat.append(time.perf_counter() - t)
        res["attempted"] += 1
        res["failed"] += int(not ok)
        n = res["attempted"]
        # reservoir sample of the answered requests, drawn from the seed
        if ok and len(kept) < mix["sample"]:
            kept.append((msg["_w2c"], img))
        elif ok and keep_rng.integers(n) < mix["sample"]:
            kept[int(keep_rng.integers(mix["sample"]))] = (msg["_w2c"], img)

    if not trace:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            serve()
        _log(t_start, f"window: {res['attempted']} requests")
        ms = np.asarray(lat) * 1e3
        res["e2e"] = dict(view_ms_p95=float(np.percentile(ms, 95)), setup_s=setup_s)
    else:
        from harness import trace as TR
        n = mix["traced_requests"]
        t0 = time.perf_counter()
        for _ in range(n):
            serve()
        torch.cuda.synchronize(dev)
        unit_s = (time.perf_counter() - t0) / n
        first = cams.i
        with TR.profiled() as ev:
            t1 = time.perf_counter()
            for _ in range(n):
                serve()
            torch.cuda.synchronize(dev)
            window_s = time.perf_counter() - t1
        tr = TR.reduce(ev, window_s, n)
        _log(t_start, "trace read")
        replay = Cameras(scene["w2c"], W, H, mix, seed)
        for _ in range(first):
            replay.next()
        Pp, works = ST.from_program(ts), []
        K = torch.as_tensor(scene["K"][0], device=dev)
        for _ in range(n):
            R.view_render(Pp, torch.as_tensor(replay.next()["_w2c"], device=dev), K, W, H,
                          scene["max_time"], budgets, t=mix["time"], works=works)
        res["layer"] = dict(kind="view", trace=tr, unit_s=unit_s,
                            bound_s=costs.compositor_bound_s(works))
        res["breakdown"] = tr["breakdown"]
        res["busy_s"], res["window_s"] = tr["busy_s"], tr["window_s"]
    res["memory_peak_bytes"] = max(setup_peak, torch.cuda.max_memory_allocated(dev))
    res["launches"] = dict(cuda_raster.instance_launches)
    res["final_budgets"] = budgets
    del ts, render
    torch.cuda.empty_cache()
    numbers = {"image_gap": reference_gap(P0, kept, scene, budgets, mix, dev)}
    res["correct"], res["checks"] = compare.checks(numbers, limits)
    res["correct"] = res["correct"] and res["failed"] == 0 and bool(kept)
    return res


def _renders(P0, cams, scene, budgets, mix, dev, tf32=False):
    R.set_precision(tf32)
    try:
        P = ST.copy_params(P0, dev)
        K = torch.as_tensor(scene["K"][0], device=dev)
        return [R.view_render(P, torch.as_tensor(w, device=dev), K, scene["width"],
                              scene["height"], scene["max_time"], budgets,
                              t=mix["time"]).cpu().numpy() for w in cams]
    finally:
        R.set_precision(False)


def reference_gap(P0, kept, scene, budgets, mix, dev):
    """The compared number of the kept answers against the reference's
    renders of the same cameras."""
    refs = _renders(P0, [w for w, _ in kept], scene, budgets, mix, dev)
    return compare.image_gap([img for _, img in kept], refs)


def _control_gap(P0, kept, scene, budgets, mix, dev):
    """The same number for the control: the reference in TF32 in the
    program's place."""
    cams = [w for w, _ in kept]
    ref = _renders(P0, cams, scene, budgets, mix, dev)
    return compare.image_gap(_renders(P0, cams, scene, budgets, mix, dev, tf32=True), ref)
