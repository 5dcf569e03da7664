"""Training CLI, the port of ``mobgs_tpu/cli/train.py`` with its flags,
defaults and behaviour.

  python -m mobgs_tpu_torch.cli.train -s data/stereo/seesaw/dense \\
      --configs configs/stereo/seesaw.py --expname stereo/seesaw
  python -m mobgs_tpu_torch.cli.train --synthetic --iterations 100
  python -m mobgs_tpu_torch.cli.train --configs configs/stereo/seesaw.py \\
      --synthetic --synthetic_size 512x288x24 --expname seesaw_synth

It trains on the card (``main(device="cpu")`` runs it on the CPU, as the
tests do) and writes what the JAX CLI writes under ``-m`` (default
``output/<expname>``): ``cfg_args.json``; ``history.json`` (and
``history_partial.json`` with ``train_state_latest.npz`` every 500
iterations); ``eval_curve.json``; ``point_cloud/iteration_<N>`` and
``iteration_best`` with ``point_cloud.ply`` + ``point_cloud.pt`` (the
dynamic pool and the decoder), ``point_cloud_static.ply``, ``blce.pth``,
``deformation.pth`` / ``_table`` / ``_accum`` and ``train_state.npz``;
and the debug grids ``fine_debug/iter_*.png``. The JAX package loads every
one of them. With ``--trace_spans`` it also writes ``spans.json``: the
loop's spans (per path: count, total and self host seconds) and the tile
binning's counters over the run (``utils/observability.py::report``).

With ``-s`` it sniffs the scene's kind as the JAX CLI does. A directory
with ``poses_bounds.npy`` is read as a DyBluRF stereo scene
(``data/stereo.py``) and seeded by the warm stage (``train/warm.py``) on the
same device; every other kind goes through ``data/scene.py::load_scene``
(Blender, dycheck iPhone or HyperNeRF, COLMAP, PanopticSports) and is
seeded from its SfM cloud or from its depth priors, 10 % of the seeds
(at most ``dyn_npts``) in the dynamic pool.

Where it differs from the JAX CLI: the random draws come from CPU
``torch.Generator``s seeded with seed, seed+1, seed+2 and seed+3 (the
JAX CLI's ``PRNGKey``s), so the same seed gives other initial weights
than the JAX CLI's, and the same on the card as on the CPU;
and ``blce.pth`` is always written (the JAX CLI's ``blce.npz`` fallback
serves environments without torch).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os

import numpy as np
import torch

from mobgs_tpu_torch import resolve_device
from mobgs_tpu_torch.utils import observability as obs


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="mobgs_tpu_torch training")
    p.add_argument("-s", "--source_path", type=str, default="")
    p.add_argument("-m", "--model_path", type=str, default="")
    p.add_argument("--expname", type=str, default="default")
    p.add_argument("--configs", type=str, default="")
    p.add_argument("--iterations", type=int, default=None)
    p.add_argument("--test_iterations", type=int, default=500,
                   help="evaluate every N iterations")
    p.add_argument("--save_iterations", type=int, nargs="+", default=None)
    p.add_argument("--seed", type=int, default=6666)
    p.add_argument("--synthetic", action="store_true",
                   help="train on a generated synthetic scene")
    p.add_argument("--synthetic_size", type=str, default="128x72x12",
                   help="WxHxFrames for --synthetic")
    p.add_argument("--num_warp", type=int, default=None,
                   help="override latent exposure count (default 9)")
    p.add_argument("--start_checkpoint", type=str, default="",
                   help="resume from a full-state .npz checkpoint")
    p.add_argument("--port", type=int, default=0,
                   help="SIBR viewer bridge port (0 = disabled)")
    p.add_argument("--check_seed", action="store_true",
                   help="seed-sweep mode: truncate at 5000 iters and append "
                        "best PSNR to seed.txt (reference train.py:290,1008)")
    p.add_argument("--quiet", action="store_true")
    p.add_argument("--densify_mode", type=int, default=2, choices=(1, 2, 3),
                   help="controlgaussians dispatch (helper_train.py:183-289);"
                        " the reference hardcodes 2 (train.py:208)")
    p.add_argument("--eval_tto", action="store_true",
                   help="run 5 TTO steps in the in-training eval (the "
                        "reference renders aligned test cams with no TTO)")
    p.add_argument("--trace_spans", action="store_true",
                   help="record the loop's spans and the binning's counters "
                        "(utils/observability.py) and write them to "
                        "spans.json beside history.json")
    return p


def main(argv=None, device=None):
    """Run the CLI with ``argv`` (``sys.argv[1:]`` when None) on ``device``
    (the card unless ``"cpu"``). Returns (final TrainState, history)."""
    args = _parser().parse_args(argv)
    dev = resolve_device(device)

    from mobgs_tpu_torch.config import Config, load_scene_config
    cfg = Config()
    if args.configs:
        cfg = load_scene_config(args.configs)
    if args.iterations is not None:
        cfg = dataclasses.replace(
            cfg, opt=dataclasses.replace(cfg.opt, iterations=args.iterations))
    if args.num_warp is not None:
        cfg = dataclasses.replace(
            cfg, blce=dataclasses.replace(cfg.blce, num_warp=args.num_warp))

    from mobgs_tpu_torch.data import synthetic
    from mobgs_tpu_torch.models import blce as B
    from mobgs_tpu_torch.models import gaussians as G
    from mobgs_tpu_torch.models import hexplane as HP
    from mobgs_tpu_torch.models.deformation import init_deformation
    from mobgs_tpu_torch.models.sandwich import init_sandwich
    from mobgs_tpu_torch.ops.rasterize import RasterConfig
    from mobgs_tpu_torch.train import loop as L
    from mobgs_tpu_torch.train.step import init_train_state

    np.random.seed(args.seed % (2**32))

    def generator(seed):
        # on the CPU, so that a seed gives the same initial weights on the
        # card as on the CPU
        return torch.Generator().manual_seed(seed)

    def on(x, dtype=torch.float32):
        return torch.as_tensor(np.asarray(x), dtype=dtype).to(dev)

    raster_cfg = RasterConfig(tiles_per_gauss=cfg.tpu.tiles_per_gauss,
                              max_per_tile=cfg.tpu.max_per_tile,
                              tile_chunk=cfg.tpu.tile_chunk)
    # the configured budgets before the init-time escalation: the loop
    # de-escalates back toward them once training shrinks the oversized
    # seed splats that forced it
    base_raster_cfg = raster_cfg

    # ---- data
    if args.synthetic:
        W, H, F = map(int, args.synthetic_size.split("x"))
        data, traj = synthetic.generate(width=W, height=H, num_frames=F, device=dev)
        # seed counts scaled to the scene's area (the reference's counts
        # assume 512x288)
        area_scale = (W * H) / (512 * 288)
        s_pts, s_cols, d_traj = synthetic.init_point_clouds(
            data, traj, max(200, int(cfg.opt.stat_npts * area_scale)),
            max(60, int(cfg.opt.dyn_npts * area_scale)))
        s_times = np.zeros(len(s_pts), np.float32)
        d_times = np.zeros(len(d_traj), np.float32)
        d_cols = np.full((len(d_traj), 3), 0.5, np.float32)
        traj_times = data.time
    else:
        from mobgs_tpu_torch.data.stereo import sniff_dataset_type
        from mobgs_tpu_torch.train import warm
        kind = sniff_dataset_type(args.source_path)
        if kind in ("nvidia", "stereo"):
            # DyBluRF stereo: the warm-stage geometric init (tracklets)
            from mobgs_tpu_torch.data.stereo import load_stereo_scene
            scene = load_stereo_scene(args.source_path)
            data = scene.data
            print(f"loaded {data.w2c.shape[0]} frames "
                  f"@ {data.width}x{data.height}")
            pc = warm.warm_init(data.images, data.depths, data.w2c, data.K,
                                data.time,
                                (data.masks > 0.5).astype(np.float32),
                                scene.tracklet, cfg.opt.stat_npts,
                                cfg.opt.dyn_npts, seed=args.seed, device=dev)
            s_pts, s_cols = pc.stat_points, pc.stat_colors
            s_times = pc.stat_times
            d_traj = pc.dyn_trajectory
            d_cols, d_times = pc.dyn_colors, pc.dyn_times
            traj_times = data.time
        else:
            # registry families (blender/colmap/dycheck/dynerf/panoptic):
            # seed from the SfM cloud when present, else unproject the depth
            # priors
            from mobgs_tpu_torch.data.scene import load_scene
            data = load_scene(args.source_path, kind=kind)
            print(f"loaded [{kind}] {data.w2c.shape[0]} views "
                  f"@ {data.width}x{data.height}")
            rng_np = np.random.default_rng(args.seed)
            if data.points_xyz is not None:
                pts, cols = data.points_xyz, data.points_rgb
            else:
                pts, cols = warm.seed_from_depths(
                    data, cfg.opt.stat_npts + cfg.opt.dyn_npts, rng_np, device=dev)
            n_dyn = min(cfg.opt.dyn_npts, max(1, len(pts) // 10))
            sel = rng_np.permutation(len(pts))
            s_sel, d_sel = sel[n_dyn:], sel[:n_dyn]
            s_pts, s_cols = pts[s_sel], cols[s_sel]
            s_times = np.zeros(len(s_pts), np.float32)
            # dynamic seeds start static (a constant trajectory); motion is
            # learned through the spline controls
            traj_times = np.unique(data.time)
            d_traj = np.repeat(pts[d_sel][:, None], len(traj_times),
                               axis=1).astype(np.float32)
            d_cols = cols[d_sel].astype(np.float32)
            d_times = np.zeros(len(d_sel), np.float32)

    # ---- states
    # the initial capacity is a multiple of the seed count; the loop grows
    # the pools on densify pressure
    cap_mult = cfg.tpu.capacity_mult
    cap_s = int(len(s_pts) * cap_mult)
    cap_d = int(len(d_traj) * cap_mult)
    stat = G.create_state(s_pts, s_cols, s_times, cap_s,
                          generator=generator(args.seed), device=dev)
    dyn = G.create_state(d_traj[:, 0], d_cols, d_times, cap_d,
                         trajectory=torch.as_tensor(d_traj),
                         traj_times=torch.as_tensor(traj_times), device=dev)
    sandwich = init_sandwich(generator(args.seed + 1), device=dev)
    blce_state = B.init_blce(generator(args.seed + 2), num_views=data.w2c.shape[0],
                             view_dim=cfg.blce.view_dim,
                             num_warp=cfg.blce.num_warp, device=dev)
    # the deformation net, carried for the checkpoints (reference
    # train.py:842-844: instantiated, its AABB set from the static cloud,
    # saved as deformation.pth; the fine stage never renders through it)
    deform = init_deformation(generator(args.seed + 3), cfg.hidden, device=dev)
    deform = deform._replace(grid=HP.set_aabb(deform.grid, s_pts.max(0), s_pts.min(0)))
    ts = init_train_state(stat, dyn, sandwich, blce_state, deform=deform)
    start_iter = 1
    if args.start_checkpoint:
        from mobgs_tpu_torch.io.checkpoint import load_train_state, peek_shape
        from mobgs_tpu_torch.train.densify import grow_train_state
        # a checkpoint written after pool growth has larger pools than the
        # fresh template: grow the template to match
        ck_s = peek_shape(args.start_checkpoint, "stat/xyz") or (ts.stat.capacity,)
        ck_d = peek_shape(args.start_checkpoint, "dyn/xyz") or (ts.dyn.capacity,)
        if ck_s[0] > ts.stat.capacity or ck_d[0] > ts.dyn.capacity:
            ts = grow_train_state(ts, ck_s[0], ck_d[0])
        ts = load_train_state(args.start_checkpoint, ts)
        start_iter = int(ts.step) + 1
        print(f"resumed from {args.start_checkpoint} @ step {int(ts.step)}"
              f" — continuing at iteration {start_iter}")
    extent = getattr(data, "extent", 0.0)  # loader-pinned
    if extent <= 0.0:
        extent = L.scene_extent_from_cameras(data.w2c)
    if extent < 1e-6:  # degenerate (static camera rig)
        extent = L.scene_extent_of(np.asarray(s_pts))

    # escalate the tile-bbox budget when the initial scales project past it,
    # and validate the per-tile capacity by a measured composite on the
    # first camera (the loop's tile_max check covers drift in training)
    from mobgs_tpu_torch.models import render as _render
    from mobgs_tpu_torch.ops import projection as _prj
    from mobgs_tpu_torch.ops import tiles as _tiles
    from mobgs_tpu_torch.ops.rasterize import validate_max_per_tile
    with torch.no_grad():
        w2c0, K0, t0 = on(data.w2c[0]), on(data.K[0]), on(data.time[0])
        _g = _render.assemble(ts.stat, ts.dyn, t0, data.max_time)
        _sp = _prj.project(_g.means, _g.quats, _g.scales, w2c0, K0, data.width,
                           data.height, eps2d=raster_cfg.eps2d,
                           near=raster_cfg.near, sigma_cut=raster_cfg.sigma_cut)
        print(f"init: {len(s_pts)} static + {len(d_traj)} dynamic seeds; "
              f"validating raster budgets...", flush=True)
        _suggest = _tiles.suggest_tiles_per_gauss(_sp.radii)
        if _suggest > raster_cfg.tiles_per_gauss:
            print(f"[warn] initial splats span past the {raster_cfg.tiles_per_gauss}"
                  f"-tile bbox budget; escalating tiles_per_gauss -> {_suggest}")
            raster_cfg = raster_cfg._replace(tiles_per_gauss=_suggest)
        _k = validate_max_per_tile(_g.means, _g.quats, _g.scales, _g.opacity,
                                   _g.colors, w2c0, K0, data.width, data.height,
                                   raster_cfg)
    if _k > raster_cfg.max_per_tile:
        print(f"[warn] per-tile truncation at max_per_tile="
              f"{raster_cfg.max_per_tile} is not transmittance-saturated "
              f"on this scene; escalating -> {_k}")
        raster_cfg = raster_cfg._replace(max_per_tile=_k)
    print(f"init: raster budgets validated (tiles_per_gauss="
          f"{raster_cfg.tiles_per_gauss}, max_per_tile="
          f"{raster_cfg.max_per_tile}); training...", flush=True)

    out_dir = args.model_path or os.path.join("output", args.expname)
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "cfg_args.json"), "w") as f:
        json.dump({"expname": args.expname, "source_path": args.source_path,
                   "iterations": cfg.opt.iterations,
                   "synthetic": args.synthetic}, f)

    best = {"psnr": -1.0, "iter": 0}
    hist_path = os.path.join(out_dir, "history.json")
    partial_path = os.path.join(out_dir, "history_partial.json")
    eval_curve_path = os.path.join(out_dir, "eval_curve.json")
    # a resumed run: read the pre-resume curve now, before the first periodic
    # checkpoint overwrites history_partial.json with the post-resume entries
    prior_hist: dict = {}
    prior_eval: list = []
    if start_iter > 1:
        for cand in (hist_path, partial_path):
            if os.path.exists(cand):
                with open(cand) as f:
                    for h in json.load(f):
                        if h["iter"] < start_iter:
                            prior_hist[h["iter"]] = h
        if os.path.exists(eval_curve_path):
            with open(eval_curve_path) as f:
                prior_eval = [e for e in json.load(f) if e["iter"] < start_iter]
    eval_curve: list = list(prior_eval)

    def on_log(m):
        if not args.quiet:
            print(f"[{m['iter']:6d}] loss {m['loss']:.4f} photo {m['photo']:.4f} "
                  f"psnr {m['psnr']:.2f} pts ({m['n_stat']},{m['n_dyn']}) "
                  f"({m['elapsed']:.0f}s)")

    test_K = on(data.test_K if data.test_K is not None else data.K)
    test_t = on(data.test_time if data.test_time is not None else data.time)
    test_images = on(data.test_images)
    test_w2c = on(data.test_w2c)

    def on_eval(ts_now, it):
        from mobgs_tpu_torch.eval.align import align_test_poses
        from mobgs_tpu_torch.eval.tto import make_tto
        # test poses re-expressed through the BLCE-refined train poses
        # (reference train.py:746-764)
        aligned = align_test_poses(ts_now.blce, on(data.w2c), test_w2c,
                                   on(data.blur_feats), num_warp=cfg.blce.num_warp)
        # the reference's in-training eval renders the aligned test cameras
        # (train.py:746-766); steps=0 makes TTO a render, --eval_tto runs 5
        # refinement steps. raster_cfg is the init-validated one, as the JAX
        # CLI passes it, not the budgets the loop escalated to since
        tto = make_tto(ts_now.stat, ts_now.dyn, ts_now.sandwich,
                       data.width, data.height, data.max_time,
                       steps=5 if args.eval_tto else 0, raster_cfg=raster_cfg)
        V = test_w2c.shape[0]
        ones = torch.ones(V, device=dev)
        psnr = float(tto(aligned, test_K, test_t, test_images, ones).psnr.mean())
        # the raw-pose control separates BLCE alignment drift from scene
        # quality
        psnr_raw = float(tto(test_w2c, test_K, test_t, test_images, ones).psnr.mean())
        print(f"[eval @ {it}] test PSNR {psnr:.2f} (raw-pose {psnr_raw:.2f})",
              flush=True)
        eval_curve.append({"iter": it, "test_psnr": psnr, "test_psnr_raw": psnr_raw})
        with open(eval_curve_path, "w") as f:
            json.dump(eval_curve, f)
        if psnr > best["psnr"]:
            best.update(psnr=psnr, iter=it)
            save_checkpoint(ts_now, out_dir, "best")

    def save_checkpoint(ts_now, root, tag):
        from mobgs_tpu_torch.io import torch_ckpt as TC
        from mobgs_tpu_torch.io.checkpoint import save_train_state
        from mobgs_tpu_torch.io.ply import save_gaussians
        d = os.path.join(root, "point_cloud", f"iteration_{tag}")
        os.makedirs(d, exist_ok=True)
        save_gaussians(os.path.join(d, "point_cloud.ply"), ts_now.dyn, ts_now.sandwich)
        save_gaussians(os.path.join(d, "point_cloud_static.ply"), ts_now.stat)
        # the reference's artifact set (scene/__init__.py:116-138), so the
        # upstream eval.py loads this directory
        TC.save_blce_pth(d, ts_now.blce)
        if ts_now.deform is not None:
            TC.save_deformation_pth(d, ts_now.deform, cfg.hidden,
                                    int(ts_now.dyn.num_live()))
        save_train_state(os.path.join(d, "train_state.npz"), ts_now)

    def on_debug(ts_now, it):
        if cfg.model.debug_process:
            from mobgs_tpu_torch.train.debug_vis import dump_debug_images
            dump_debug_images(ts_now, data, it, out_dir, raster_cfg=raster_cfg)
        # render_process per-view panels (scene_utils.py:14-269): latent
        # sharp frames and flow colour maps of one train view
        if cfg.model.render_process:
            from mobgs_tpu_torch.train.debug_vis import render_training_panels
            render_training_panels(
                ts_now, data, it, out_dir, view=int(it // 300 % data.w2c.shape[0]),
                num_warp=cfg.blce.num_warp, with_latents=it > cfg.blce.start_warp,
                raster_cfg=raster_cfg)

    def periodic_checkpoint(ts_now, it, hist):
        """Bounded-loss restart: the full state and the history so far."""
        from mobgs_tpu_torch.io.checkpoint import save_train_state
        save_train_state(os.path.join(out_dir, "train_state_latest.npz"), ts_now)
        merged = {**prior_hist, **{h["iter"]: h for h in hist}}
        with open(partial_path, "w") as f:
            json.dump([merged[k] for k in sorted(merged)], f)

    viewer = viewer_render = None
    if args.port:
        from mobgs_tpu_torch.viewer import ViewerServer, make_viewer_render
        viewer = ViewerServer(port=args.port)

        def viewer_render(ts_now, msg):
            return make_viewer_render(ts_now.stat, ts_now.dyn, ts_now.sandwich,
                                      data.K[0], data.width, data.height,
                                      data.max_time, config=raster_cfg)(msg)

    n_iters = min(cfg.opt.iterations, 5000) if args.check_seed else cfg.opt.iterations
    if args.trace_spans:
        obs.reset()
        obs.tracing(spans=True, counters=True)
    try:
        ts, history = L.train(
            ts, data, cfg.opt, cfg.blce, iterations=n_iters,
            raster_cfg=raster_cfg, scene_extent=extent, seed=args.seed,
            log_every=50, on_log=on_log,
            eval_every=args.test_iterations, on_eval=on_eval,
            debug_every=300, on_debug=on_debug,
            viewer=viewer, viewer_render=viewer_render,
            densify_mode=args.densify_mode, start_iter=start_iter,
            base_raster_cfg=base_raster_cfg, checkpoint_every=500,
            on_checkpoint=periodic_checkpoint, device=dev)
    finally:
        if args.trace_spans:
            obs.tracing(False)
        if viewer is not None:
            viewer.close()
    if args.check_seed:
        with open("seed.txt", "a") as f:
            f.write(f"seed {args.seed}: best_psnr {best['psnr']:.4f} @ {best['iter']}\n")

    save_checkpoint(ts, out_dir, str(cfg.opt.iterations))
    if prior_hist:
        # a resumed run: splice onto the pre-resume curve read at startup
        history = [prior_hist[k] for k in sorted(prior_hist)] + history
    with open(hist_path, "w") as f:
        json.dump(history, f)
    if args.trace_spans:
        with open(os.path.join(out_dir, "spans.json"), "w") as f:
            json.dump(obs.report(), f, indent=1)
    print(f"done. best test PSNR {best['psnr']:.2f} @ iter {best['iter']}; "
          f"checkpoints in {out_dir}")
    return ts, history


if __name__ == "__main__":
    main()
