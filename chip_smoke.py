#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (``mobgs_tpu_torch``).

Drives the port's serving path and its flow-off training step on one CUDA
card at the seesaw protocol's full width (512x288, 24 frames, 20k static +
10k dynamic seeds at x2 capacity = 40k + 20k slots, tiles_per_gauss=9,
max_per_tile=256; training at B=2 views and E=9 latent exposures), with a
scene made from a seed and random Sandwich and BLCE weights:

1. the card's name and power limit, torch and CUDA versions;
2. build the forward and backward compositor kernels from
   ``mobgs_tpu_torch/csrc`` (one nvcc each, started together) and print
   ``-Xptxas -v``'s registers, shared memory and spills; for each backward
   instance the main path and phase 7 launch, the registers, shared memory,
   spills and resident blocks per SM that the CUDA occupancy API gives, and
   the waves that 576 tiles take (an instance that spills fails the run);
3. build the scene on the card (the generator's ground-truth renders
   already run through the kernel);
4. hold the forward kernel against its plain PyTorch version on one
   protocol view: (a) default render, CE=11, with background; (b) the fused
   sub chain with the dynamic mask as alpha mask; (c) alpha-only, CE=2;
   (d) image-only, CE=9; (e) the decoded ``render_view`` image;
5. serve 8 SIBR viewer requests through ``ViewerServer`` and
   ``make_viewer_render``; each reply must equal a direct render;
6. render 10 frames (bench.py's render loop) and 10 more with the
   dynamic alpha fused in, report frames/s, and read the forward kernel's
   launch counts of phases 5-6 (the serving path); trace a render;
7. hold the backward kernel against its plain version on the protocol
   view: (a) CE=9 image-only (latent render), (b) CE=11 with the sub chain
   (mid render), (c) CE=2 alpha-only, (d) CE=29 with the sub chain (the
   flow-on mid render's width: 9 + 2·9 flow columns + depth + weight),
   upstream gradients from a seeded numpy generator;
8. one train step's loss and gradients through the kernels against the
   plain route (``RasterConfig(backend="plain")``), same state and batch;
9. train: 3 warm-up and 20 timed flow-off steps through
   ``make_train_step`` with ``BatchSampler(24, 2, seed=0)``; report it/s,
   loss and PSNR per step, read the launch counts of the timed steps (the
   training path: 16 + 2 forward and 16 + 2 backward launches per step),
   check the parameters moved, and trace one step;
10. time every kernel with CUDA events at protocol shape beside its plain
    version and its bound, print the ``{"kernels": [...]}`` line, then the
    ``{"ok": true, ...}`` line last.

Every failure raises and exits non-zero. Without a CUDA card it exits 2
and prints no result. Run: ``python3 chip_smoke.py``.
"""

import json
import socket
import struct
import subprocess
import sys
import threading
import time

import numpy as np
import torch

W, H, FRAMES = 512, 288, 24
N_STAT, N_DYN, CAP_MULT = 20_000, 10_000, 2
N_REQUESTS = 8
N_FRAMES = 10
# Kernel vs plain: the sums run in another order (serial per-pixel walk vs
# cumprod and batched matmul) and nvcc contracts multiply-adds into FMAs,
# so the two differ in the last bits of each product and sum.
IMG_ATOL = 1e-4
DEPTH_RTOL = 1e-3   # where alpha > 1e-3
# Backward kernel vs plain, per gradient column, max|k - p| / max|p|: the
# kernel's per-pixel running sums, warp reductions and atomics (whose order
# changes from run to run) add in other orders than cumsum and index_add_,
# and the suffix-anchor subtraction amplifies that by up to 1/(1 - alpha)
# <= 100. Measured on an H100: at most 1.2e-6 at the protocol view.
BWD_REL = 1e-4
# A train step through the kernels vs the plain route, per gradient leaf,
# max|k - p| / max|p|: the compositor's differences above, carried back
# through projection and the Sandwich decoder; BLCE's 1/|w| axis
# normalisation multiplies them in the pose gradients. Measured: at most
# 6e-7, and the loss equal.
STEP_REL = {"stat": 1e-4, "dyn": 1e-4, "sandwich": 1e-4, "blce": 1e-3,
            "offsets": 1e-4}
LOSS_RTOL = 1e-5
N_WARM, N_STEPS, B_VIEWS, E_WARP = 3, 20, 2, 9
# Published H100 SXM peaks (NVIDIA data sheet, at 700 W): float32 outside
# the tensor cores, and HBM3 bandwidth.
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12
SOURCES = {"raster_fwd": "mobgs_tpu_torch/csrc/raster_fwd.cu",
           "raster_bwd": "mobgs_tpu_torch/csrc/raster_bwd.cu"}
# the backward instances (CE, sub chain) launched at protocol shape: latent
# render, mid render, alpha-only, flow-on mid render
BWD_INSTANCES = ((9, False), (11, True), (2, False), (29, True))
PROTOCOL_TILES = 576
REPLACES = {"raster_fwd": "mobgs_tpu/ops/pallas_raster.py:118",
            "raster_fwd_sub": "mobgs_tpu/ops/pallas_raster.py:151",
            "raster_bwd": "mobgs_tpu/ops/pallas_raster.py:203",
            "raster_bwd_sub": "mobgs_tpu/ops/pallas_raster.py:285"}


def require(ok, what):
    if not ok:
        raise RuntimeError(f"chip_smoke: {what}")


def phase(name):
    print(f"== {name}", flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def sibr_message(w2c, width, height):
    """A SIBR camera message for a world→camera matrix: the inverse of the
    viewer's flip (``viewer.py:70-74``)."""
    view = np.array(w2c, np.float32).T.copy()
    view[:, 1] *= -1
    view[:, 2] *= -1
    body = json.dumps({"resolution_x": width, "resolution_y": height,
                       "train": True, "keep_alive": False,
                       "view_matrix": view.reshape(-1).tolist()}).encode()
    return struct.pack("<I", len(body)) + body


def recv_exact(sock, n):
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        require(chunk, "viewer closed the connection")
        buf += chunk
    return buf


def cuda_ms(fn, iters):
    """Mean device time of ``fn`` over ``iters`` calls, CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def protocol_scene(dev):
    """The seesaw-scale synthetic scene at the protocol shape, made from
    seeds: (raster config, generator data, the point clouds the states are
    seeded from, static state, dynamic state)."""
    from mobgs_tpu_torch.data import synthetic
    from mobgs_tpu_torch.models import gaussians as G
    from mobgs_tpu_torch.ops.rasterize import RasterConfig

    cfg = RasterConfig(tiles_per_gauss=9, max_per_tile=256, tile_chunk=36)
    data, traj = synthetic.generate(width=W, height=H, num_frames=FRAMES,
                                    n_static=2000, n_dyn=400, blur_substeps=3,
                                    raster_cfg=cfg, device=dev)
    s_pts, s_cols, d_traj = synthetic.init_point_clouds(data, traj, N_STAT, N_DYN)
    gen = torch.Generator(device=dev).manual_seed(0)
    stat = G.create_state(s_pts, s_cols, np.zeros(len(s_pts), np.float32),
                          capacity=len(s_pts) * CAP_MULT, generator=gen,
                          device=dev)
    dyn = G.create_state(d_traj[:, 0], np.full((len(d_traj), 3), 0.5, np.float32),
                         np.zeros(len(d_traj), np.float32),
                         capacity=len(d_traj) * CAP_MULT,
                         trajectory=torch.as_tensor(d_traj),
                         traj_times=torch.as_tensor(data.time), device=dev)
    return cfg, data, (s_pts, s_cols, d_traj), stat, dyn


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    from mobgs_tpu_torch.data.cameras import Camera
    from mobgs_tpu_torch.models import gaussians as G
    from mobgs_tpu_torch.models import render as R
    from mobgs_tpu_torch.models.sandwich import init_sandwich
    from mobgs_tpu_torch.ops import cuda_raster, tiles
    from mobgs_tpu_torch.viewer import ViewerServer, make_viewer_render

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    times = {}

    phase("1 card")
    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")

    phase("2 build")
    t0 = time.time()
    built = cuda_raster.build_kernels()
    for name in built:
        cuda_raster._library(name)
    times["build_s"] = time.time() - t0
    print(f"built {', '.join(so.name for so, _ in built.values())} in "
          f"{times['build_s']:.1f} s")
    for name, (_, log) in built.items():
        for line in log.splitlines():
            if any(k in line for k in ("Compiling entry", "registers", "spill")):
                print(f"  ptxas {name}:", line.split("info    :")[-1].strip())
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    for ce, sub in BWD_INSTANCES:
        occ = cuda_raster.bwd_occupancy(ce, 256, sub, dev)
        waves = -(-PROTOCOL_TILES // max(occ["blocks_per_sm"] * n_sm, 1))
        print(f"  raster_bwd CE={ce} sub={sub}: {occ['registers']} registers, "
              f"{occ['smem_bytes']} B shared, {occ['local_bytes']} B local, "
              f"{occ['blocks_per_sm']} blocks/SM on {n_sm} SMs, "
              f"{waves} wave(s) at {PROTOCOL_TILES} tiles")
        require(occ["blocks_per_sm"] > 0, f"raster_bwd CE={ce} sub={sub} cannot launch")
        require(occ["local_bytes"] == 0, f"raster_bwd CE={ce} sub={sub} spills")

    phase("3 scene")
    t0 = time.time()
    cfg, data, (s_pts, s_cols, d_traj), stat, dyn = protocol_scene(dev)
    require(np.isfinite(data.images).all() and data.images.shape == (FRAMES, H, W, 3),
            "generator images")
    require(0.0 < data.masks.mean() < 0.5, f"dynamic mask share {data.masks.mean()}")
    sandwich = init_sandwich(torch.Generator(device=dev).manual_seed(1), device=dev)
    for m in (stat, dyn, sandwich):
        m.requires_grad_(False)
    torch.cuda.synchronize()
    times["scene_s"] = time.time() - t0
    print(f"slots {stat.capacity} static + {dyn.capacity} dynamic, "
          f"{times['scene_s']:.1f} s")

    def cam(i):
        return Camera(w2c=torch.as_tensor(data.w2c[i], device=dev),
                      K=torch.as_tensor(data.K[i], device=dev),
                      time=torch.tensor(float(data.time[i]), device=dev))

    phase("4 kernel vs plain")
    geom, splats = R.assemble_project(stat, dyn, cam(0), W, H, data.max_time,
                                      config=cfg)
    bins = tiles.bin_gaussians(splats, W, H, tiles_per_gauss=cfg.tiles_per_gauss,
                               max_per_tile=cfg.max_per_tile)
    N = geom.means.shape[0]
    bg9 = torch.tensor([0.1, 0.2, 0.3] * 3, device=dev)
    cases = {
        "a_default_ce11": dict(colors=geom.colors, background=bg9),
        "b_fused_sub": dict(colors=geom.colors, background=bg9,
                            sub_opacities=geom.opacity * geom.dyn_mask),
        "c_alpha_only_ce2": dict(colors=torch.zeros(N, 0, device=dev)),
        "d_image_only_ce9": dict(colors=geom.colors, want_depth=False,
                                 want_alpha=False),
    }
    errs = {}
    for name, kw in cases.items():
        kw = dict(kw)
        cols = kw.pop("colors")
        k = cuda_raster.composite_tiles(bins, splats, cols, geom.opacity, W, H,
                                        backend="cuda", **kw)
        p = cuda_raster.composite_tiles(bins, splats, cols, geom.opacity, W, H,
                                        backend="plain", **kw)
        torch.cuda.synchronize()
        e = {"image": float((k[0] - p[0]).abs().max()) if cols.shape[1] else 0.0,
             "alpha": float((k[1] - p[1]).abs().max()),
             "alpha_px_over": int(((k[1] - p[1]).abs() > IMG_ATOL).sum())}
        if kw.get("want_depth", True):
            m = p[1] > 1e-3
            rel = ((k[2] - p[2]).abs() / p[2].abs().clamp(min=1e-6))[m]
            e["depth_rel"] = float(rel.max()) if rel.numel() else 0.0
            require(e["depth_rel"] <= DEPTH_RTOL, f"{name} depth {e}")
        if len(k) == 4:
            e["sub_alpha"] = float((k[3] - p[3]).abs().max())
        for key in ("image", "alpha", "sub_alpha"):
            require(e.get(key, 0.0) <= IMG_ATOL, f"{name} {key} {e}")
        require(all(torch.isfinite(x).all() for x in k), f"{name} not finite")
        errs[name] = e
        print(f"{name}: max abs diff {json.dumps(e)}")
    require(float(bins.counts.float().mean()) > 1.0, "tiles are empty")
    e2e_k = R.render_view(stat, dyn, sandwich, cam(0), W, H, torch.zeros(3, device=dev),
                          data.max_time, config=cfg)
    e2e_p = R.render_view(stat, dyn, sandwich, cam(0), W, H, torch.zeros(3, device=dev),
                          data.max_time, config=cfg._replace(backend="plain"))
    e2e = float((e2e_k.image - e2e_p.image).abs().max())
    require(e2e <= IMG_ATOL, f"render_view decoded image diff {e2e}")
    require(e2e_k.image.shape == (H, W, 3) and bool(torch.isfinite(e2e_k.image).all())
            and 0.0 <= float(e2e_k.image.min()) and float(e2e_k.image.max()) <= 1.0,
            "decoded image shape or range")
    print(f"e_render_view_decoded: max abs diff {e2e}, "
          f"mean alpha {float(e2e_k.alpha.mean()):.4f}, "
          f"tile_max {int(e2e_k.tile_max)}")

    # ---- the main path: serve, then render; counts read after ----
    for key in cuda_raster.launches:
        cuda_raster.launches[key] = 0

    phase("5 serve")
    server = ViewerServer(host="127.0.0.1", port=0)
    render_fn = make_viewer_render(stat, dyn, sandwich, data.K[0], W, H,
                                   data.max_time, config=cfg)
    replies, failures = [], []

    def client():
        try:
            with socket.create_connection(("127.0.0.1", server.port),
                                          timeout=120) as s:
                for i in range(N_REQUESTS):
                    s.sendall(sibr_message(data.w2c[i], W, H))
                    img = recv_exact(s, W * H * 3)
                    n = struct.unpack("<I", recv_exact(s, 4))[0]
                    replies.append((img, recv_exact(s, n).decode("ascii")))
        except OSError as exc:  # reported by the main thread below
            failures.append(repr(exc))

    t0 = time.time()
    th = threading.Thread(target=client, daemon=True)
    th.start()
    deadline = time.time() + 300
    while len(replies) < N_REQUESTS and th.is_alive() and time.time() < deadline:
        server.poll(render_fn, verify="seesaw-synthetic")
    th.join(timeout=30)
    server.close()
    times["serve_s"] = time.time() - t0
    require(not failures and len(replies) == N_REQUESTS,
            f"viewer answered {len(replies)}/{N_REQUESTS}: {failures}")
    for i, (img, verify) in enumerate(replies):
        require(verify == "seesaw-synthetic" and len(img) == H * W * 3,
                f"reply {i}: {len(img)} bytes, verify {verify!r}")
        with torch.no_grad():
            direct = R.render_view(
                stat, dyn, sandwich,
                Camera(w2c=torch.as_tensor(data.w2c[i], device=dev),
                       K=torch.as_tensor(data.K[0], device=dev),
                       time=torch.tensor(0.5, device=dev)),
                W, H, torch.zeros(3, device=dev), data.max_time, config=cfg)
        want = (np.clip(direct.image.cpu().numpy(), 0, 1) * 255).astype(np.uint8)
        require(img == want.tobytes(), f"reply {i} differs from a direct render")
    print(f"served {len(replies)} requests at {W}x{H}, all equal to direct "
          f"renders ({times['serve_s']:.2f} s)")

    phase("6 render frames")
    bg = torch.zeros(3, device=dev)
    cams = [cam(i) for i in range(N_FRAMES)]
    rates = {}
    for label, flags in (("render_fps", {}),
                         ("render_fps_dyn_alpha",
                          dict(get_dynamic=True, subset_alpha_only=True))):
        with torch.no_grad():
            R.render_view(stat, dyn, sandwich, cams[0], W, H, bg, data.max_time,
                          config=cfg, **flags)
            torch.cuda.synchronize()
            t0 = time.time()
            outs = [R.render_view(stat, dyn, sandwich, c, W, H, bg,
                                  data.max_time, config=cfg, **flags)
                    for c in cams]
            torch.cuda.synchronize()
            rates[label] = N_FRAMES / (time.time() - t0)
        imgs = torch.stack([o.image for o in outs])
        require(bool(torch.isfinite(imgs).all()) and imgs.shape == (N_FRAMES, H, W, 3),
                f"{label} images")
        if flags:
            d = torch.stack([o.d_alpha for o in outs])
            require(float(d.max()) > 0.5 and bool((d <= 1.0).all()), "dynamic alpha")
        print(f"{label}: {rates[label]:.2f} frames/s")
    serve_launches = dict(cuda_raster.launches)
    print(f"serving-path launches: {json.dumps(serve_launches)}")
    for key in ("raster_fwd", "raster_fwd_sub"):
        require(serve_launches[key] > 0,
                f"kernel {key} was not launched on the serving path")

    # where a default render's time goes: device kernels by name, and the
    # device's busy share of the wall time (the profiler's own host cost
    # inflates the wall time, so the idle share is an upper bound)
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    n_traced = 5
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU,
                                              ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.time()
        for c in cams[:n_traced]:
            R.render_view(stat, dyn, sandwich, c, W, H, bg, data.max_time, config=cfg)
        torch.cuda.synchronize()
        wall_us = (time.time() - t0) * 1e6 / n_traced
    by_name = {}
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            by_name[ev.name] = by_name.get(ev.name, 0.0) \
                + ev.time_range.elapsed_us() / n_traced
    busy_us = sum(by_name.values())
    if busy_us:
        print(f"trace: {wall_us:.0f} us wall per render_view, {busy_us:.0f} us "
              f"device busy ({100 * busy_us / wall_us:.1f} %), "
              f"{len(by_name)} kernel names")
        for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]:
            print(f"  {us:8.1f} us  {name[:90]}")
    else:
        print("trace: the profiler recorded no device time (not measured)")

    # ---- the training slice ----
    from mobgs_tpu_torch.config import OptimizationParams
    from mobgs_tpu_torch.models import blce as B
    from mobgs_tpu_torch.train import loop as L
    from mobgs_tpu_torch.train import step as S

    phase("7 backward kernel vs plain")
    T_tiles = bins.gauss_ids.shape[0]
    ids, cnt, ntx = bins.gauss_ids.contiguous(), bins.counts.contiguous(), bins.n_tiles_x
    ones = torch.ones(N, 1, device=dev)
    sub_op = geom.opacity * geom.dyn_mask
    rng = np.random.default_rng(7)
    bwd_cases = {
        "a_latent_ce9": (geom.colors, False),
        "b_mid_ce11_sub": (torch.cat([geom.colors, splats.depths[:, None], ones], 1), True),
        "c_alpha_only_ce2": (torch.cat([splats.depths[:, None], ones], 1), False),
        "d_flow_mid_ce29_sub": (torch.cat([
            geom.colors,
            torch.as_tensor(rng.normal(size=(N, 2 * E_WARP)).astype(np.float32), device=dev),
            splats.depths[:, None], ones], 1), True),
    }
    bwd_inputs, bwd_errs = {}, {}
    rec_names = ("mx", "my", "conic_a", "conic_b", "conic_c", "opacity", "sub_opacity")
    for name, (col, sub) in bwd_cases.items():
        col = col.detach().contiguous()
        rec = cuda_raster.pack_records(splats, geom.opacity, sub_op if sub else None).detach()
        with torch.no_grad():
            out, out2 = cuda_raster.composite_fwd(ids, cnt, rec, col, ntx, sub)
        g = torch.as_tensor(rng.normal(size=out.shape).astype(np.float32), device=dev)
        g2 = (torch.as_tensor(rng.normal(size=out2.shape).astype(np.float32), device=dev)
              if sub else None)
        args = (ids, cnt, rec, col, out, out2, g, g2, ntx, sub)
        k = cuda_raster.composite_bwd(*args)
        p = cuda_raster.composite_bwd_plain(*args)
        torch.cuda.synchronize()
        leaves = {rec_names[j]: (k[0][:, j], p[0][:, j]) for j in range(7 if sub else 6)}
        leaves["colors"] = (k[1], p[1])
        rel = {nm: float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
               for nm, (a, b) in leaves.items()}
        abs_err = max(float((a - b).abs().max()) for a, b in leaves.values())
        print(f"{name}: max |k-p|/max|p| {json.dumps({n: float(f'{v:.3g}') for n, v in rel.items()})}, "
              f"max abs {abs_err:.3g}, CE={col.shape[1]}")
        require(all(bool(torch.isfinite(x).all()) for x in k), f"{name} not finite")
        require(not k[0][:, 7 if sub else 6:].any(), f"{name}: unused record columns written")
        for nm, (a, b) in leaves.items():
            require(float(b.abs().max()) > 0, f"{name} {nm}: the plain gradient is zero")
            require(rel[nm] <= BWD_REL, f"{name} {nm}: {rel[nm]:.3g} > {BWD_REL}")
        bwd_inputs[name] = args
        bwd_errs[name] = abs_err

    def train_state():
        stat_t = G.create_state(s_pts, s_cols, np.zeros(len(s_pts), np.float32),
                                capacity=len(s_pts) * CAP_MULT,
                                generator=torch.Generator(device=dev).manual_seed(0),
                                device=dev)
        dyn_t = G.create_state(d_traj[:, 0], np.full((len(d_traj), 3), 0.5, np.float32),
                               np.zeros(len(d_traj), np.float32),
                               capacity=len(d_traj) * CAP_MULT,
                               trajectory=torch.as_tensor(d_traj),
                               traj_times=torch.as_tensor(data.time), device=dev)
        sw = init_sandwich(torch.Generator(device=dev).manual_seed(1), device=dev)
        bl = B.init_blce(torch.Generator(device=dev).manual_seed(2), num_views=FRAMES,
                         num_warp=E_WARP, device=dev)
        return S.init_train_state(stat_t, dyn_t, sw, bl)

    # bench.py's seesaw overlay: batch 2, flow off
    opt = OptimizationParams(iterations=10_000, batch_size=B_VIEWS, lambda_flow_loss=0.0)

    phase("8 train step: kernels vs plain")
    t0 = time.time()
    ts = train_state()
    sampler = L.BatchSampler(FRAMES, B_VIEWS, seed=0)
    batch = L.make_batch(data, sampler.next_ids(), dev)
    groups = {"stat": G.split_diff(ts.stat)[0], "dyn": G.split_diff(ts.dyn)[0],
              "sandwich": S.sandwich_leaves(ts.sandwich),
              "blce": ts.blce.params.leaves()}
    names = {"stat": G.DIFF_FIELDS, "dyn": G.DIFF_FIELDS,
             "sandwich": ("w1", "w2"), "blce": B.BLCE_FIELDS}
    step_res = {}
    for backend in ("cuda", "plain"):
        fwd = S.make_forward(opt, W, H, data.max_time, E_WARP,
                             cfg._replace(backend=backend))
        off = torch.zeros((B_VIEWS, ts.stat.capacity + ts.dyn.capacity, 2),
                          device=dev, requires_grad=True)
        total, aux = fwd(ts.stat, ts.dyn, ts.sandwich, ts.blce, off, batch)
        leaves = [p for grp in groups.values() for p in grp] + [off]
        grads = torch.autograd.grad(total, leaves, allow_unused=True)
        step_res[backend] = (float(total.detach()), float(aux["psnr"]),
                             [torch.zeros_like(p) if gr is None else gr
                              for p, gr in zip(leaves, grads)])
        torch.cuda.synchronize()
    (lk, pk, gk), (lp, pp, gp) = step_res["cuda"], step_res["plain"]
    print(f"loss kernels {lk!r} plain {lp!r} (rel {abs(lk - lp) / abs(lp):.3g}); "
          f"psnr {pk:.4f} / {pp:.4f}")
    require(np.isfinite(lk) and abs(lk - lp) <= LOSS_RTOL * abs(lp), "train-step loss")
    i, worst, n_leaves = 0, {}, 0
    failed = []
    for grp, leaves in list(groups.items()) + [("offsets", (None,))]:
        for j in range(len(leaves)):
            nm = "offsets" if grp == "offsets" else f"{grp}.{names[grp][j]}"
            a, b = gk[i], gp[i]
            i += 1
            require(bool(torch.isfinite(a).all()), f"{nm} gradient not finite")
            scale = float(b.abs().max())
            if scale == 0.0:
                require(not a.any(), f"{nm}: kernels give a gradient, plain none")
                continue
            n_leaves += 1
            r = float((a - b).abs().max()) / scale
            worst[grp] = max(worst.get(grp, 0.0), r)
            if r > STEP_REL[grp]:
                failed.append(f"{nm} {r:.3g}")
    print(f"gradient leaves compared: {n_leaves}; worst max|k-p|/max|p| by group: "
          f"{json.dumps({k: float(f'{v:.3g}') for k, v in worst.items()})}")
    require(not failed, f"train-step gradients beyond tolerance: {failed}")
    times["step_check_s"] = time.time() - t0
    del step_res, gk, gp

    phase("9 train")
    step_fn = S.make_train_step(opt, W, H, data.max_time, E_WARP, cfg)
    before = {f"{grp}.{n}": p.detach().clone() for grp in ("stat", "dyn")
              for n, p in zip(G.DIFF_FIELDS, groups[grp])}
    for _ in range(N_WARM):
        ts, m = step_fn(ts, L.make_batch(data, sampler.next_ids(), dev))
    torch.cuda.synchronize()
    for key in cuda_raster.launches:
        cuda_raster.launches[key] = 0
    step_s, hist = [], []
    for k in range(N_STEPS):
        b = L.make_batch(data, sampler.next_ids(), dev)
        torch.cuda.synchronize()
        t0 = time.time()
        ts, m = step_fn(ts, b)
        torch.cuda.synchronize()
        step_s.append(time.time() - t0)
        hist.append((float(m.loss), float(m.psnr), int(m.tile_max)))
    train_launches = dict(cuda_raster.launches)
    rates["train_it_s"] = N_STEPS / sum(step_s)
    for k, (loss, ps, tm) in enumerate(hist):
        print(f"  step {N_WARM + k + 1:2d}: loss {loss:.6f} psnr {ps:.4f} "
              f"tile_max {tm} ({1e3 * step_s[k]:.1f} ms)")
    require(all(np.isfinite(h[0]) and np.isfinite(h[1]) for h in hist),
            "loss or PSNR not finite")
    print(f"train: {rates['train_it_s']:.3f} it/s flow off, B={B_VIEWS} E={E_WARP} "
          f"{W}x{H}, {ts.stat.capacity}+{ts.dyn.capacity} slots, on {card}; "
          f"median step {1e3 * float(np.median(step_s)):.1f} ms")
    print(f"training-path launches ({N_STEPS} steps): {json.dumps(train_launches)}")
    # per view: E-1 latent renders (plain chain) and the mid render (sub chain)
    per_step = {"raster_fwd": B_VIEWS * (E_WARP - 1), "raster_fwd_sub": B_VIEWS,
                "raster_bwd": B_VIEWS * (E_WARP - 1), "raster_bwd_sub": B_VIEWS}
    for key, n in per_step.items():
        require(train_launches[key] == n * N_STEPS,
                f"{key}: {train_launches[key]} launches, expected {n} per step")
    moved, still = 0, []
    for grp in ("stat", "dyn"):
        opt_state = getattr(ts, f"{grp}_opt")
        for n, p, mu in zip(G.DIFF_FIELDS, G.split_diff(getattr(ts, grp))[0], opt_state.mu):
            if not mu.any():
                continue  # no gradient reached this field
            if torch.equal(p.detach(), before[f"{grp}.{n}"]):
                still.append(f"{grp}.{n}")
            moved += 1
    print(f"Gaussian fields with a gradient: {moved}, all changed: {not still}")
    require(moved > 0 and not still, f"fields with a gradient did not change: {still}")

    b = L.make_batch(data, sampler.next_ids(), dev)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.time()
        ts, m = step_fn(ts, b)
        torch.cuda.synchronize()
        wall_us = (time.time() - t0) * 1e6
    by_name = {}
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            by_name[ev.name] = by_name.get(ev.name, 0.0) + ev.time_range.elapsed_us()
    busy_us = sum(by_name.values())
    if busy_us:
        print(f"trace: {wall_us:.0f} us wall per train step, {busy_us:.0f} us device "
              f"busy ({100 * busy_us / wall_us:.1f} %), {len(by_name)} kernel names")
        for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]:
            print(f"  {us:8.1f} us  {name[:90]}")
    else:
        print("trace: the profiler recorded no device time (not measured)")

    # ---- kernel timing at protocol shape (launches not counted above) ----
    entries = []

    def entry(key, ms, plain_ms, ops, bytes_, err):
        bound_ms = max(ops / PEAK_F32, bytes_ / PEAK_BYTES) * 1e3
        entries.append({
            "name": key, "route": "cuda",
            "source": SOURCES["raster_bwd" if "bwd" in key else "raster_fwd"],
            "replaces": REPLACES[key], "launches": train_launches[key],
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": "operations" if ops / PEAK_F32 >= bytes_ / PEAK_BYTES else "bytes",
            "library_ms": None,
        })
        return bound_ms

    for key, case in (("raster_fwd", "a_default_ce11"),
                      ("raster_fwd_sub", "b_fused_sub")):
        sub = key == "raster_fwd_sub"
        col = torch.cat([geom.colors, splats.depths[:, None], ones], 1).detach().contiguous()
        rec = cuda_raster.pack_records(splats, geom.opacity,
                                       sub_op if sub else None).detach()
        with torch.no_grad():
            ms = cuda_ms(lambda: cuda_raster.composite_fwd(ids, cnt, rec, col, ntx, sub), 50)
            work = {}
            cuda_raster.composite_tiles_plain(ids, cnt, rec, col, ntx, sub, work=work)
            plain_ms = cuda_ms(lambda: cuda_raster.composite_tiles_plain(
                ids, cnt, rec, col, ntx, sub), 5)
        CE = col.shape[1]
        pairs = int(work["slots"].sum()) * cuda_raster.P
        # per live (slot, pixel) pair: dx, dy, sigma (11), exp (1), alpha (2),
        # transmittance (2); per kept pair: weight (2) and CE multiply-adds
        ops = pairs * 16 + int(work["valid"]) * (2 + 2 * CE)
        n_ref = int(work["n_ref"])
        bytes_ = 4 * (int(work["slots"].sum()) + T_tiles + n_ref * (6 + CE)
                      + T_tiles * 256 * CE)
        if sub:
            ops += pairs * 4 + int(work["valid_sub"]) * 3
            bytes_ += 4 * (n_ref + T_tiles * 256)
        err = max(errs[case].get(k2, 0.0) for k2 in ("image", "alpha", "sub_alpha"))
        bound_ms = entry(key, ms, plain_ms, ops, bytes_, err)
        print(f"{key}: {ms:.4f} ms kernel, {plain_ms:.3f} ms plain, bound "
              f"{bound_ms:.4f} ms ({ops / 1e9:.3f} GOP, {bytes_ / 1e6:.2f} MB, "
              f"{pairs} pairs, T={T_tiles}, K={ids.shape[1]}, CE={CE})")

    for key, case in (("raster_bwd", "a_latent_ce9"), ("raster_bwd_sub", "b_mid_ce11_sub")):
        args = bwd_inputs[case]
        _, _, rec, col, _, _, _, _, _, sub = args
        ms = cuda_ms(lambda: cuda_raster.composite_bwd(*args), 50)
        plain_ms = cuda_ms(lambda: cuda_raster.composite_bwd_plain(*args), 5)
        work = {}
        with torch.no_grad():
            cuda_raster.composite_tiles_plain(ids, cnt, rec, col, ntx, sub, work=work)
        CE = col.shape[1]
        pairs = int(work["slots"].sum()) * cuda_raster.P
        n_ref = int(work["n_ref"])
        rows = 7 if sub else 6
        # per live pair the replay of the forward (16); per kept pair: T_i,
        # weight (3), c.g (2 CE), running sum (2), dL/dalpha (6), dL/dsigma
        # (2), the five geometric terms (18), dL/do (1), CE colour terms, and
        # the (6 + CE) sums over pixels
        ops = pairs * 16 + int(work["valid"]) * (38 + 4 * CE)
        # ids, counts, records and colours of the referenced Gaussians, out
        # and g read once, the zeroed gradient tables written once, and a
        # read-modify-write of each referenced Gaussian's gradient row
        N_all = rec.shape[0]
        bytes_ = 4 * (int(work["slots"].sum()) + T_tiles + n_ref * (rows + CE)
                      + 2 * T_tiles * 256 * CE + N_all * (cuda_raster.R + CE)
                      + 2 * n_ref * (rows + CE))
        if sub:
            # the subset chain: alpha and transmittance per live pair, 14 per
            # kept pair and its sum over pixels; out2 and g2 read once
            ops += pairs * 4 + int(work["valid_sub"]) * 15
            bytes_ += 4 * 2 * T_tiles * 256
        bound_ms = entry(key, ms, plain_ms, ops, bytes_, bwd_errs[case])
        print(f"{key}: {ms:.4f} ms kernel (with the zeroed outputs), {plain_ms:.3f} ms "
              f"plain, bound {bound_ms:.4f} ms ({ops / 1e9:.3f} GOP, {bytes_ / 1e6:.2f} MB, "
              f"{pairs} pairs, {int(work['valid'])} kept, T={T_tiles}, CE={CE})")
    print(f"times: {json.dumps({k: round(v, 2) for k, v in times.items()})}")
    print(f"rates: {json.dumps(rates)}")

    phase("10 result")
    print(json.dumps({"kernels": entries}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
