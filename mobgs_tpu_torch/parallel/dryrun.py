"""The multi-rank dry run (counterpart of ``__graft_entry__.py:57-252``,
``dryrun_multichip`` / ``_dryrun_multichip_impl``): the full train step on
a ``data`` x ``gauss`` mesh of n ranks, at the JAX dry run's shapes.

    python -m mobgs_tpu_torch.parallel.dryrun --n 4 --device cpu|cuda [--out DIR]

It spawns n processes (``torch.multiprocessing``, spawn) that join one
``torch.distributed`` group on ``tcp://127.0.0.1:<free port>``: ``gloo`` on
the CPU, and on the card ``gloo`` when the ranks share one card (their
tensors stay on ``cuda:0``) or NCCL when there is one card per rank. The
mesh is data 2 x gauss n/2 (data 1 for an odd n), with tile sharding on.
From a state built from seeds at the JAX shapes (64x48, 4 views,
``num_warp=3``, ``cap_s = 32·n_gauss·4`` and ``cap_d = 32·n_gauss`` slots,
``tile_chunk=4``, ``max_per_tile=128``, ``lambda_flow_loss=1e-2``) each rank
takes its shard, then runs 3 steps, a densify round on the gathered
dynamic pool (``grad_threshold=1e-8``, the same split key on every rank,
then re-sharded), one more step and a checkpoint round trip (rank 0 writes
the gathered state; every rank loads it and must find its state bit for
bit). It checks that in each launch of V views each gauss rank
composited exactly its contiguous V·T / n_gauss of the V·T tile rows,
renders the JAX scale-out tests' clouds on gauss-sharded rows (a 256x128
view of 1024 Gaussians; one 64x48 scene per data rank) against the rank's
render of the whole cloud, and prints rank 0's summary (with the kernels'
launches in the steps, summed over the ranks) as one JSON line. With
``--out``, rank 0 writes there the whole state before the first step and after each
step (``train_state_<k>.npz``, the port's checkpoint format) and
``summary.json``.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import sys
import tempfile

import numpy as np
import torch

W, H, NUM_VIEWS, NUM_WARP = 64, 48, 4, 3
STEPS_BEFORE, DENSIFY_KEY = 3, (7, 0, 1)
KMAT = [[60.0, 0.0, W / 2], [0.0, 60.0, H / 2], [0.0, 0.0, 1.0]]


def build_tiny(n_gauss: int, device, seed: int = 0):
    """The dry run's whole train state, as ``__graft_entry__._build_tiny``
    builds its JAX one (the point clouds from a numpy seed; the port's
    generators for the static control points, the Sandwich and BLCE)."""
    from mobgs_tpu_torch.models import blce as B
    from mobgs_tpu_torch.models import gaussians as G
    from mobgs_tpu_torch.models.sandwich import init_sandwich
    from mobgs_tpu_torch.train.step import init_train_state

    cap_s, cap_d = 32 * n_gauss * 4, 32 * n_gauss
    rng = np.random.default_rng(seed)
    ns, nd = cap_s // 2, cap_d // 2
    s_pts = rng.normal(size=(ns, 3)).astype(np.float32)
    s_pts[:, 2] += 6
    stat = G.create_state(s_pts, rng.uniform(size=(ns, 3)).astype(np.float32),
                          np.zeros(ns, np.float32), cap_s,
                          generator=torch.Generator(device=device).manual_seed(0),
                          device=device)
    times = np.linspace(0, 1, 6).astype(np.float32)
    base = rng.normal(size=(nd, 3)).astype(np.float32)
    base[:, 2] += 6
    traj = base[:, None, :] + 0.2 * times[None, :, None]
    dyn = G.create_state(base, rng.uniform(size=(nd, 3)).astype(np.float32),
                         np.zeros(nd, np.float32), cap_d, trajectory=torch.as_tensor(traj),
                         traj_times=torch.as_tensor(times), device=device)
    sandwich = init_sandwich(torch.Generator(device=device).manual_seed(1), device=device)
    blce = B.init_blce(torch.Generator(device=device).manual_seed(2), num_views=NUM_VIEWS,
                       num_warp=NUM_WARP, device=device)
    return init_train_state(stat, dyn, sandwich, blce)


def make_batch(n_views: int, device, seed: int = 0):
    """The dry run's camera batch of ``n_views`` views (the JAX dry run's:
    identity poses, times over [0.2, 0.8], random images, depth 5)."""
    from mobgs_tpu_torch.train.step import Batch
    rng = np.random.default_rng(seed)

    def on(x, dt=torch.float32):
        return torch.as_tensor(np.asarray(x), dtype=dt, device=device)

    return Batch(view_idx=on(np.arange(n_views) % NUM_VIEWS, torch.int64),
                 w2c=on(np.tile(np.eye(4, dtype=np.float32)[None], (n_views, 1, 1))),
                 K=on(np.tile(np.asarray(KMAT, np.float32)[None], (n_views, 1, 1))),
                 time=on(np.linspace(0.2, 0.8, n_views)),
                 image=on(rng.uniform(size=(n_views, H, W, 3))),
                 depth=on(np.full((n_views, H, W), 5.0)),
                 blur_feat=on(np.full((n_views,), 0.5)))


def train_settings(n_data: int):
    """(OptimizationParams, RasterConfig) of the dry run."""
    from mobgs_tpu_torch.config import OptimizationParams
    from mobgs_tpu_torch.ops.rasterize import RasterConfig
    return (OptimizationParams(iterations=10, batch_size=n_data, lambda_flow_loss=1e-2),
            RasterConfig(tile_chunk=4, max_per_tile=128))


def scale_out_cloud(n: int, seed: int = 0):
    """(means, quats, scales, opacities, colors) as numpy float32: the cloud
    of the JAX package's scale-out tests (``tests/test_multiscene_shard.py``
    ``make_cloud``), from the same seed."""
    rng = np.random.default_rng(seed)
    means = rng.normal(size=(n, 3)).astype(np.float32)
    means[:, 2] += 7.0
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    scales = np.exp(rng.uniform(-3.5, -2, (n, 3))).astype(np.float32)
    opac = rng.uniform(0.3, 0.9, n).astype(np.float32)
    colors = rng.uniform(size=(n, 3)).astype(np.float32)
    return means, quats, scales, opac, colors


# the scale-out renders: (width, height, Gaussians, focal, tile_chunk,
# max_per_tile) of the gauss-sharded high-resolution render and of the
# two-scene data-parallel batch (test_multiscene_shard.py:25, :52)
HIGHRES = (256, 128, 1024, 150.0, 16, 256)
MULTISCENE = (64, 48, 256, 60.0, 6, 128)


def render_cloud(cloud, spec, device, rows=None):
    """The cloud rendered through ``ops/rasterize.py`` at ``spec``, with a
    zero background; ``rows`` (start, stop) hands it only those rows (this
    rank's, inside ``gauss_sharded``). Returns the image [H, W, 3]."""
    from mobgs_tpu_torch.ops.rasterize import RasterConfig, rasterize
    w, h, _, f, chunk, cap = spec
    x = [torch.as_tensor(a if rows is None else a[rows[0]:rows[1]], device=device)
         for a in cloud]
    K = torch.tensor([[f, 0.0, w / 2], [0.0, f, h / 2], [0.0, 0.0, 1.0]], device=device)
    out = rasterize(*x, torch.eye(4, device=device), K, w, h,
                    background=torch.zeros(3, device=device),
                    config=RasterConfig(tile_chunk=chunk, max_per_tile=cap))
    return out.images[0]


def densify_round(ts):
    """The dry run's densify on a whole state: clone and split of the
    dynamic pool at ``grad_threshold=1e-8`` (real work), key DENSIFY_KEY.
    Returns (state, dropped)."""
    from mobgs_tpu_torch.train import densify as D
    dyn, dyn_opt, dyn_stats, n_drop = D.densify_clone_split(
        ts.dyn, ts.dyn_stats, ts.dyn_opt, DENSIFY_KEY, grad_threshold=1e-8,
        percent_dense=0.01, scene_extent=6.0, split_n=2)
    return ts._replace(dyn=dyn, dyn_opt=dyn_opt, dyn_stats=dyn_stats), int(n_drop)


def _rank_main(rank: int, n: int, port: int, device: str, out_dir: str | None):
    import torch.distributed as dist

    from mobgs_tpu_torch.io import checkpoint as ckpt
    from mobgs_tpu_torch.ops import cuda_raster
    from mobgs_tpu_torch.parallel import mesh as Mx
    from mobgs_tpu_torch.train.step import make_train_step

    torch.set_num_threads(1)
    if device == "cuda":
        per_rank = torch.cuda.device_count() >= n
        dev = torch.device("cuda", rank if per_rank else 0)
        torch.cuda.set_device(dev)
        backend = "nccl" if per_rank else "gloo"
    else:
        dev, backend = torch.device("cpu"), "gloo"
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=n)
    try:
        n_data = 2 if n % 2 == 0 and n > 1 else 1
        n_gauss = n // n_data
        mesh = Mx.make_mesh(n_data, n_gauss)
        Mx.enable_tile_sharding(mesh, axis="gauss")
        d, r = mesh.get_local_rank("data"), mesh.get_local_rank("gauss")
        whole = build_tiny(n_gauss, dev)
        batch = make_batch(n_data, dev)
        mine = type(batch)(*(x[d:d + 1] for x in batch))  # this data rank's view
        opt, rcfg = train_settings(n_data)
        step_fn = make_train_step(opt, W, H, max_time=5.0, num_warp=NUM_WARP,
                                  raster_cfg=rcfg, mesh=mesh)
        writer = rank == 0 and out_dir is not None
        if writer:
            ckpt.save_train_state(os.path.join(out_dir, "train_state_0.npz"), whole)
        ts = Mx.shard_train_state(whole, mesh)

        # each composite's tile range: (tile0, rows, tiles a view) of every launch
        ranges = []
        real = cuda_raster.composite_fwd, cuda_raster.composite_plain

        def recording(fn):
            def wrapped(ids, counts, rec, col, ntx, sub=False, tile0=0, tpv=None):
                ranges.append((tile0, ids.shape[0], tpv))
                return fn(ids, counts, rec, col, ntx, sub, tile0, tpv)
            return wrapped

        cuda_raster.composite_fwd, cuda_raster.composite_plain = map(recording, real)
        cuda_raster.reset_launches()
        losses = []

        def step(ts):
            ts, m = step_fn(ts, mine)
            losses.append(float(m.loss))
            if out_dir is not None:
                ckpt.save_train_state(
                    os.path.join(out_dir, f"train_state_{len(losses)}.npz"), ts, mesh)
            return ts, m

        try:
            for _ in range(STEPS_BEFORE):
                ts, m = step(ts)
            if not np.isfinite(losses[-1]):
                raise RuntimeError(f"non-finite loss {losses[-1]}")
            full, n_drop = densify_round(Mx.gather_train_state(ts, mesh))
            n_live = int(full.dyn.num_live())
            if n_live <= 0:
                raise RuntimeError("no live dynamic Gaussian after densify")
            ts, m = step(Mx.shard_train_state(full, mesh))
        finally:
            cuda_raster.composite_fwd, cuda_raster.composite_plain = real
        # the kernels' launches of the steps, summed over the ranks
        names = sorted(cuda_raster.launches)
        launched = torch.tensor([cuda_raster.launches[k] for k in names], device=dev)
        dist.all_reduce(launched)
        if not np.isfinite(float(m.loss)):
            raise RuntimeError(f"non-finite loss {float(m.loss)}")

        # checkpoint round trip: rank 0 writes the gathered state, every
        # rank loads it into its own template and finds its state bit for bit
        full = Mx.gather_train_state(ts, mesh)
        with tempfile.TemporaryDirectory() as tmp:
            obj = [os.path.join(tmp, "train_state.npz") if rank == 0 else None]
            dist.broadcast_object_list(obj, src=0)
            ckpt.save_train_state(obj[0], ts, mesh)
            dist.barrier()
            back = ckpt.load_train_state(obj[0], full)
            dist.barrier()
        a, b = ckpt.flatten_train_state(full), ckpt.flatten_train_state(back)
        bad = [k for k in a if not np.array_equal(a[k], b[k])]
        if bad:
            raise RuntimeError(f"checkpoint round trip differs at {bad[:3]}")

        # the scale-out renders on gauss-sharded rows, tile sharding on:
        # the high-resolution cloud on every data rank, and scene d on data
        # rank d; each against this rank's render of the whole cloud alone
        renders = {}
        for name, spec, seed in (("highres", HIGHRES, 0), ("scene", MULTISCENE, d)):
            cloud = scale_out_cloud(spec[2], seed)
            per_rank = spec[2] // n_gauss
            with Mx.gauss_sharded(mesh):
                img = render_cloud(cloud, spec, dev, (r * per_rank, (r + 1) * per_rank))
            Mx.disable_tile_sharding()
            alone = render_cloud(cloud, spec, dev)
            Mx.enable_tile_sharding(mesh, axis="gauss")
            err = float((img - alone).abs().max())
            if err > 1e-5:
                raise RuntimeError(f"{name} render, gauss-sharded vs alone: {err}")
            renders[f"{name}_{d}" if name == "scene" else name] = img.cpu().numpy()
        if out_dir is not None and r == 0:
            np.savez(os.path.join(out_dir, f"renders_rank{rank}.npz"), **renders)

        # every launch of V views covered exactly this rank's contiguous
        # V·T / n_gauss of its V·T tile rows
        T = (W // 16) * (H // 16)
        per = T // n_gauss
        launches_by_views = {}
        for tile0, rows, tpv in ranges:
            views = rows // per
            if tpv != T or rows != views * per or tile0 != r * views * per:
                raise RuntimeError(f"rank {rank}: tile range {(tile0, rows)} of a launch of "
                                   f"{tpv} tiles a view, expected ({r} * V * {per}, V * {per})")
            launches_by_views[views] = (tile0, rows)
        if not ranges:
            raise RuntimeError(f"rank {rank}: no composite recorded")
        summary = {"n": n, "mesh": {"data": n_data, "gauss": n_gauss}, "backend": backend,
                   "device": str(dev), "losses": losses, "psnr": float(m.psnr),
                   "dyn_live": n_live, "densify_dropped": n_drop,
                   "checkpoint_roundtrip": "bit-equal",
                   "launches": dict(zip(names, launched.tolist())),
                   "tile_ranges": {"tiles": T, "per_view_per_rank": per,
                                   "this_rank": {str(v): list(x) for v, x
                                                 in sorted(launches_by_views.items())},
                                   "composites": len(ranges)}}
        if writer:
            with open(os.path.join(out_dir, "summary.json"), "w") as f:
                json.dump(summary, f)
        if rank == 0:
            print(json.dumps(summary), flush=True)
    finally:
        Mx.disable_tile_sharding()
        dist.destroy_process_group()


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def dryrun(n: int = 4, device: str = "cpu", out_dir: str | None = None) -> dict:
    """Spawn the n ranks and wait for them; returns rank 0's summary (read
    back from ``out_dir``, a temporary directory unless given). Raises if
    a rank failed."""
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory() as tmp:
        out = out_dir or tmp
        os.makedirs(out, exist_ok=True)
        mp.start_processes(_rank_main, args=(n, free_port(), device, out), nprocs=n,
                           start_method="spawn")
        with open(os.path.join(out, "summary.json")) as f:
            return json.load(f)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=4)
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cuda")
    ap.add_argument("--out", help="write the states after each step and summary.json here")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("dryrun: torch.cuda.is_available() is False; pass --device cpu",
              file=sys.stderr)
        return 2
    dryrun(args.n, args.device, args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
