#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (``mobgs_tpu_torch``).

Drives the port's serving path, its flow-off and flow-on training steps, its
exposure re-estimation, its host training loop, its train CLI, a user's
whole run on a stereo scene (train, eval and metrics CLIs), the train CLI
on an iPhone and a Blender scene and the rest of the library (the gsplat
shim through the kernels, the deformation field, PoseNet, the warps, the
KNN constraint and knot pruning) on one CUDA card at the seesaw protocol's full
width (512x288, 24 frames, 20k static + 10k dynamic seeds at x2 capacity =
40k + 20k slots, tiles_per_gauss=9, max_per_tile=256; training at B=2 views
and E=9 latent exposures), with a scene made from a seed and random
Sandwich and BLCE weights:

1. the card's name and power limit, torch and CUDA versions;
2. build the forward and backward compositor kernels from
   ``mobgs_tpu_torch/csrc`` (one nvcc each, started together) and print
   ``-Xptxas -v``'s registers, shared memory and spills; for each forward
   and backward instance the main paths and the tests launch, the threads
   per block, registers, shared memory, spills and resident blocks per SM
   that the CUDA occupancy API gives, and the waves that 576 tiles take
   (an instance that spills fails the run);
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
   upstream gradients from a seeded numpy generator; and the flow-on mid
   render at E=11 and E=27 (CE=33 and CE=65 with the sub chain), which run
   in column groups (2 and 3 launches), forward and backward against the
   plain versions, with the launches per group;
8. one flow-off train step's loss and gradients through the kernels
   against the plain route (``RasterConfig(backend="plain")``), same state
   and batch;
9. train: 3 warm-up and 20 timed flow-off steps through ``make_train_step``
   with ``BatchSampler(24, 2, seed=0)``; report it/s, loss and PSNR per
   step, read the launch counts of the timed steps (16 + 2 forward and
   16 + 2 backward launches per step), check the parameters moved, and
   trace one step;
10. the same check as 8 for a flow-on step (``lambda_flow_loss=1e-2``, the
    default configuration), whose flow term must be finite and positive,
    and again at E=11 latent exposures (the mid render at CE=33 + sub, two
    column groups), then one E=11 step through the kernels with its
    launches by instance;
11. train 3 warm-up and 10 timed flow-on steps from a fresh state: it/s,
    loss, flow term and PSNR per step; exactly 16 ``raster_fwd`` / 18
    ``raster_fwd_sub`` / 16 ``raster_bwd`` / 18 ``raster_bwd_sub``
    launches per step (the CE=11 + sub exposure-flow passes and the CE=29 +
    sub mid render by instance); parameters moved; one step traced; the
    warp loss of one view traced alone;
12. ``make_exposure_update`` on a batch with an endpoint view through the
    kernels and the plain route (new exposures within EXPO_RTOL, finite,
    written only at the batch's views), then timed over 10 calls, each 4
    CE=4 forward launches and no backward; one call traced;
13. time every kernel with CUDA events at protocol shape beside its plain
    version and its bound; the table's four entries, and on lines of their
    own the instances the training paths launch: CE=9 image-only, the CE=11
    + sub exposure-flow pass, the CE=29 + sub mid render forward and
    backward, ``get_flow_static``'s CE=4 forward, each with its flow-on
    launches, and the CE=33 and CE=65 + sub mid renders (column groups);
14. the K ladder: a 128x128 view of the scene (focal length a quarter of
    the protocol's, so its 64 tiles hold thousands of entries each) with
    the opacities scaled by 0.1 (so the walks go deep before they
    saturate): the forward at max_per_tile 1024, 1536 and 2048 (CE=9, CE=11
    as the capacity validation renders, and CE=11 + sub) and the backward at
    1024 and 1536, each against its plain version and timed beside its
    bound;
15. the host loop at protocol width: ``train/loop.py::train`` for
    LOOP_ITERS iterations, flow on, with the densify schedule brought
    forward (boundaries every 4 iterations from 8; three static densify
    rounds, then prunes; opacity reset at 16; exposure updates at 10, 20,
    30; capacity drift checks at every boundary; budget checks every 12)
    and a gradient threshold low enough to grow the pools; it/s, events,
    the host time and live counts per pool of each iteration, launches by
    instance, the peak device memory of the last iteration at the grown
    capacity, and the phase's seconds; then one more step at the grown
    capacity and the last iteration's budgets (from the history): its own
    peak memory; that step and an exposure update there through the kernels
    against the plain route, the step also against the same step with the
    compositor in float64, since its walks run thousands of entries deep
    (DEEP_PLAIN_X); phase 14's ladder at every budget the loop
    could composite at that phase 14 did not hold (the budgets it ran at,
    its validations' top budget, the validation and de-escalation ladders
    below it), forward and backward; and a trace of the step;
16. a 10-iteration loop on a reduced scene (128x72) through the kernels and
    through the plain route from the same seeds: the same history length,
    loss per iteration within LOSS_RTOL, live counts and capacities equal
    (or the densify decision that flipped and its margin), exposures within
    EXPO_RTOL;
17. the train CLI, ``mobgs_tpu_torch.cli.train.main`` as ``python -m
    mobgs_tpu_torch.cli.train --configs configs/stereo/seesaw.py
    --synthetic --synthetic_size 512x288x24 --iterations 30
    --test_iterations 15 --eval_tto`` runs it, into ``build/``: its seconds,
    the loop's it/s, launches by kernel instance (every kernel launched)
    and peak memory; every artifact written (history, eval curve, the
    ``iteration_30`` and ``iteration_best`` checkpoints, the debug grid);
    a render of view 0 from the PLYs and ``.pt`` read back equal to the
    final state's within IMG_ATOL; ``blce.pth`` reloaded bit-equal; one
    eval as the CLI runs it, timed; TTO at 5 steps on two test views through
    the kernels and the plain route (poses within TTO_POSE_ATOL, PSNR
    within TTO_PSNR_ATOL); a resume to 36 iterations that splices the
    history;
18. a user's whole run on a DyBluRF stereo scene (``train.sh`` and
    ``eval.sh``): a stereo-format scene directory written from the
    generator at 512x288x24 into ``build/`` (LLFF poses, ``scene.json``,
    blurry and sharp frames, depths, motion masks, 2,048 TAPIR-format
    tracks a query frame), its loaded cameras held to the generator's; the
    train CLI with ``-s`` and ``configs/stereo/seesaw.py`` for STEREO_ITERS
    iterations (the loader, the warm stage on the card with the seesaw seed
    counts, an eval and the checkpoints); the eval CLI on ``iteration_best``
    with STEREO_TTO_STEPS TTO steps (24 refined PNGs, ``solved_poses.npy``,
    finite ATE / RPE); TTO at 5 steps on two test views through the kernels
    and the plain route; the metrics CLI (``results.json``: PSNR, SSIM,
    ``lpips_randfeat``, tOF or null without ``cv2``); LPIPS and SSIM of the
    same images on the card and on the CPU within STEREO_METRIC_ATOL; the
    seconds of the loader, the warm stage, the training, the eval CLI and
    the metrics CLI, the ms of one TTO view, the launches by instance and
    the peak memory;
19. the train CLI's registry branch as a user runs it (``python -m
    mobgs_tpu_torch.cli.train -s <scene> --eval_tto``, the defaults of
    ``Config``: flow on, B=1, E=9, 40,000 + 20,000 depth seeds, 54,000 +
    6,000 of them kept) on two scenes written from the generator into
    ``build/``: a dycheck iPhone scene at 360x480 (a partial tile column, the
    principal point off the centre, a skew entry, ``scene.json`` scale 0.5, a
    ``val`` split from a second camera) and a D-NeRF Blender scene at 800x800
    (2,500 tiles; RGBA frames, ``transforms_{train,test}.json``), each loaded
    back against the generator and trained REG_ITERS iterations with an eval
    of 5 TTO steps: seconds of the loader, the seeding, the budget
    validation, the loop and the eval, the loop's it/s, the peak memory, the
    final loss, the eval PSNR, the validated budgets and the launches by
    instance (every kernel launched), the checkpoint read back; the four
    kernels at view 0 of each run's final state (CE=9 and CE=29 + sub,
    forward and backward) against their plain versions, timed beside their
    bounds; and the camera-shared static pool on the iPhone run's state
    (dynamic pool a ninth of the static one) and on the protocol scene (a
    half): one flow-on step shared and unshared (loss within LOSS_RTOL,
    leaves within STEP_REL), the merged bins and the forward images of the
    mid render and a flow pass bit-equal, and the device ms per step of both
    with their launches (equal);
20. the rest of the library on the card: the gsplat shim
    (``compat.rasterization``) on the protocol scene at t = 0.5, C = 3
    "RGB+ED" and C = 9 "RGB" (CE = 5 and 11), forward and backward through
    the kernels against the plain route within IMG_ATOL, DEPTH_RTOL and
    BWD_REL per gradient column, its launches counted from 0 (one forward and
    one backward an instance) and each instance timed beside its bound;
    ``fully_fused_projection`` bit-equal to ``project``; the deformation
    field at ModelHiddenParams' widths (the 143 MB net of ``deformation.pth``)
    over the 60,000 slots, forward and backward with the regulation loss,
    against the CPU at three frame times and timed at all 24; PoseNet at 24
    views with a 512x288 depth; ``direct_warp_rt1_rt2`` (64 buckets),
    ``occ_rt1_rt2`` (128) and ``warp_pc2flow`` at 512x288; ``ball_query``
    (indices equal) and ``knn_constraint_loss`` on 20,000 points; and
    ``onedown_control_pts`` on the 20,000 dynamic splines and 24 views, and
    again with every other spline wiggled so that both branches run
    (decisions equal), each card against CPU and timed;
21. print the ``{"kernels": [...]}`` line (launches: the flow-off training
    path's, the registry runs' and the shim's), chip_smoke's wall seconds,
    then the card line and the ``{"ok": true, ...}`` line last.

Every failure raises and exits non-zero. Without a CUDA card it exits 2
and prints no result. Run: ``python3 chip_smoke.py``.
"""

import contextlib
import json
import os
import shutil
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
# Walks thousands of entries deep (the host loop's last budgets, K = 2560)
# carry float32 rounding over thousands of transmittance factors: on an
# H100 the dynamic pool's feature gradients of either route then sit up to
# 2.6e-4 of their largest magnitude from the same step with the compositor
# in float64 (1e-6 at K = 256 on the same state), and the two routes differ
# by 1.1e-4 to 1.4e-4. There both are held against the float64 compositor:
# the kernels' distance from it is at most STEP_REL or DEEP_PLAIN_X times
# the plain route's.
DEEP_PLAIN_X = 2.0
LOSS_RTOL = 1e-5
N_WARM, N_STEPS, B_VIEWS, E_WARP = 3, 20, 2, 9
N_FLOW_WARM, N_FLOW_STEPS, LAMBDA_FLOW = 3, 10, 1e-2
# The exposure update through the kernels vs the plain route: a median of
# ratios of composited flow magnitudes, so the compositor's differences
# above, unless they move a pixel across the 1 % quantile cut-off.
EXPO_RTOL = 1e-3
N_EXPO = 10
# the flow-on step and mid render beyond one kernel instance (CE_GROUP = 32):
# E=11 (CE=33 + sub, two column groups) and E=27 (CE=65 + sub, three)
E_WIDE = (11, 27)
# the K ladder: a 128x128 view; forward and backward budgets
K_VIEW = 128
K_FWD, K_BWD = (1024, 1536, 2048), (1024, 1536)
# the host loop at protocol width (phase 15) and the reduced loop (phase 16)
LOOP_ITERS = 30
LOOP_GRAD_THR = 2e-5
LOOP_MAX_CAP = 131_072
N_SMALL_LOOP = 10
# the train CLI (phase 17): seesaw at full width, an eval every 15 iterations
# with 5 TTO steps, then a resume for 6 more; TTO through the kernels vs the
# plain route: poses (scalars ~1, moved by Adam steps of lr 3e-4) and PSNR
CLI_ITERS, CLI_EVAL_EVERY, CLI_RESUME_ITERS = 30, 15, 36
ROOT = os.path.dirname(os.path.abspath(__file__))
CLI_OUT = os.path.join(ROOT, "build", "chip_smoke_cli")
CLI_CKPT_FILES = ("point_cloud.ply", "point_cloud.pt", "point_cloud_static.ply",
                  "blce.pth", "deformation.pth", "deformation_table.pth",
                  "deformation_accum.pth", "train_state.npz")
TTO_POSE_ATOL, TTO_PSNR_ATOL = 1e-5, 1e-3
# the stereo run (phase 18): a stereo-format scene written from the
# generator, seesaw at full width for STEREO_ITERS iterations (cut from
# 10,000), the eval CLI at STEREO_TTO_STEPS TTO steps (cut from 100);
# LPIPS and SSIM on the card vs the CPU, both in float32
STEREO_ROOT = os.path.join(ROOT, "build", "chip_smoke_stereo")
STEREO_TRACKS = 2048
STEREO_ITERS, STEREO_TTO_STEPS = 10, 10
STEREO_METRIC_ATOL = 1e-5
# the registry runs (phase 19): a dycheck iPhone scene at the published 2x
# resolution, 360x480 (22.5 tile columns; the principal point off the centre
# and a skew entry), and a D-NeRF Blender scene at 800x800 (2,500 tiles), each
# REG_FRAMES train and as many test frames (the train CLI's eval pairs test
# view i with train view i, eval/align.py), trained REG_ITERS iterations (cut
# from 30,000) by the train CLI with the defaults of Config; then the shared
# static pool, SHARED_STEPS timed steps after SHARED_WARM
REG_ROOT = os.path.join(ROOT, "build", "chip_smoke_registry")
REG_FRAMES, REG_ITERS = 24, 10
IPHONE_W, IPHONE_H, IPHONE_SKEW = 360, 480, 1.5
BLENDER_W = 800
SHARED_WARM, SHARED_STEPS = 3, 10
# the rest of the library (phase 20): the gsplat shim at C = 3 "RGB+ED" and
# C = 9 "RGB" (composites of CE = 5 and 11) on the protocol scene at t = 0.5;
# the deformation field at ModelHiddenParams' widths over the 60,000 slots at
# the 24 frame times, held against the CPU at LIB_CPU_TIMES of them (the CPU
# takes ~3 s a time); the warps' buckets; knot pruning's threshold (the
# reference's error_threshold in its own prune test)
SHIM_MODES = ((3, "RGB+ED"), (9, "RGB"))
LIB_CPU_TIMES = (0, 11, 23)
LIB_FWD_REL = 1e-5
LIB_GRAD_REL = 1e-4
# the warps sample at pixel coordinates up to 511, whose float32 spacing is
# 2^-15 (3.1e-5): a coordinate a rounding apart on the two devices moves a
# bilinear weight by that much, and the one-hot disparity volume jumps by 1
# between taps
WARP_REL = 1e-4
WARP_BUCKETS = {"direct_warp_rt1_rt2": 64, "occ_rt1_rt2": 128}
KNN_POINTS, KNN_K = 20_000, 20
ONEDOWN_THR = 0.05
# flow columns are displacements in pixels: their kernel-vs-plain difference
# is held at IMG_ATOL times their largest magnitude (at least 1 pixel)
# Published H100 SXM peaks (NVIDIA data sheet, at 700 W): float32 outside
# the tensor cores, and HBM3 bandwidth.
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12
SOURCES = {"raster_fwd": "mobgs_tpu_torch/csrc/raster_fwd.cu",
           "raster_bwd": "mobgs_tpu_torch/csrc/raster_bwd.cu"}
# the backward instances (CE, sub chain) launched at protocol shape: latent
# render, mid render and exposure-flow pass, alpha-only, flow-on mid render;
# the forward's add get_flow_static's (CE=4) and the default render
BWD_INSTANCES = ((9, False), (11, True), (2, False), (29, True))
FWD_INSTANCES = ((2, False), (4, False), (9, False), (11, False), (11, True), (29, True))
PROTOCOL_TILES = 576
REPLACES = {"raster_fwd": "mobgs_tpu/ops/pallas_raster.py:118",
            "raster_fwd_sub": "mobgs_tpu/ops/pallas_raster.py:151",
            "raster_bwd": "mobgs_tpu/ops/pallas_raster.py:203",
            "raster_bwd_sub": "mobgs_tpu/ops/pallas_raster.py:285"}


def flow_err(k, p):
    """Max abs difference of two flow composites, over their tolerance."""
    return float((k - p).abs().max()) / (IMG_ATOL * max(1.0, float(p.abs().max())))


def launch_delta(before):
    """Instance launches since the snapshot ``before``."""
    from mobgs_tpu_torch.ops import cuda_raster
    return {k: v - before.get(k, 0) for k, v in cuda_raster.instance_launches.items()
            if v != before.get(k, 0)}


def recording_controller(real, out):
    """``densify.control_gaussians`` that first records, at each densify
    round, the pool's mean gradient norms, its live mask and its
    threshold (numpy), keyed by (iteration, is_dynamic)."""
    def controller(state, stats, opt_state, key, iteration, flag, opt_cfg,
                   scene_extent, is_dynamic, **kw):
        if (opt_cfg.densify_from_iter < iteration < opt_cfg.densify_until_iter
                and iteration % opt_cfg.densification_interval == 0
                and (is_dynamic or flag < opt_cfg.desicnt)):
            g = torch.nan_to_num(stats.xyz_grad_accum
                                 / torch.clamp(stats.denom, min=1e-12))
            thr = opt_cfg.densify_grad_threshold * (0.5 if is_dynamic else 1.0)
            out[(iteration, is_dynamic)] = (g.cpu().numpy(), state.live.cpu().numpy(), thr)
        return real(state, stats, opt_state, key, iteration, flag, opt_cfg,
                    scene_extent, is_dynamic, **kw)
    return controller


def composite_plain64():
    """A stand-in for ``cuda_raster.composite_plain`` whose sums run in
    float64, forward and backward, with outputs and gradients cast back to
    float32: the reference for walks deep enough that float32 rounding
    shows in the gradients."""
    from mobgs_tpu_torch.ops import cuda_raster

    class Composite64(torch.autograd.Function):
        @staticmethod
        def forward(ctx, ids, counts, rec, col, ntx, sub):
            out, out2 = cuda_raster.composite_tiles_plain(ids, counts, rec.double(),
                                                          col.double(), ntx, sub)
            ctx.save_for_backward(ids, counts, rec, col, out, out2)
            ctx.ntx, ctx.sub = ntx, sub
            return (out.float(), out2.float()) if sub else out.float()

        @staticmethod
        def backward(ctx, g, g2=None):
            ids, counts, rec, col, out, out2 = ctx.saved_tensors
            grad_rec, grad_col = cuda_raster.composite_bwd_plain(
                ids, counts, rec.double(), col.double(), out, out2, g.double(),
                None if g2 is None else g2.double(), ctx.ntx, ctx.sub)
            return None, None, grad_rec.float(), grad_col.float(), None, None

    def plain64(ids, counts, rec, col, ntx, sub=False):
        res = Composite64.apply(ids, counts, rec, col, ntx, sub)
        return res if sub else (res, None)
    return plain64


def raster_fwd_cost(ids_, cnt_, rec, col, sub, ntx_):
    """Operations and bytes the forward needs on these inputs."""
    from mobgs_tpu_torch.ops import cuda_raster
    work = {}
    with torch.no_grad():
        cuda_raster.composite_tiles_plain(ids_, cnt_, rec, col, ntx_, sub,
                                          work=work)
    T_, CE = ids_.shape[0], col.shape[1]
    pairs = int(work["slots"].sum()) * cuda_raster.P
    # per live (slot, pixel) pair: dx, dy, sigma (11), exp (1), alpha (2),
    # transmittance (2); per kept pair: weight (2) and CE multiply-adds
    ops = pairs * 16 + int(work["valid"]) * (2 + 2 * CE)
    n_ref = int(work["n_ref"])
    bytes_ = 4 * (int(work["slots"].sum()) + T_ + n_ref * (6 + CE) + T_ * 256 * CE)
    if sub:
        ops += pairs * 4 + int(work["valid_sub"]) * 3
        bytes_ += 4 * (n_ref + T_ * 256)
    return ops, bytes_, pairs, work


def raster_bwd_cost(ids_, cnt_, rec, col, sub, ntx_):
    """Operations and bytes the backward needs on these inputs."""
    from mobgs_tpu_torch.ops import cuda_raster
    _, _, pairs, work = raster_fwd_cost(ids_, cnt_, rec, col, sub, ntx_)
    T_, CE = ids_.shape[0], col.shape[1]
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
    bytes_ = 4 * (int(work["slots"].sum()) + T_ + n_ref * (rows + CE)
                  + 2 * T_ * 256 * CE + N_all * (cuda_raster.R + CE)
                  + 2 * n_ref * (rows + CE))
    if sub:
        # the subset chain: alpha and transmittance per live pair, 14 per
        # kept pair and its sum over pixels; out2 and g2 read once
        ops += pairs * 4 + int(work["valid_sub"]) * 15
        bytes_ += 4 * 2 * T_ * 256
    return ops, bytes_, pairs, work


def bound(ops, bytes_):
    """The least time for the work: operations over the float32 peak or
    bytes over the memory rate, whichever is longer (ms)."""
    return max(ops / PEAK_F32, bytes_ / PEAK_BYTES) * 1e3


def bound_by(ops, bytes_):
    return "operations" if ops / PEAK_F32 >= bytes_ / PEAK_BYTES else "bytes"


def synced(fn, record):
    """``fn`` run between two device synchronisations; ``record(seconds,
    result)`` after each call."""
    def wrapper(*a, **kw):
        torch.cuda.synchronize()
        t = time.time()
        res = fn(*a, **kw)
        torch.cuda.synchronize()
        record(time.time() - t, res)
        return res
    return wrapper


@contextlib.contextmanager
def replaced(*patches):
    """Each ``(module, name, value)`` set for the block, restored after."""
    reals = [getattr(m, n) for m, n, _ in patches]
    for m, n, v in patches:
        setattr(m, n, v)
    try:
        yield
    finally:
        for (m, n, _), real in zip(patches, reals):
            setattr(m, n, real)


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


def cli_phase(dev, card, times, rates):
    """Phase 17: ``python -m mobgs_tpu_torch.cli.train`` as a user runs it,
    through its ``main``, at seesaw's full width; then its artifacts, TTO
    through the kernels against the plain route, and a resume."""
    from mobgs_tpu_torch.cli import train as cli
    from mobgs_tpu_torch.data import synthetic
    from mobgs_tpu_torch.data.cameras import Camera
    from mobgs_tpu_torch.eval.align import align_test_poses
    from mobgs_tpu_torch.eval.tto import make_tto
    from mobgs_tpu_torch.io import ply, torch_ckpt
    from mobgs_tpu_torch.models import render as R
    from mobgs_tpu_torch.ops import cuda_raster
    from mobgs_tpu_torch.ops.rasterize import RasterConfig

    shutil.rmtree(CLI_OUT, ignore_errors=True)
    argv = ["--configs", os.path.join(ROOT, "configs", "stereo", "seesaw.py"), "--synthetic", "--synthetic_size",
            f"{W}x{H}x{FRAMES}", "--test_iterations", str(CLI_EVAL_EVERY), "--eval_tto",
            "--quiet", "-m", CLI_OUT]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    cuda_raster.reset_launches()
    t0 = time.time()
    ts, hist = cli.main(argv + ["--iterations", str(CLI_ITERS)])
    torch.cuda.synchronize()
    cli_s = time.time() - t0
    launches, instances = dict(cuda_raster.launches), dict(cuda_raster.instance_launches)
    peak = torch.cuda.max_memory_allocated(dev)
    times["cli_s"] = cli_s
    rates["cli_loop_it_s"] = CLI_ITERS / hist[-1]["elapsed"]
    print(f"train CLI: {cli_s:.2f} s for {CLI_ITERS} iterations ({W}x{H}x{FRAMES}, seesaw: "
          f"{ts.stat.capacity} + {ts.dyn.capacity} slots, B=2, E=9, flow off, evals with 5 "
          f"TTO steps at {CLI_EVAL_EVERY} and {CLI_ITERS}), on {card}")
    print(f"train CLI loop: {rates['cli_loop_it_s']:.3f} it/s over {CLI_ITERS} iterations "
          f"(the loop's clock: the evals, the debug dump and the best checkpoints inside), "
          f"on {card}")
    print(f"train CLI launches by kernel instance: {json.dumps(instances)}, on {card}")
    print(f"train CLI peak device memory: {peak / 2**30:.3f} GiB "
          f"(torch.cuda.max_memory_allocated), on {card}")
    require(all(launches[k] > 0 for k in launches), f"train CLI launches {launches}")

    # the files, as the JAX CLI writes them
    def load(name):
        with open(f"{CLI_OUT}/{name}") as f:
            return json.load(f)
    hist_file, curve = load("history.json"), load("eval_curve.json")
    # the CLI logs every 50 iterations and at the last (cli/train.py:412)
    require([h["iter"] for h in hist_file] == [CLI_ITERS]
            and all(np.isfinite(h["loss"]) for h in hist_file), f"history.json {hist_file}")
    require([e["iter"] for e in curve] == [CLI_EVAL_EVERY, CLI_ITERS]
            and all(np.isfinite(e["test_psnr"]) for e in curve), f"eval_curve.json {curve}")
    require(load("cfg_args.json")["iterations"] == CLI_ITERS, "cfg_args.json")
    for tag in (str(CLI_ITERS), "best"):
        for name in CLI_CKPT_FILES:
            require(os.path.exists(f"{CLI_OUT}/point_cloud/iteration_{tag}/{name}"),
                    f"iteration_{tag}/{name}")
    require(os.path.exists(f"{CLI_OUT}/fine_debug/iter_000001.png"), "fine_debug")
    print(f"train CLI files: history {json.dumps(hist_file[-1]['loss'])} loss at "
          f"{CLI_ITERS}; eval curve {json.dumps(curve)}")

    # the PLYs and the decoder read back render as the final state does
    ck = f"{CLI_OUT}/point_cloud/iteration_{CLI_ITERS}"
    data, _ = synthetic.generate(width=W, height=H, num_frames=FRAMES, device=dev)
    rcfg = RasterConfig(tiles_per_gauss=hist[-1]["tiles_per_gauss"],
                        max_per_tile=hist[-1]["max_per_tile"])
    cam0 = Camera(w2c=torch.as_tensor(data.w2c[0], device=dev),
                  K=torch.as_tensor(data.K[0], device=dev),
                  time=torch.tensor(float(data.time[0]), device=dev))
    bg = torch.zeros(3, device=dev)
    dyn_r = ply.load_gaussians(f"{ck}/point_cloud.ply", device=dev)
    stat_r = ply.load_gaussians(f"{ck}/point_cloud_static.ply", device=dev)
    sw_r = ply.load_sandwich_pt(f"{ck}/point_cloud.pt", device=dev)
    require((int(stat_r.num_live()), int(dyn_r.num_live()))
            == (int(ts.stat.num_live()), int(ts.dyn.num_live())), "PLY live counts")
    with torch.no_grad():
        img_a = R.render_view(ts.stat, ts.dyn, ts.sandwich, cam0, W, H, bg,
                              data.max_time, config=rcfg).image
        img_b = R.render_view(stat_r, dyn_r, sw_r, cam0, W, H, bg, data.max_time,
                              config=rcfg).image
    ply_err = float((img_a - img_b).abs().max())
    require(ply_err <= IMG_ATOL, f"the PLY round trip's render differs by {ply_err}")
    blce_r = torch_ckpt.load_blce_pth(f"{ck}/blce.pth", device=dev)
    require(all(torch.equal(a, b) for a, b in zip(blce_r.params.leaves(),
                                                   ts.blce.params.leaves()))
            and torch.equal(blce_r.exposure_expo, ts.blce.exposure_expo), "blce.pth reload")
    print(f"PLY round trip: render of view 0 from the PLYs within {ply_err:.3g} of the final "
          f"state's; blce.pth reloads bit-equal")

    # one eval as the CLI runs it: align, then 5 TTO steps on every test view
    # at the aligned and at the raw poses (at the loop's last budgets)
    def on(x):
        return torch.as_tensor(np.asarray(x), dtype=torch.float32, device=dev)
    test = [on(x) for x in (data.test_w2c, data.K, data.time, data.test_images)]
    ones = torch.ones(FRAMES, device=dev)

    def one_eval():
        aligned = align_test_poses(ts.blce, on(data.w2c), test[0], on(data.blur_feats))
        tto = make_tto(ts.stat, ts.dyn, ts.sandwich, W, H, data.max_time, steps=5,
                       raster_cfg=rcfg)
        return tto(aligned, *test[1:], ones).psnr, tto(*test, ones).psnr
    one_eval()
    torch.cuda.synchronize()
    t0 = time.time()
    one_eval()
    torch.cuda.synchronize()
    times["cli_eval_ms"] = 1e3 * (time.time() - t0)
    print(f"one eval (align + 5 TTO steps on {FRAMES} test views, aligned and raw): "
          f"{times['cli_eval_ms']:.1f} ms, on {card}")

    # TTO through the kernels and through the plain route
    res = {}
    for backend in ("cuda", "plain"):
        tto = make_tto(ts.stat, ts.dyn, ts.sandwich, W, H, data.max_time, steps=5,
                       raster_cfg=rcfg._replace(backend=backend))
        res[backend] = tto(*(x[:2] for x in test), ones[:2])
    k, p = res["cuda"], res["plain"]
    pose_err = float((k.w2c - p.w2c).abs().max())
    psnr_err = float((k.psnr - p.psnr).abs().max())
    print(f"TTO (5 steps, 2 test views) kernels vs plain: pose {pose_err:.3g}, PSNR "
          f"{psnr_err:.3g} dB; PSNR {k.psnr.tolist()}")
    require(pose_err <= TTO_POSE_ATOL, f"TTO poses {pose_err}")
    require(psnr_err <= TTO_PSNR_ATOL, f"TTO PSNR {psnr_err}")
    require(float((k.w2c - test[0][:2]).abs().max()) > 0.0, "TTO moved no pose")
    del ts

    # a resume from the final checkpoint splices the history
    t0 = time.time()
    _, hist_r = cli.main(argv + ["--iterations", str(CLI_RESUME_ITERS), "--start_checkpoint",
                                 f"{ck}/train_state.npz"])
    times["cli_resume_s"] = time.time() - t0
    spliced = load("history.json")
    require([h["iter"] for h in spliced] == [CLI_ITERS, CLI_RESUME_ITERS]
            and spliced[0] == hist_file[0] and np.isfinite(spliced[-1]["loss"]),
            f"resumed history {[h['iter'] for h in spliced]}")
    print(f"resume from iteration {CLI_ITERS} to {CLI_RESUME_ITERS}: "
          f"{times['cli_resume_s']:.2f} s; history.json iterations "
          f"{[h['iter'] for h in spliced]}, the first entry the first run's")



def write_stereo_scene(root, data, traj, seed=0):
    """A DyBluRF-stereo scene directory (``data/stereo.py``'s layout) from the
    generator's scene: ``poses_bounds.npy`` (the inverse of the loader's
    ``_llff_to_c2w``: even rows the blurry train cameras, odd rows the sharp
    test cameras, hwf focal = fx * 720/288), ``scene.json`` (centre 0),
    the blurry frames, the sharp test frames, the depths, the motion masks,
    and ``bootstapir/`` tracks: per query frame STEREO_TRACKS points on the
    dynamic trajectories (a rigid offset of a ground-truth Gaussian each),
    projected into every frame, visible and confident where in front of the
    camera and inside the image."""
    rng = np.random.default_rng(seed)
    V = data.w2c.shape[0]
    for d in ("images_512x288", "inference_images", "align_uni_depth_noclip",
              "motion_masks_manual", "bootstapir"):
        os.makedirs(os.path.join(root, d), exist_ok=True)
    fx = float(data.K[0, 0, 0])
    rows = []
    for w2c in np.stack([data.w2c, data.test_w2c], 1).reshape(2 * V, 4, 4):
        m = np.linalg.inv(w2c.astype(np.float64)) @ np.diag([1.0, -1.0, -1.0, 1.0])
        llff = np.stack([-m[:3, 1], m[:3, 0], m[:3, 2], m[:3, 3],
                         np.array([720.0, 1280.0, fx * 720 / 288])], -1)
        rows.append(np.concatenate([llff.reshape(15), [0.1, 100.0]]))
    np.save(os.path.join(root, "poses_bounds.npy"), np.stack(rows))
    with open(os.path.join(root, "scene.json"), "w") as f:
        json.dump({"center": [0.0, 0.0, 0.0]}, f)

    for i in range(V):
        png(os.path.join(root, "images_512x288", f"{i:05d}.png"), data.images[i])
        png(os.path.join(root, "inference_images", f"{i:05d}.png"), data.test_images[i])
        png(os.path.join(root, "motion_masks_manual", f"{i:05d}.png"), data.masks[i])
        np.save(os.path.join(root, "align_uni_depth_noclip", f"{i:05d}.npy"),
                data.depths[i].astype(np.float32))
    K = data.K[0]
    for q in range(V):
        pick = rng.integers(0, traj.shape[0], STEREO_TRACKS)
        pts = traj[pick] + rng.normal(0, 0.05, (STEREO_TRACKS, 1, 3)).astype(np.float32)
        for t in range(V):
            cam = pts[:, t] @ data.w2c[t][:3, :3].T + data.w2c[t][:3, 3]
            z = np.maximum(cam[:, 2], 1e-6)
            u = K[0, 0] * cam[:, 0] / z + K[0, 2] - 0.5  # pixel-centre coordinates
            v = K[1, 1] * cam[:, 1] / z + K[1, 2] - 0.5
            seen = (cam[:, 2] > 0) & (u >= 0) & (u <= W - 1) & (v >= 0) & (v <= H - 1)
            occlusion = np.where(seen, -10.0, 10.0)
            tracks = np.stack([u, v, occlusion, np.full_like(u, -10.0)], -1)
            np.save(os.path.join(root, "bootstapir", f"{q:05d}_{t:05d}.npy"),
                    tracks.astype(np.float32))


def stereo_phase(dev, card, times):
    """Phase 18: a user's whole run on a DyBluRF stereo scene, ``train.sh``
    and ``eval.sh`` through the port's entry points: the train CLI with
    ``-s`` (loader, warm stage, training), the eval CLI (alignment, TTO,
    refined renders, poses) and the metrics CLI; TTO through the kernels
    against the plain route; LPIPS and SSIM on the card against the CPU."""
    from mobgs_tpu_torch.cli import eval_cli, metrics_cli
    from mobgs_tpu_torch.cli import train as cli
    from mobgs_tpu_torch.config import load_scene_config
    from mobgs_tpu_torch.core.image import ssim
    from mobgs_tpu_torch.data import stereo, synthetic
    from mobgs_tpu_torch.eval import lpips, pose_metrics, tto
    from mobgs_tpu_torch.io import ply
    from mobgs_tpu_torch.ops import cuda_raster
    from mobgs_tpu_torch.ops.rasterize import RasterConfig
    from mobgs_tpu_torch.train import warm
    from PIL import Image

    seesaw = os.path.join(ROOT, "configs", "stereo", "seesaw.py")
    shutil.rmtree(STEREO_ROOT, ignore_errors=True)
    scene, out = os.path.join(STEREO_ROOT, "scene"), os.path.join(STEREO_ROOT, "out")
    t0 = time.time()
    data, traj = synthetic.generate(width=W, height=H, num_frames=FRAMES, device=dev)
    write_stereo_scene(scene, data, traj)
    times["stereo_write_s"] = time.time() - t0

    # the loader's scene is the generator's, translations over the mean depth
    loaded = stereo.load_stereo_scene(scene).data
    mean_depth = float(np.mean(data.depths))
    for split in ("w2c", "test_w2c"):
        a, b = getattr(loaded, split), getattr(data, split)
        rot = float(np.abs(a[:, :3, :3] - b[:, :3, :3]).max())
        trans = float(np.abs(a[:, :3, 3] * mean_depth - b[:, :3, 3]).max())
        require(rot <= 1e-5 and trans <= 1e-4, f"stereo {split}: rotations {rot}, "
                f"translations x mean depth {trans}")
    focal = abs(float(loaded.K[0, 0, 0]) / float(data.K[0, 0, 0]) - 1)
    require(focal <= 1e-5 and loaded.images.shape == (FRAMES, H, W, 3), f"stereo focal {focal}")
    print(f"stereo scene: {FRAMES} frames at {W}x{H}, {STEREO_TRACKS} tracks a query, mean "
          f"depth {mean_depth:.4f}; loaded cameras = the generator's (rotations within "
          f"{rot:.3g}, translations x mean depth {trans:.3g}, focal {focal:.3g}); written in "
          f"{times['stereo_write_s']:.2f} s")

    # train.sh: the loader and the warm stage timed inside the CLI
    seen = {}

    def record(key):
        return lambda sec, res: seen.__setitem__(key, (sec, res))

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    cuda_raster.reset_launches()
    t0 = time.time()
    with replaced(*[(m, n, synced(getattr(m, n), record(n)))
                    for m, n in ((stereo, "load_stereo_scene"), (warm, "warm_init"))]):
        ts, hist = cli.main(["-s", scene, "--configs", seesaw, "--iterations", str(STEREO_ITERS), "--test_iterations",
                             str(STEREO_ITERS), "--quiet", "-m", out])
        torch.cuda.synchronize()
    times["stereo_train_s"] = time.time() - t0
    train_launches = dict(cuda_raster.instance_launches)
    kernel_launches = dict(cuda_raster.launches)
    pc = seen["warm_init"][1]
    times["stereo_load_s"], times["stereo_warm_s"] = seen["load_stereo_scene"][0], \
        seen["warm_init"][0]
    opt = load_scene_config(seesaw).opt
    require(len(pc.stat_points) == opt.stat_npts and len(pc.dyn_points) == opt.dyn_npts
            and pc.dyn_trajectory.shape == (opt.dyn_npts, FRAMES, 3)
            and np.isfinite(pc.dyn_trajectory).all(), "warm-stage clouds")
    require([h["iter"] for h in hist] == [STEREO_ITERS] and np.isfinite(hist[-1]["loss"]),
            f"stereo history {hist}")
    print(f"stereo train CLI: {times['stereo_train_s']:.2f} s for {STEREO_ITERS} iterations "
          f"(seesaw: B=2, E=9, flow off, {ts.stat.capacity} + {ts.dyn.capacity} slots, an eval "
          f"at {STEREO_ITERS}); loader {times['stereo_load_s']:.2f} s, warm init "
          f"{times['stereo_warm_s']:.2f} s ({len(pc.stat_points)} static + "
          f"{len(pc.dyn_points)} dynamic seeds), loss {hist[-1]['loss']:.5f}, budgets "
          f"tiles_per_gauss {hist[-1]['tiles_per_gauss']} max_per_tile "
          f"{hist[-1]['max_per_tile']}, on {card}")
    del ts

    # eval.sh: the eval CLI, its TTO timed
    tto_time = {}
    make_tto = tto.make_tto
    cuda_raster.reset_launches()
    t0 = time.time()
    with replaced((tto, "make_tto", lambda *a, **kw: synced(
            make_tto(*a, **kw), lambda sec, _: tto_time.__setitem__("s", sec)))):
        res = eval_cli.main(["-s", scene, "-m", out, "--iteration", "best", "--tto_steps",
                             str(STEREO_TTO_STEPS), "--tto_decay_start",
                             str(STEREO_TTO_STEPS // 2)])
        torch.cuda.synchronize()
    times["stereo_eval_s"] = time.time() - t0
    eval_launches = dict(cuda_raster.instance_launches)
    refined = sorted(os.listdir(os.path.join(out, "test_refined")))
    solved = np.load(os.path.join(out, "solved_poses.npy"))
    require(len(refined) == FRAMES and all(n.endswith(".png.png") for n in refined),
            f"test_refined {refined}")
    require(solved.shape == (FRAMES, 4, 4) and np.isfinite(solved).all(), "solved_poses.npy")
    poses = pose_metrics.evaluate_poses(np.linalg.inv(loaded.test_w2c), np.linalg.inv(solved))
    require(all(np.isfinite(v) for v in poses.values()), f"pose metrics {poses}")
    tto_view_ms = 1e3 * tto_time["s"] / FRAMES
    print(f"stereo eval CLI: {times['stereo_eval_s']:.2f} s ({STEREO_TTO_STEPS} TTO steps on "
          f"{FRAMES} test views; one TTO view {tto_view_ms:.1f} ms); mean PSNR "
          f"{float(res.psnr.mean()):.4f}; poses {json.dumps(poses)}, on {card}")

    # TTO through the kernels and through the plain route, on the checkpoint
    ck = os.path.join(out, "point_cloud", "iteration_best")
    dyn_r = ply.load_gaussians(f"{ck}/point_cloud.ply", device=dev)
    stat_r = ply.load_gaussians(f"{ck}/point_cloud_static.ply", device=dev)
    sw_r = ply.load_sandwich_pt(f"{ck}/point_cloud.pt", device=dev)
    test = [torch.as_tensor(x[:2], dtype=torch.float32, device=dev)
            for x in (loaded.test_w2c, loaded.K, loaded.time, loaded.test_images)]
    runs = {}
    for backend in ("cuda", "plain"):
        runs[backend] = tto.make_tto(stat_r, dyn_r, sw_r, W, H, loaded.max_time, steps=5,
                                     raster_cfg=RasterConfig(backend=backend))(
            *test, torch.ones(2, device=dev))
    k, p = runs["cuda"], runs["plain"]
    pose_err = float((k.w2c - p.w2c).abs().max())
    psnr_err = float((k.psnr - p.psnr).abs().max())
    print(f"stereo TTO (5 steps, 2 test views) kernels vs plain: pose {pose_err:.3g}, PSNR "
          f"{psnr_err:.3g} dB; PSNR {k.psnr.tolist()}")
    require(pose_err <= TTO_POSE_ATOL and psnr_err <= TTO_PSNR_ATOL,
            f"stereo TTO kernels vs plain: pose {pose_err}, PSNR {psnr_err}")
    require(float((k.w2c - test[0]).abs().max()) > 0.0, "stereo TTO moved no pose")

    # eval.sh's metrics CLI
    t0 = time.time()
    metrics_cli.main(["-s", scene, "-m", out])
    torch.cuda.synchronize()
    times["stereo_metrics_s"] = time.time() - t0
    with open(os.path.join(out, "results.json")) as f:
        report = json.load(f)
    require(report["n_frames"] == FRAMES and all(
        np.isfinite(report[k]) for k in ("psnr", "ssim", "lpips_randfeat")), f"results {report}")
    require(report.get("tof") is None or np.isfinite(report["tof"]), f"tOF {report.get('tof')}")
    print(f"stereo metrics CLI: {times['stereo_metrics_s']:.2f} s; results.json "
          f"{json.dumps({k: v for k, v in report.items() if k != 'per_frame_psnr'})} (tOF "
          f"{'from OpenCV' if report.get('tof') is not None else 'null: cv2 does not import'}),"
          f" on {card}")

    # LPIPS and SSIM of the same images, on the card and on the CPU
    preds = np.stack([np.asarray(Image.open(os.path.join(out, "test_refined", n)))[..., :3]
                      for n in refined]).astype(np.float32) / 255
    gts = loaded.test_images
    errs = {}
    for name, fn in (
            ("lpips", lambda d: lpips.lpips_distance(
                lpips.load_lpips(device=d), *(2 * torch.as_tensor(x, device=d).permute(
                    0, 3, 1, 2) - 1 for x in (preds, gts)))),
            ("ssim", lambda d: ssim(*(torch.as_tensor(x, device=d).permute(0, 3, 1, 2)
                                      for x in (preds, gts)), size_average=False))):
        card_v, cpu_v = fn(dev).cpu(), fn("cpu")
        errs[name] = float((card_v - cpu_v).abs().max())
        require(errs[name] <= STEREO_METRIC_ATOL, f"{name} card vs CPU {errs[name]}")
    print(f"stereo LPIPS / SSIM card vs CPU ({FRAMES} frames): max abs diff {json.dumps(errs)}")

    peak = torch.cuda.max_memory_allocated(dev)
    require(all(kernel_launches.get(k, 0) > 0 for k in REPLACES),
            f"stereo train launches {kernel_launches}")
    require(eval_launches.get("raster_fwd CE=11", 0) > 0
            and eval_launches.get("raster_bwd CE=11", 0) > 0, f"eval launches {eval_launches}")
    print(f"stereo launches by kernel instance: train {json.dumps(train_launches)}; eval CLI "
          f"{json.dumps(eval_launches)}, on {card}")
    print(f"stereo seconds: loader {times['stereo_load_s']:.2f}, warm init "
          f"{times['stereo_warm_s']:.2f}, training (the train CLI) "
          f"{times['stereo_train_s']:.2f}, eval CLI {times['stereo_eval_s']:.2f}, metrics CLI "
          f"{times['stereo_metrics_s']:.2f}; peak device memory {peak / 2**30:.3f} GiB "
          f"(torch.cuda.max_memory_allocated), on {card}")



def png(path, img):
    from PIL import Image
    Image.fromarray((np.clip(img, 0, 1) * 255).round().astype(np.uint8)).save(path)


def write_iphone_scene(root, dev):
    """A dycheck iPhone scene directory (``data/iphone.py``'s layout) from the
    generator, at the published 2x resolution, 360x480 (W x H): the generator
    renders 392x512 frames and each is cropped at (20, 24), so the principal
    point sits off the centre at (176, 232) and the images agree with it.
    ``scene.json`` holds scale 0.5 (the loader multiplies depths and camera
    positions by it), so the files hold depths and positions over 0.5.
    Camera 0 has the REG_FRAMES blurry train frames; camera 1 the sharp
    frames at the same times (the ``val`` split). Cameras at 1x (720x960)
    with a skew entry. Depths with the background filled at 1.5x the frame's
    farthest depth (a depth sensor sees a wall, not nothing). Returns the
    generator's data, cropped."""
    from mobgs_tpu_torch.data import synthetic
    gw, gh = IPHONE_W + 32, IPHONE_H + 32
    x0, y0 = 20, 24
    data, _ = synthetic.generate(width=gw, height=gh, num_frames=REG_FRAMES, device=dev)

    def crop(a):
        return a[:, y0:y0 + IPHONE_H, x0:x0 + IPHONE_W]

    for d in ("rgb/2x", "depth/2x", "camera", "splits", "motion_masks"):
        os.makedirs(os.path.join(root, d), exist_ok=True)
    scale = 0.5
    with open(os.path.join(root, "scene.json"), "w") as f:
        json.dump({"scale": scale, "center": [0.0, 0.0, 0.0], "near": 0.1, "far": 50.0}, f)
    val_t = list(range(REG_FRAMES))
    with open(os.path.join(root, "splits", "train.json"), "w") as f:
        json.dump({"time_ids": list(range(REG_FRAMES)), "camera_ids": [0] * REG_FRAMES}, f)
    with open(os.path.join(root, "splits", "val.json"), "w") as f:
        json.dump({"time_ids": val_t, "camera_ids": [1] * len(val_t)}, f)
    with open(os.path.join(root, "dataset.json"), "w") as f:
        json.dump({"count": REG_FRAMES, "num_exemplars": REG_FRAMES}, f)
    fx = float(data.K[0, 0, 0])
    pp = np.array([gw / 2 - x0, gh / 2 - y0])
    images, depths, masks, tests = (crop(data.images), crop(data.depths), crop(data.masks),
                                    crop(data.test_images))

    def camera(cam, t, w2c):
        R = w2c[:3, :3].astype(np.float64)
        with open(os.path.join(root, "camera", f"{cam}_{t:05d}.json"), "w") as f:
            json.dump({"orientation": R.tolist(),
                       "position": (-R.T @ w2c[:3, 3] / scale).tolist(),
                       "focal_length": 2 * fx, "principal_point": (2 * pp).tolist(),
                       "skew": IPHONE_SKEW, "pixel_aspect_ratio": 1.0,
                       "radial_distortion": [0.0, 0.0, 0.0],
                       "tangential_distortion": [0.0, 0.0],
                       "image_size": [2 * IPHONE_W, 2 * IPHONE_H]}, f)

    for t in range(REG_FRAMES):
        name = f"0_{t:05d}"
        png(os.path.join(root, "rgb", "2x", name + ".png"), images[t])
        png(os.path.join(root, "motion_masks", name + ".png"), masks[t])
        dep = np.where(depths[t] > 0, depths[t], 1.5 * depths[t].max())
        np.save(os.path.join(root, "depth", "2x", name + ".npy"),
                (dep / scale).astype(np.float32))
        camera(0, t, data.w2c[t])
    for t in val_t:
        png(os.path.join(root, "rgb", "2x", f"1_{t:05d}.png"), tests[t])
        camera(1, t, data.test_w2c[t])
    return data._replace(images=images, depths=depths, masks=masks, test_images=tests,
                         width=IPHONE_W, height=IPHONE_H), pp


def write_blender_scene(root, dev):
    """A D-NeRF-style Blender scene directory (``data/scene.py::
    load_blender_scene``'s layout) from the generator at 800x800:
    ``transforms_train.json`` with REG_FRAMES blurry frames and
    ``transforms_test.json`` with as many sharp ones, each frame an RGBA PNG
    whose alpha is the generator's alpha and whose colour is the generator's
    image over that alpha (so the loader's black-background composite gives
    the image back), a Blender-convention ``transform_matrix`` (camera to
    world, y and z axes flipped) and its ``time``; ``camera_angle_x`` from the
    generator's focal length."""
    from mobgs_tpu_torch.data import synthetic
    data, _, (alpha, alpha_sharp) = synthetic.generate(
        width=BLENDER_W, height=BLENDER_W, num_frames=REG_FRAMES, device=dev,
        return_alpha=True)
    fx = float(data.K[0, 0, 0])
    for split in ("train", "test"):
        os.makedirs(os.path.join(root, split), exist_ok=True)
    for split in ("train", "test"):
        imgs, w2cs, a = ((data.images, data.w2c, alpha) if split == "train"
                         else (data.test_images, data.test_w2c, alpha_sharp))
        frames = []
        for i in range(REG_FRAMES):
            rgb = imgs[i] / np.maximum(a[i], 1e-6)[..., None]
            png(os.path.join(root, split, f"r_{i:03d}.png"),
                np.concatenate([rgb, a[i][..., None]], -1))
            c2w = np.linalg.inv(w2cs[i].astype(np.float64))
            c2w[:3, 1:3] *= -1
            frames.append({"file_path": f"./{split}/r_{i:03d}", "time": float(data.time[i]),
                           "transform_matrix": c2w.tolist()})
        with open(os.path.join(root, f"transforms_{split}.json"), "w") as f:
            json.dump({"camera_angle_x": 2 * float(np.arctan(0.5 * BLENDER_W / fx)),
                       "frames": frames}, f)
    return data


def registry_phase(dev, card, times, protocol, trace):
    """Phase 19: the train CLI's registry branch on a dycheck iPhone scene
    (360x480) and a D-NeRF Blender scene (800x800) written from the
    generator, each as a user runs it (``python -m mobgs_tpu_torch.cli.train
    -s <scene> --eval_tto``, the defaults of ``Config``: flow on, E=9, B=1,
    40,000 + 20,000 depth seeds), for REG_ITERS iterations; the four kernels
    against their plain versions at one view of each run's final state; the
    camera-shared static pool against the unshared step on the iPhone run's
    state and on the protocol scene, timed over SHARED_STEPS steps and one
    step of each traced with ``trace`` (device busy time by kernel name).
    Returns the kernels' launches over the two runs."""
    from mobgs_tpu_torch.cli import train as cli
    from mobgs_tpu_torch.config import Config
    from mobgs_tpu_torch.data import scene as scene_mod
    from mobgs_tpu_torch.data.cameras import Camera
    from mobgs_tpu_torch.eval import tto
    from mobgs_tpu_torch.io import checkpoint as ckpt
    from mobgs_tpu_torch.io import ply, torch_ckpt
    from mobgs_tpu_torch.models import gaussians as G
    from mobgs_tpu_torch.models import render as R
    from mobgs_tpu_torch.ops import cuda_raster, tiles
    from mobgs_tpu_torch.ops import rasterize as rasterize_mod
    from mobgs_tpu_torch.ops.rasterize import RasterConfig
    from mobgs_tpu_torch.train import loop as L
    from mobgs_tpu_torch.train import debug_vis
    from mobgs_tpu_torch.train import step as S
    from mobgs_tpu_torch.train import warm

    shutil.rmtree(REG_ROOT, ignore_errors=True)
    launches_total = {}
    finals = {}
    for name, writer, (w, h) in (("iphone", write_iphone_scene, (IPHONE_W, IPHONE_H)),
                                 ("blender", write_blender_scene, (BLENDER_W, BLENDER_W))):
        scene, out = os.path.join(REG_ROOT, name, "scene"), os.path.join(REG_ROOT, name, "out")
        t0 = time.time()
        written = writer(scene, dev)
        times[f"reg_{name}_write_s"] = time.time() - t0
        gen = written[0] if name == "iphone" else written
        # the loaded scene against the generator's
        loaded = scene_mod.load_scene(scene)
        require(loaded.images.shape == (REG_FRAMES, h, w, 3)
                and loaded.test_images.shape == (REG_FRAMES, h, w, 3), f"{name} loaded shapes")
        img_err = float(np.abs(loaded.images - gen.images).max())
        rot = float(np.abs(loaded.w2c[:, :3, :3] - gen.w2c[:, :3, :3]).max())
        # PNG quantisation: half a level, and for the RGBA frames the colour's
        # and the alpha's half levels both
        require(img_err <= (0.51 if name == "iphone" else 1.01) / 255 and rot <= 1e-5,
                f"{name}: images {img_err}, rotations {rot}")
        if name == "iphone":
            pp = written[1]
            require(np.allclose(loaded.K[:, 0, 2], pp[0]) and np.allclose(loaded.K[:, 1, 2], pp[1])
                    and np.all(loaded.K[:, 0, 1] == IPHONE_SKEW),
                    f"iphone intrinsics {loaded.K[0]}")
        print(f"{name} scene: {REG_FRAMES} train + {REG_FRAMES} test frames at {w}x{h} "
              f"({-(-w // 16)}x{-(-h // 16)} tiles), K {np.round(loaded.K[0], 3).tolist()}; "
              f"written in {times[f'reg_{name}_write_s']:.2f} s; loaded frames within "
              f"{img_err:.3g} of the generator's, rotations within {rot:.3g}")

        # the train CLI as a user runs it, its stages timed
        # (module, function, the key its seconds add to); the checkpoint
        # writers and the debug grid run inside the loop too, and the
        # checkpoint seconds are also read when the loop returns
        seen, evals = {}, []
        timers = [(scene_mod, "load_scene", "load"), (warm, "seed_from_depths", "seed"),
                  (L, "train", "train"), (rasterize_mod, "validate_max_per_tile", "validate"),
                  (ckpt, "save_train_state", "ckpt"), (torch_ckpt, "save_blce_pth", "ckpt"),
                  (torch_ckpt, "save_deformation_pth", "ckpt"), (ply, "save_gaussians", "ckpt"),
                  (debug_vis, "dump_debug_images", "debug")]

        def add(key):
            def record(sec, _):
                seen[key] = seen.get(key, 0.0) + sec
                if key == "train":
                    seen["ckpt_in_train"] = seen.get("ckpt", 0.0)
            return record

        make_tto = tto.make_tto
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        cuda_raster.reset_launches()
        t0 = time.time()
        with replaced(*[(m, n, synced(getattr(m, n), add(key))) for m, n, key in timers],
                      (tto, "make_tto", lambda *a, **kw: synced(
                          make_tto(*a, **kw), lambda sec, _: evals.append(sec)))):
            ts, hist = cli.main(["-s", scene, "--iterations", str(REG_ITERS), "--test_iterations",
                                 str(REG_ITERS), "--eval_tto", "--quiet", "-m", out])
            torch.cuda.synchronize()
        total_s = time.time() - t0
        peak = torch.cuda.max_memory_allocated(dev)
        kl, il = dict(cuda_raster.launches), dict(cuda_raster.instance_launches)
        for k, v in kl.items():
            launches_total[k] = launches_total.get(k, 0) + v
        require(all(kl.get(k, 0) > 0 for k in REPLACES), f"{name} launches {kl}")
        last = hist[-1]
        with open(os.path.join(out, "eval_curve.json")) as f:
            curve = json.load(f)
        require([hh["iter"] for hh in hist] == [REG_ITERS] and np.isfinite(last["loss"])
                and last["flow"] > 0, f"{name} history {hist}")
        require([e["iter"] for e in curve] == [REG_ITERS]
                and np.isfinite(curve[0]["test_psnr"]), f"{name} eval curve {curve}")
        n_seed = ts.stat.capacity // 2, ts.dyn.capacity // 2
        require(n_seed == (54_000, 6_000), f"{name} seeds {n_seed}")
        # the checkpoint read back
        ck = os.path.join(out, "point_cloud", f"iteration_{REG_ITERS}", "train_state.npz")
        back = ckpt.flatten_train_state(ckpt.load_train_state(ck, ts))
        mine = ckpt.flatten_train_state(ts)
        require(back.keys() == mine.keys() and all(np.array_equal(back[k], mine[k])
                                                   for k in mine), f"{name} checkpoint")
        # the loop's own seconds: the steps and its host work, without the
        # eval's TTO, the checkpoint written at the eval and the debug grid
        steps_s = (seen["train"] - sum(evals) - seen["ckpt_in_train"]
                   - seen.get("debug", 0.0))
        times.update({f"reg_{name}_{k}": v for k, v in (
            ("cli_s", total_s), ("load_s", seen["load"]), ("seed_s", seen["seed"]),
            ("validate_s", seen["validate"]), ("loop_s", seen["train"]), ("steps_s", steps_s),
            ("eval_s", sum(evals)), ("ckpt_s", seen["ckpt"]),
            ("debug_s", seen.get("debug", 0.0)))})
        print(f"{name} train CLI: {total_s:.2f} s for {REG_ITERS} iterations (Config defaults: "
              f"flow on, B=1, E=9; {ts.stat.capacity} + {ts.dyn.capacity} slots from "
              f"{n_seed[0]} + {n_seed[1]} depth seeds); loader {seen['load']:.2f} s, "
              f"seeding {seen['seed']:.2f} s, budget validation {seen['validate']:.2f} s, "
              f"the loop {seen['train']:.2f} s, of it the steps {steps_s:.2f} s "
              f"({REG_ITERS / max(steps_s, 1e-9):.3f} it/s), the debug grid "
              f"{seen.get('debug', 0.0):.2f} s, the eval's TTO (5 steps) {sum(evals):.2f} s "
              f"({len(evals)} calls: aligned and raw poses) and the best checkpoint "
              f"{seen['ckpt_in_train']:.2f} s; both checkpoints {seen['ckpt']:.2f} s; final loss "
              f"{last['loss']:.5f} flow {last['flow']:.5g}, eval PSNR {curve[0]['test_psnr']:.4f} "
              f"(raw {curve[0]['test_psnr_raw']:.4f}); validated tiles_per_gauss "
              f"{last['tiles_per_gauss']} max_per_tile {last['max_per_tile']} (tile_max "
              f"{last['tile_max']}); peak device memory {peak / 2**30:.3f} GiB; on {card}")
        print(f"{name} launches by kernel instance: {json.dumps(il)}; checkpoint read back equal")

        # the kernels against their plain versions at one view of the run
        data = loaded
        cam = Camera(w2c=torch.as_tensor(data.w2c[0], device=dev),
                     K=torch.as_tensor(data.K[0], device=dev),
                     time=torch.tensor(float(data.time[0]), device=dev))
        cfg = RasterConfig(tiles_per_gauss=last["tiles_per_gauss"],
                           max_per_tile=last["max_per_tile"])
        with torch.no_grad():
            geom, splats = R.assemble_project(ts.stat, ts.dyn, cam, w, h, data.max_time,
                                              config=cfg)
            bins = tiles.bin_gaussians(splats, w, h, tiles_per_gauss=cfg.tiles_per_gauss,
                                       max_per_tile=cfg.max_per_tile)
        ids, cnt, ntx = bins.gauss_ids.contiguous(), bins.counts.contiguous(), bins.n_tiles_x
        N = geom.means.shape[0]
        rng = np.random.default_rng(19)
        col9 = geom.colors.detach().contiguous()
        col29 = torch.cat([geom.colors, torch.as_tensor(
            rng.normal(size=(N, 2 * E_WARP)).astype(np.float32), device=dev),
            splats.depths[:, None], torch.ones(N, 1, device=dev)], 1).detach().contiguous()
        sub_op = (geom.opacity * geom.dyn_mask).detach()
        for label, col, sub in (("CE=9", col9, False), ("CE=29 + sub", col29, True)):
            rec = cuda_raster.pack_records(splats, geom.opacity, sub_op if sub else None).detach()
            with torch.no_grad():
                out, out2 = cuda_raster.composite_fwd(ids, cnt, rec, col, ntx, sub)
                p_out, p_out2 = cuda_raster.composite_tiles_plain(ids, cnt, rec, col, ntx, sub)
            CE = col.shape[1]
            e = {"image": float((out[..., :9] - p_out[..., :9]).abs().max())}
            if sub:
                e.update({"flow/tol": flow_err(out[..., 9:CE - 2], p_out[..., 9:CE - 2]),
                          "depth/tol": flow_err(out[..., CE - 2], p_out[..., CE - 2]),
                          "weight": float((out[..., CE - 1] - p_out[..., CE - 1]).abs().max()),
                          "sub_alpha": float((out2 - p_out2).abs().max())})
            require(e["image"] <= IMG_ATOL and e.get("weight", 0) <= IMG_ATOL
                    and e.get("sub_alpha", 0) <= IMG_ATOL and e.get("flow/tol", 0) <= 1
                    and e.get("depth/tol", 0) <= 1, f"{name} forward {label} {e}")
            img = cuda_raster._untile(out, ntx, ids.shape[0] // ntx, w, h)
            require(img.shape[:2] == (h, w) and bool(torch.isfinite(img).all()),
                    f"{name} {label} image {tuple(img.shape)}")
            g = torch.as_tensor(rng.normal(size=out.shape).astype(np.float32), device=dev)
            g2 = (torch.as_tensor(rng.normal(size=out2.shape).astype(np.float32), device=dev)
                  if sub else None)
            args = (ids, cnt, rec, col, out, out2, g, g2, ntx, sub)
            kb = cuda_raster.composite_bwd(*args)
            pb = cuda_raster.composite_bwd_plain(*args)
            torch.cuda.synchronize()
            rel = {j: float((kb[0][:, j] - pb[0][:, j]).abs().max())
                   / max(float(pb[0][:, j].abs().max()), 1e-30) for j in range(7 if sub else 6)}
            rel["colors"] = float((kb[1] - pb[1]).abs().max()) / max(float(pb[1].abs().max()),
                                                                    1e-30)
            require(max(rel.values()) <= BWD_REL, f"{name} backward {label} {rel}")
            with torch.no_grad():
                ms_f = cuda_ms(lambda: cuda_raster.composite_fwd(ids, cnt, rec, col, ntx, sub), 20)
                pms_f = cuda_ms(lambda: cuda_raster.composite_tiles_plain(ids, cnt, rec, col, ntx,
                                                                          sub), 3)
            ms_b = cuda_ms(lambda: cuda_raster.composite_bwd(*args), 20)
            pms_b = cuda_ms(lambda: cuda_raster.composite_bwd_plain(*args), 3)
            of, bf, pairs, work = raster_fwd_cost(ids, cnt, rec, col, sub, ntx)
            ob, bb, _, _ = raster_bwd_cost(ids, cnt, rec, col, sub, ntx)
            print(f"{name} view 0 ({w}x{h}, T={ids.shape[0]}, K={ids.shape[1]}, {pairs} pairs, "
                  f"{int(work['valid'])} kept) {label}: forward vs plain {json.dumps(e)}, "
                  f"backward max |k-p|/max|p| {max(rel.values()):.3g}; forward {ms_f:.4f} ms "
                  f"(plain {pms_f:.3f}, bound {bound(of, bf):.4f} by {bound_by(of, bf)}, "
                  f"{100 * bound(of, bf) / ms_f:.1f} % of bound), backward {ms_b:.4f} ms with the "
                  f"zeroed outputs (plain {pms_b:.3f}, bound {bound(ob, bb):.4f} by "
                  f"{bound_by(ob, bb)}, {100 * bound(ob, bb) / ms_b:.1f} % of bound), on {card}")
        finals[name] = (ts, loaded, cfg)

    # the camera-shared static pool against the unshared step
    ts_p, data_p, cfg_p, opt_p = protocol
    for name, (ts, data, cfg), opt, batch_views in (
            ("iphone", finals["iphone"], None, 1),
            ("protocol", (ts_p(), data_p, cfg_p), opt_p, B_VIEWS)):
        opt = opt or Config().opt
        w, h = data.width, data.height
        ids_b = np.arange(batch_views) * 3 + 1
        batch = L.make_batch(data, ids_b, dev)
        cam = Camera(w2c=batch.w2c[0], K=batch.K[0], time=batch.time[0])
        # the bins and the forward images of the mid render and one flow pass
        with torch.no_grad():
            _, sp = R.assemble_project(ts.stat, ts.dyn, cam, w, h, data.max_time, -1.0, cfg)
            # the flow pass's splats, static rows binned once and the dynamic
            # ones merged, against the binning of the concatenation
            Ms = ts.stat.capacity
            sb = tiles.bin_static(type(sp)(*(x[:Ms] for x in sp)), w, h, cfg.tiles_per_gauss,
                                  cfg.max_per_tile)
            merged = tiles.merge_dyn_bins(sb, type(sp)(*(x[Ms:] for x in sp)), Ms, w, h,
                                          cfg.tiles_per_gauss, cfg.max_per_tile)
            ref = tiles.bin_gaussians(sp, w, h, cfg.tiles_per_gauss, cfg.max_per_tile)
            live = torch.arange(ref.gauss_ids.shape[1], device=dev)[None] < ref.counts[:, None]
            bins_equal = (torch.equal(merged.counts, ref.counts)
                          and int(merged.max_count) == int(ref.max_count)
                          and torch.equal(torch.where(live, merged.gauss_ids, -1),
                                          torch.where(live, ref.gauss_ids, -1)))
            renders = {}
            for mode in (True, False):
                bg = torch.zeros(3, device=dev)
                kw = dict(get_dynamic=True, subset_alpha_only=True, config=cfg,
                          shared=R.make_shared_view(ts.stat, cam, w, h, cfg) if mode else None)
                mid = R.render_view(ts.stat, ts.dyn, ts.sandwich, cam, w, h, bg, data.max_time,
                                    None, **kw)
                flw = R.render_view(ts.stat, ts.dyn, ts.sandwich, cam, w, h, bg, data.max_time,
                                    -1.0, want_depth=False, want_alpha=False, **kw)
                renders[mode] = [mid.image, mid.alpha, mid.depth, mid.d_alpha, flw.image,
                                 flw.d_alpha]
            images_equal = all(torch.equal(a, b) for a, b in zip(renders[True], renders[False]))
        res, steps = {}, {}
        leaves = [*G.split_diff(ts.stat)[0], *G.split_diff(ts.dyn)[0],
                  *S.sandwich_leaves(ts.sandwich),
                  *ts.blce.params.leaves()]
        for mode in (True, False):
            fwd = S.make_forward(opt, w, h, data.max_time, E_WARP, cfg, shared_static=mode)
            off = torch.zeros((batch_views, ts.stat.capacity + ts.dyn.capacity, 2), device=dev,
                              requires_grad=True)
            with torch.enable_grad():
                for p in leaves:
                    p.requires_grad_(True)
                total, aux = fwd(ts.stat, ts.dyn, ts.sandwich, ts.blce, off, batch)
                grads = torch.autograd.grad(total, leaves + [off], allow_unused=True)
            for p in leaves:
                p.requires_grad_(False)
            res[mode] = (float(total.detach()), float(aux["flow"].detach()), grads)
        loss_rel = abs(res[True][0] - res[False][0]) / abs(res[False][0])
        leaf_rel = max(float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
                       for a, b in zip(res[True][2], res[False][2])
                       if b is not None and b.any())
        # device ms per step: CUDA events over 10 steps after 3 warm-up
        for mode in (True, False):
            step = S.make_train_step(opt, w, h, data.max_time, E_WARP, cfg, shared_static=mode)
            sampler = L.BatchSampler(data.w2c.shape[0], batch_views, seed=5)
            for _ in range(SHARED_WARM):
                ts, _ = step(ts, L.make_batch(data, sampler.next_ids(), dev))
            batches = [L.make_batch(data, sampler.next_ids(), dev) for _ in range(SHARED_STEPS)]
            torch.cuda.synchronize()
            cuda_raster.reset_launches()
            start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t0 = time.time()
            start.record()
            for b in batches:
                ts, m = step(ts, b)
            stop.record()
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.time() - t0) / SHARED_STEPS
            launches = dict(cuda_raster.instance_launches)
            b = L.make_batch(data, sampler.next_ids(), dev)
            (ts, _), busy_us = trace(lambda: step(ts, b), f"{name} step, shared_static={mode}")
            steps[mode] = (start.elapsed_time(stop) / SHARED_STEPS, wall_ms, launches,
                           busy_us / 1e3)
        print(f"shared static ({name}: {ts.stat.capacity} + {ts.dyn.capacity} slots, "
              f"{int(ts.stat.num_live())} + {int(ts.dyn.num_live())} live, {w}x{h}, B={batch_views}, "
              f"E={E_WARP}, flow on): loss shared {res[True][0]:.7f} unshared {res[False][0]:.7f} "
              f"(rel {loss_rel:.3g}), worst leaf {leaf_rel:.3g} of its magnitude, bins bit-equal "
              f"{bins_equal}, forward images bit-equal {images_equal}; per step shared "
              f"{steps[True][0]:.2f} ms, unshared {steps[False][0]:.2f} ms on the card's clock "
              f"over {SHARED_STEPS} steps after {SHARED_WARM} (the device waits on the host: the "
              f"wall clock reads {steps[True][1]:.1f} / {steps[False][1]:.1f}); device busy in one "
              f"traced step shared {steps[True][3]:.2f} ms, unshared {steps[False][3]:.2f} ms; "
              f"launches shared {json.dumps(steps[True][2])}, unshared "
              f"{json.dumps(steps[False][2])}; on {card}")
        times[f"shared_{name}_ms"] = steps[True][0]
        times[f"unshared_{name}_ms"] = steps[False][0]
        times[f"shared_{name}_busy_ms"] = steps[True][3]
        times[f"unshared_{name}_busy_ms"] = steps[False][3]
        require(loss_rel <= LOSS_RTOL and leaf_rel <= STEP_REL["stat"],
                f"shared static {name}: loss {loss_rel}, leaves {leaf_rel}")
        require(bins_equal, f"shared static {name}: merged bins differ from bin_gaussians")
        require(images_equal, f"shared static {name}: forward images differ")
        require(steps[True][2] == steps[False][2], f"shared static {name}: launches differ")
    return launches_total


def rel_err(a, b):
    """Max abs difference over the reference's largest magnitude."""
    return float((a.float() - b.float()).abs().max()) / max(float(b.float().abs().max()), 1e-30)


def library_phase(dev, card, times, protocol):
    """Phase 20: the rest of the library on the card. The gsplat shim
    (``compat.rasterization``) at protocol width through the forward and
    backward kernels against the plain route, its launches counted from 0 and
    its instances timed beside their bounds; ``fully_fused_projection``
    bit-equal to ``project``; the deformation field at ModelHiddenParams'
    widths, PoseNet, the depth-volume warps, the KNN constraint and knot
    pruning on the card against the same functions on the CPU, each timed.
    Returns the shim's kernel launches by kernel name."""
    from mobgs_tpu_torch import compat
    from mobgs_tpu_torch.config import ModelHiddenParams
    from mobgs_tpu_torch.core import spline
    from mobgs_tpu_torch.models import deformation as DF
    from mobgs_tpu_torch.models import posenet as PN
    from mobgs_tpu_torch.models import render as R
    from mobgs_tpu_torch.ops import cuda_raster, projection
    from mobgs_tpu_torch.train import losses_extra as LX

    stat, dyn, data, cfg = protocol
    cpu = torch.device("cpu")
    t_phase = time.time()
    rng = np.random.default_rng(20)

    def on(x, d=dev):
        return torch.as_tensor(np.asarray(x, np.float32), device=d)

    # -- the gsplat shim, the phase's path through the kernels
    with torch.no_grad():
        geom = R.assemble(stat, dyn, 0.5, data.max_time)
    viewmats, Ks = on(data.w2c[:1]), on(data.K[:1])
    shim_launches, operands = {}, {}

    def recording_plain(ids, counts, rec, col, ntx, sub=False):
        operands[col.shape[1]] = (ids, counts, rec.detach(), col.detach(), ntx)
        return real_plain(ids, counts, rec, col, ntx, sub)

    real_plain = cuda_raster.composite_plain
    for C, mode in SHIM_MODES:
        ce = C + 2
        host = [geom.means, geom.quats, geom.scales, geom.opacity, geom.colors[:, :C]]
        g_img = on(rng.normal(size=(1, H, W, C + (mode == "RGB+ED"))))
        g_alpha = on(rng.normal(size=(1, H, W, 1)))
        bg = torch.linspace(0.1, 0.4, C, device=dev)[None]
        res = {}
        for backend in ("cuda", "plain"):
            leaves = [x.detach().clone().requires_grad_(True) for x in host]
            cuda_raster.reset_launches()
            torch.cuda.synchronize()
            t0 = time.time()
            with replaced((cuda_raster, "composite_plain", recording_plain)):
                img, alpha, info = compat.rasterization(
                    *leaves, viewmats, Ks, W, H, backgrounds=bg, render_mode=mode,
                    config=cfg._replace(backend=backend))
                if mode == "RGB+ED":
                    img = torch.cat([img[..., :-1], torch.where(
                        alpha > 1e-3, img[..., -1:], torch.zeros_like(alpha))], -1)
                grads = torch.autograd.grad(torch.sum(img * g_img)
                                            + torch.sum(alpha * g_alpha), leaves)
            torch.cuda.synchronize()
            wall = time.time() - t0
            res[backend] = (img.detach(), alpha.detach(), grads,
                            dict(cuda_raster.instance_launches), wall)
        (ik, ak, gk, lk, wk), (ip, ap, gp, lp, _) = res["cuda"], res["plain"]
        require(lk == {f"raster_fwd CE={ce}": 1, f"raster_bwd CE={ce}": 1},
                f"shim C={C} {mode}: launches {lk}")
        require(not lp, f"shim C={C} plain route launched {lp}")
        for name, n in lk.items():
            key = name.split()[0]
            shim_launches[key] = shim_launches.get(key, 0) + n
        m = ap[..., 0] > 1e-3
        errs = {"image": float((ik[..., :C] - ip[..., :C]).abs().max()),
                "alpha": float((ak - ap).abs().max())}
        if mode == "RGB+ED":
            errs["depth_rel"] = float(((ik[..., -1] - ip[..., -1]).abs()
                                       / ip[..., -1].abs().clamp(min=1e-12))[m].max())
        errs["grad_rel"] = max(rel_err(a[:, j], b[:, j]) for a, b in (
            (a.reshape(a.shape[0], -1), b.reshape(b.shape[0], -1)) for a, b in zip(gk, gp))
            for j in range(b.shape[1]) if b[:, j].any())
        print(f"shim C={C} {mode} (CE={ce}) kernels vs plain: {json.dumps(errs)}; "
              f"launches {json.dumps(lk)}; {1e3 * wk:.2f} ms forward + backward ({card})")
        require(errs["image"] <= IMG_ATOL and errs["alpha"] <= IMG_ATOL
                and errs.get("depth_rel", 0.0) <= DEPTH_RTOL and errs["grad_rel"] <= BWD_REL,
                f"shim C={C} {mode}: {errs}")
        require(all(torch.isfinite(x).all() for x in (ik, ak, *gk)), f"shim C={C} not finite")
        require(info["means2d"].shape == (1, geom.means.shape[0], 2), "shim info")
    times["lib_shim_s"] = time.time() - t_phase

    ffp = compat.fully_fused_projection(geom.means, None, geom.quats, geom.scales,
                                        viewmats, Ks, W, H, config=cfg)
    ref = projection.project(geom.means, geom.quats, geom.scales, viewmats[0], Ks[0], W, H,
                             eps2d=cfg.eps2d, near=cfg.near, sigma_cut=cfg.sigma_cut)
    require(ffp[4] is None and all(torch.equal(a[0], b) for a, b in zip(
        ffp[:4], (ref.radii, ref.means2d, ref.depths, ref.conics))),
        "fully_fused_projection is not project")

    # the shim's instances timed beside their bounds, on its own operands
    for ce, (ids, cnt, rec, col, ntx) in sorted(operands.items()):
        with torch.no_grad():
            ms = cuda_ms(lambda: cuda_raster.composite_fwd(ids, cnt, rec, col, ntx), 50)
            plain_ms = cuda_ms(lambda: cuda_raster.composite_tiles_plain(
                ids, cnt, rec, col, ntx, False), 5)
            out = cuda_raster.composite_fwd(ids, cnt, rec, col, ntx)[0]
        ops, bytes_, pairs, _ = raster_fwd_cost(ids, cnt, rec, col, False, ntx)
        print(f"shim raster_fwd CE={ce}: {ms:.4f} ms kernel, {plain_ms:.3f} ms plain, bound "
              f"{bound(ops, bytes_):.4f} ms by {bound_by(ops, bytes_)} ({ops / 1e9:.3f} GOP, "
              f"{bytes_ / 1e6:.2f} MB, {pairs} pairs), launches 1 ({card})")
        g = on(rng.normal(size=tuple(out.shape)))
        ms = cuda_ms(lambda: cuda_raster.composite_bwd(ids, cnt, rec, col, out, None, g, None,
                                                       ntx, False), 50)
        plain_ms = cuda_ms(lambda: cuda_raster.composite_bwd_plain(
            ids, cnt, rec, col, out, None, g, None, ntx, False), 5)
        ops, bytes_, pairs, _ = raster_bwd_cost(ids, cnt, rec, col, False, ntx)
        print(f"shim raster_bwd CE={ce}: {ms:.4f} ms kernel, {plain_ms:.3f} ms plain, bound "
              f"{bound(ops, bytes_):.4f} ms by {bound_by(ops, bytes_)} ({ops / 1e9:.3f} GOP, "
              f"{bytes_ / 1e6:.2f} MB), launches 1 ({card})")
    del operands

    # -- the deformation field at ModelHiddenParams' widths
    t0 = time.time()
    hidden = ModelHiddenParams()
    params = DF.init_deformation(torch.Generator(device=dev).manual_seed(0), hidden, device=dev)
    xyz, scl, rot = (torch.cat([getattr(stat, f), getattr(dyn, f)]).detach()
                     for f in ("xyz", "scaling", "rotation"))
    N = xyz.shape[0]
    cots = [on(rng.normal(size=(N, c))) for c in (3, 3, 4)]
    weights = (hidden.time_smoothness_weight, hidden.l1_time_planes, hidden.plane_tv_weight)

    def deform_run(d, frame_ids):
        """Outputs at the given frames and the gradients of their cotangent
        sums plus the regulation loss, one backward a frame."""
        leaves = [x.detach().to(d).requires_grad_(True) for x in _tensors(params)]
        p = _rebuild(params, iter(leaves))
        ins = [x.to(d) for x in (xyz, scl, rot)]
        outs = []
        for i in frame_ids:
            o = DF.apply_deformation(p, *ins, float(data.time[i]))
            sum(torch.sum(a * c.to(d)) for a, c in zip(o, cots)).backward()
            outs.append([a.detach() for a in o])
        reg = DF.regulation_loss(p, *weights)
        reg.backward()
        return outs, reg.detach(), [x.grad for x in leaves]

    outs_k, reg_k, grads_k = deform_run(dev, LIB_CPU_TIMES)
    outs_c, reg_c, grads_c = deform_run(cpu, LIB_CPU_TIMES)
    fwd = max(rel_err(a.cpu(), b) for o_k, o_c in zip(outs_k, outs_c)
              for a, b in zip(o_k, o_c))
    reg_rel = abs(float(reg_k) - float(reg_c)) / abs(float(reg_c))
    grad = max(rel_err(a.cpu(), b) for a, b in zip(grads_k, grads_c)
               if b is not None and b.any())
    require(all(a is None or not a.any() for a, b in zip(grads_k, grads_c)
                if b is None or not b.any()), "deformation: a gradient on the card only")
    print(f"deformation field ({sum(x.numel() for x in _tensors(params)) * 4 / 1e6:.1f} MB, "
          f"{N} slots) card vs CPU at frames {LIB_CPU_TIMES}: outputs {fwd:.3g}, "
          f"regulation {reg_rel:.3g}, gradients {grad:.3g} of each leaf's magnitude")
    require(fwd <= LIB_FWD_REL and reg_rel <= LIB_FWD_REL and grad <= LIB_GRAD_REL,
            f"deformation card vs CPU: {fwd}, {reg_rel}, {grad}")
    with torch.no_grad():
        ms_fwd = cuda_ms(lambda: [DF.apply_deformation(params, xyz, scl, rot, float(tv))
                                  for tv in data.time], 3) / len(data.time)
    torch.cuda.synchronize()
    t1 = time.time()
    deform_run(dev, range(len(data.time)))
    torch.cuda.synchronize()
    ms_step = (time.time() - t1) * 1e3
    print(f"apply_deformation: {ms_fwd:.3f} ms a call forward (CUDA events); the "
          f"{len(data.time)} frames "
          f"forward and backward with the regulation loss {ms_step:.1f} ms (host clock) "
          f"({card})")
    times["lib_deformation_s"] = time.time() - t0
    del params, outs_k, outs_c, grads_k, grads_c

    # -- PoseNet at the 24 views with a 512x288 depth
    gen = torch.Generator(device=dev).manual_seed(1)
    pn = PN.init_posenet(gen, FRAMES, H, W, data.max_time, device=dev)
    pn = pn._replace(timenet_out_w=0.01 * torch.randn(pn.timenet_out_w.shape, generator=gen,
                                                      device=dev))
    times_sel, depth = on(data.time), on(data.depths.reshape(FRAMES, -1))
    pcot = [on(rng.normal(size=s)) for s in ((FRAMES, 3, 3), (FRAMES, 3), (FRAMES, 1, H, W))]

    def pose_run(d):
        leaves = [x.detach().to(d).requires_grad_(True) for x in _tensors(pn)]
        outs = PN.posenet_forward(_rebuild(pn, iter(leaves)), times_sel.to(d), depth.to(d))
        loss = sum(torch.sum(a * c.to(d)) for a, c in zip(outs, pcot))
        return outs, torch.autograd.grad(loss, leaves, allow_unused=True)

    (outs_k, grads_k), (outs_c, grads_c) = pose_run(dev), pose_run(cpu)
    fwd = max(rel_err(a.detach().cpu(), b.detach()) for a, b in zip(outs_k, outs_c))
    grad = max(rel_err(a.cpu(), b) for a, b in zip(grads_k, grads_c)
               if b is not None and b.any())
    ms = cuda_ms(lambda: PN.posenet_forward(pn, times_sel, depth), 20)
    print(f"PoseNet ({FRAMES} views, {W}x{H} depth) card vs CPU: outputs {fwd:.3g}, "
          f"gradients {grad:.3g}; {ms:.3f} ms forward ({card})")
    require(fwd <= LIB_FWD_REL and grad <= LIB_GRAD_REL, f"PoseNet card vs CPU {fwd}, {grad}")

    # -- the depth-volume warps and the KNN constraint
    t0 = time.time()
    torch.cuda.reset_peak_memory_stats()
    K_np = np.asarray(data.K[0], np.float32)
    w2c1, w2c2 = data.w2c[0], data.w2c[1]
    img = np.ascontiguousarray(np.asarray(data.images[0], np.float32).transpose(2, 0, 1))
    depth0 = np.asarray(data.depths[0], np.float32)
    # the first view's pixels back-projected at its depth, in world space
    j, i = np.meshgrid(np.arange(W, dtype=np.float32), np.arange(H, dtype=np.float32))
    cam_pts = (np.linalg.inv(K_np) @ np.stack([j.ravel(), i.ravel(), np.ones(H * W)])
               * depth0.ravel())
    pc2 = (np.linalg.inv(w2c1) @ np.concatenate([cam_pts, np.ones((1, H * W))]))[:3]
    pc2 = pc2.reshape(3, H, W).astype(np.float32)

    def warps(d):
        a = [on(x, d) for x in (img, depth0, w2c1, w2c2, K_np, np.linalg.inv(K_np))]
        out = {}
        fw, occ, grid = LX.direct_warp_rt1_rt2(*a, ret_grid=True,
                                               no_bucket=WARP_BUCKETS["direct_warp_rt1_rt2"])
        out["direct_warp_rt1_rt2"] = ((fw, occ), grid)
        n = WARP_BUCKETS["occ_rt1_rt2"]
        out["occ_rt1_rt2"] = ((LX.occ_rt1_rt2(*a[1:], no_bucket=n),),
                              LX._disparity_volume(a[1], n, False, *a[2:], "zeros")[1])
        pw, pgrid = LX.warp_pc2flow(a[0], on(pc2, d), a[3], a[4], ret_grid=True)
        out["warp_pc2flow"] = ((pw,), pgrid[None])
        return out

    wk, wc = warps(dev), warps(cpu)
    for name, ((outs_k, grid_k), (outs_c, grid_c)) in ((n, (wk[n], wc[n])) for n in wk):
        # the reference's out-of-range 2.0 is a jump: a coordinate within
        # rounding of the range's edge may take it on one device only
        flip = ((grid_k.cpu() == 2.0) != (grid_c == 2.0)).any(-1).any(0)
        errs = [float(((a.cpu() - b).abs() * ~flip).max()) / max(float(b.abs().max()), 1e-30)
                for a, b in zip(outs_k, outs_c)]
        print(f"{name} ({W}x{H}) card vs CPU: {max(errs):.3g} of the output's magnitude, "
              f"{int(flip.sum())} pixels with an out-of-range flip excluded ({card})")
        require(max(errs) <= WARP_REL and int(flip.sum()) <= H * W // 1000,
                f"{name} card vs CPU {errs}, {int(flip.sum())} flips")
    warp_ms = {
        "direct_warp_rt1_rt2": cuda_ms(lambda: LX.direct_warp_rt1_rt2(
            *(on(x) for x in (img, depth0, w2c1, w2c2, K_np, np.linalg.inv(K_np)))), 5),
        "occ_rt1_rt2": cuda_ms(lambda: LX.occ_rt1_rt2(
            *(on(x) for x in (depth0, w2c1, w2c2, K_np, np.linalg.inv(K_np)))), 5),
        "warp_pc2flow": cuda_ms(lambda: LX.warp_pc2flow(on(img), on(pc2), on(w2c2), on(K_np)),
                                5)}
    del wk, wc

    # the KNN constraint on 20,000 static seeds moved by a seeded 1e-3 jitter;
    # the radius holds ~KNN_K points of a uniform cloud of their extent
    canno = stat.xyz.detach()[stat.live][:KNN_POINTS].cpu().numpy()
    extent = float((canno.max(0) - canno.min(0)).max())
    radius = extent * (KNN_K / KNN_POINTS) ** (1 / 3) / 2
    moved = (canno + rng.normal(size=canno.shape) * 1e-3 * extent).astype(np.float32)[None]
    bq_k = LX.ball_query(on(moved), on(moved), k=KNN_K, radius=radius)
    bq_c = LX.ball_query(on(moved, cpu), on(moved, cpu), k=KNN_K, radius=radius)
    hits = float((bq_c[1] >= 0).sum(-1).float().mean())
    require(torch.equal(bq_k[1].cpu(), bq_c[1]), "ball_query indices card vs CPU")
    knn = {}
    for d in (dev, cpu):
        x = on(moved, d).requires_grad_(True)
        loss = LX.knn_constraint_loss(x, on(canno, d), radius, KNN_K)
        knn[str(d)] = (float(loss.detach()), torch.autograd.grad(loss, x)[0].cpu())
    (lk_, gk_), (lc_, gc_) = knn[str(dev)], knn["cpu"]
    knn_rel, knn_grad = abs(lk_ - lc_) / abs(lc_), rel_err(gk_, gc_)
    ms_bq = cuda_ms(lambda: LX.ball_query(on(moved), on(moved), k=KNN_K, radius=radius), 3)
    ms_knn = cuda_ms(lambda: LX.knn_constraint_loss(on(moved), on(canno), radius, KNN_K), 3)
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"ball_query ({canno.shape[0]} points, k={KNN_K}, radius {radius:.4g}, {hits:.1f} hits "
          f"a row on the mean) indices equal card vs CPU; knn_constraint_loss {lk_:.6g}: "
          f"loss {knn_rel:.3g}, gradient {knn_grad:.3g} of its magnitude ({card})")
    require(knn_rel <= LIB_FWD_REL and knn_grad <= LIB_GRAD_REL and torch.isfinite(gk_).all(),
            f"knn_constraint_loss card vs CPU {knn_rel}, {knn_grad}")
    print(f"ms: {json.dumps({**{k: round(v, 3) for k, v in warp_ms.items()}, 'ball_query': round(ms_bq, 3), 'knn_constraint_loss': round(ms_knn, 3)})}; "
          f"peak memory of the warps and the KNN constraint {peak:.3f} GiB ({card})")
    times["lib_warps_knn_s"] = time.time() - t0

    # -- knot pruning on the protocol's dynamic splines
    t0 = time.time()
    ctrl, ncur = dyn.control_xyz.detach(), dyn.control_num
    focal = float(data.K[0][0, 0])

    def prune(control):
        """(control', n', accepted, the refit's errors) on the card and on the
        CPU, as CPU tensors."""
        res = []
        for d in (dev, cpu):
            args = (control.to(d), ncur.to(d), on(data.w2c, d), on(data.time, d), focal, W, H)
            new_c, new_n, acc = spline.onedown_control_pts(*args, ONEDOWN_THR)
            err = spline.compute_prune_error(
                args[0], args[1], spline.refit_spline_pruned(args[0], args[1], ctrl.shape[1]),
                torch.clamp(args[1] - 1, min=4), *args[2:])
            res.append((new_c.cpu(), new_n.cpu(), int(acc), err.cpu()))
        (ck, nk, ak, _), (cc, nc, ac, ec) = res
        margin = float(((ec - ONEDOWN_THR).abs() / ONEDOWN_THR).min())
        return ak, ac, torch.equal(nk, nc), rel_err(ck, cc), margin, ec

    ak, ac, same_n, c_err, margin, ec = prune(ctrl)
    ms = cuda_ms(lambda: spline.onedown_control_pts(ctrl, ncur, on(data.w2c), on(data.time),
                                                    focal, W, H, ONEDOWN_THR), 5)
    print(f"onedown_control_pts ({ctrl.shape[0]} splines, K={ctrl.shape[1]}, {FRAMES} views): "
          f"{ak} accepted on the card, {ac} on the CPU at the reference's {ONEDOWN_THR} px "
          f"(largest error {float(ec.max()):.4g} px); control points {c_err:.3g} of "
          f"their magnitude; smallest |err - thr| / thr {margin:.3g}; {ms:.3f} ms ({card})")
    require(ak == ac and same_n and c_err <= 1e-4, "onedown_control_pts card vs CPU")
    # both branches: the protocol's splines are smooth, so every refit's error
    # is float32 rounding and all accept; every other spline gets a seeded
    # wiggle of one unit (1 cm) on its live knots, which removing a knot
    # cannot follow
    live_knots = (torch.arange(ctrl.shape[1], device=dev)[None, :] < ncur[:, None].long())
    wiggle = on(rng.normal(size=tuple(ctrl.shape))) * live_knots[..., None]
    wiggle[0::2] = 0.0
    ak, ac, same_n, c_err, margin, _ = prune(ctrl + wiggle)
    print(f"onedown_control_pts with every other spline wiggled: {ak} accepted on the card, "
          f"{ac} on the CPU of {ctrl.shape[0]}; smallest |err - thr| / thr {margin:.3g}; "
          f"control points {c_err:.3g} of their magnitude ({card})")
    require(ak == ac and same_n and c_err <= 1e-4,
            "onedown_control_pts on the wiggled splines, card vs CPU")
    require(0 < ak < ctrl.shape[0], "onedown_control_pts: one branch only")
    times["lib_prune_s"] = time.time() - t0
    times["lib_phase_s"] = time.time() - t_phase
    return shim_launches


def _tensors(tree):
    """The tensors of a nested tuple / NamedTuple, in order."""
    if isinstance(tree, tuple):
        return [y for v in tree for y in _tensors(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def _rebuild(tree, it):
    """``tree`` with its tensors replaced, in order, from ``it``."""
    if isinstance(tree, tuple):
        vals = [_rebuild(v, it) for v in tree]
        return type(tree)(*vals) if hasattr(tree, "_fields") else tuple(vals)
    return next(it) if isinstance(tree, torch.Tensor) else tree


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    from mobgs_tpu_torch.data.cameras import Camera
    from mobgs_tpu_torch.models import gaussians as G
    from mobgs_tpu_torch.models import render as R
    from mobgs_tpu_torch.models.sandwich import init_sandwich
    from mobgs_tpu_torch.ops import cuda_raster, projection, tiles
    from mobgs_tpu_torch.viewer import ViewerServer, make_viewer_render

    t_start = time.time()
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
    for kname, occupancy, instances in (
            ("raster_fwd", cuda_raster.fwd_occupancy, FWD_INSTANCES),
            ("raster_bwd", cuda_raster.bwd_occupancy, BWD_INSTANCES)):
        for ce, sub in instances:
            occ = occupancy(ce, 256, sub, dev)
            waves = -(-PROTOCOL_TILES // max(occ["blocks_per_sm"] * n_sm, 1))
            threads = occ.get("threads", cuda_raster.P)
            print(f"  {kname} CE={ce} sub={sub}: {threads} threads, "
                  f"{occ['registers']} registers, {occ['smem_bytes']} B shared, "
                  f"{occ['local_bytes']} B local, {occ['blocks_per_sm']} blocks/SM "
                  f"on {n_sm} SMs, {waves} wave(s) at {PROTOCOL_TILES} tiles")
            require(occ["blocks_per_sm"] > 0, f"{kname} CE={ce} sub={sub} cannot launch")
            require(occ["local_bytes"] == 0, f"{kname} CE={ce} sub={sub} spills")

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
    cuda_raster.reset_launches()

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
    from mobgs_tpu_torch.data.cameras import pixel_grid
    from mobgs_tpu_torch.train import loop as L
    from mobgs_tpu_torch.train import losses
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
    # the flow-on mid render beyond one instance: column groups
    for e_w in E_WIDE:
        bwd_cases[f"wide_mid_ce{2 * e_w + 11}_sub"] = (torch.cat([
            geom.colors,
            torch.as_tensor(rng.normal(size=(N, 2 * e_w)).astype(np.float32), device=dev),
            splats.depths[:, None], ones], 1), True)
    bwd_inputs, bwd_errs, wide_groups = {}, {}, {}
    rec_names = ("mx", "my", "conic_a", "conic_b", "conic_c", "opacity", "sub_opacity")
    for name, (col, sub) in bwd_cases.items():
        col = col.detach().contiguous()
        rec = cuda_raster.pack_records(splats, geom.opacity, sub_op if sub else None).detach()
        before = dict(cuda_raster.instance_launches)
        with torch.no_grad():
            out, out2 = cuda_raster.composite_fwd(ids, cnt, rec, col, ntx, sub)
        fwd_groups = launch_delta(before)
        CE = col.shape[1]
        if CE > cuda_raster.CE_GROUP:
            with torch.no_grad():
                p_out, p_out2 = cuda_raster.composite_tiles_plain(ids, cnt, rec, col, ntx, sub)
            e = {"image": float((out[..., :9] - p_out[..., :9]).abs().max()),
                 "flow/tol": flow_err(out[..., 9:CE - 2], p_out[..., 9:CE - 2]),
                 "depth/tol": flow_err(out[..., CE - 2], p_out[..., CE - 2]),
                 "weight": float((out[..., CE - 1] - p_out[..., CE - 1]).abs().max()),
                 "sub_alpha": float((out2 - p_out2).abs().max())}
            print(f"{name} forward vs plain: {json.dumps(e)}")
            require(e["image"] <= IMG_ATOL and e["weight"] <= IMG_ATOL
                    and e["sub_alpha"] <= IMG_ATOL and e["flow/tol"] <= 1.0
                    and e["depth/tol"] <= 1.0, f"{name} forward {e}")
            require(sum(fwd_groups.values()) == len(cuda_raster.column_groups(CE)),
                    f"{name}: forward launches {fwd_groups}")
        g = torch.as_tensor(rng.normal(size=out.shape).astype(np.float32), device=dev)
        g2 = (torch.as_tensor(rng.normal(size=out2.shape).astype(np.float32), device=dev)
              if sub else None)
        args = (ids, cnt, rec, col, out, out2, g, g2, ntx, sub)
        before = dict(cuda_raster.instance_launches)
        k = cuda_raster.composite_bwd(*args)
        bwd_groups = launch_delta(before)
        if CE > cuda_raster.CE_GROUP:
            wide_groups[CE] = (fwd_groups, bwd_groups)
            print(f"{name}: launches by column group: forward {json.dumps(fwd_groups)}, "
                  f"backward {json.dumps(bwd_groups)}")
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

    def train_state(num_warp=E_WARP):
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
                         num_warp=num_warp, device=dev)
        return S.init_train_state(stat_t, dyn_t, sw, bl)

    names = {"stat": G.DIFF_FIELDS, "dyn": G.DIFF_FIELDS,
             "sandwich": ("w1", "w2"), "blce": B.BLCE_FIELDS}

    def param_groups(ts):
        return {"stat": G.split_diff(ts.stat)[0], "dyn": G.split_diff(ts.dyn)[0],
                "sandwich": S.sandwich_leaves(ts.sandwich),
                "blce": ts.blce.params.leaves()}

    def step_vs_plain(opt, ts, batch, num_warp=E_WARP, rcfg=cfg, deep=False):
        """One step's loss and gradients through the kernels and through the
        plain route, same state, batch and budgets (``rcfg``); returns the
        kernel route's aux. With ``deep`` both are also run against the
        step with the compositor in float64 (see DEEP_PLAIN_X)."""
        groups = param_groups(ts)
        step_res = {}
        plain = cuda_raster.composite_plain
        for route in ("cuda", "plain", "plain64") if deep else ("cuda", "plain"):
            backend = "cuda" if route == "cuda" else "plain"
            fwd = S.make_forward(opt, W, H, data.max_time, num_warp,
                                 rcfg._replace(backend=backend))
            off = torch.zeros((B_VIEWS, ts.stat.capacity + ts.dyn.capacity, 2),
                              device=dev, requires_grad=True)
            if route == "plain64":
                cuda_raster.composite_plain = composite_plain64()
            try:
                total, aux = fwd(ts.stat, ts.dyn, ts.sandwich, ts.blce, off, batch)
                leaves = [p for grp in groups.values() for p in grp] + [off]
                grads = torch.autograd.grad(total, leaves, allow_unused=True)
            finally:
                cuda_raster.composite_plain = plain
            step_res[route] = (float(total.detach()), float(aux["psnr"]),
                               {k: float(aux[k].detach()) for k in ("flow", "photo")},
                               [torch.zeros_like(p) if gr is None else gr
                                for p, gr in zip(leaves, grads)])
            torch.cuda.synchronize()
        (lk, pk, ak, gk), (lp, pp, ap, gp) = step_res["cuda"], step_res["plain"]
        gr = step_res["plain64"][3] if deep else gp
        print(f"loss kernels {lk!r} plain {lp!r} (rel {abs(lk - lp) / abs(lp):.3g}); "
              f"psnr {pk:.4f} / {pp:.4f}; flow term {ak['flow']!r} / {ap['flow']!r}")
        require(np.isfinite(lk) and abs(lk - lp) <= LOSS_RTOL * abs(lp), "train-step loss")
        i, n_leaves = 0, 0
        worst = {"kernels": {}, "plain": {}, "kernels vs plain": {}}
        failed = []
        for grp, leaves in list(groups.items()) + [("offsets", (None,))]:
            for j in range(len(leaves)):
                nm = "offsets" if grp == "offsets" else f"{grp}.{names[grp][j]}"
                a, b, ref = gk[i], gp[i], gr[i]
                i += 1
                require(bool(torch.isfinite(a).all()), f"{nm} gradient not finite")
                scale = float(ref.abs().max())
                if scale == 0.0:
                    require(not a.any(), f"{nm}: kernels give a gradient, the reference none")
                    continue
                n_leaves += 1
                errs = {"kernels": float((a - ref).abs().max()) / scale}
                tol = STEP_REL[grp]
                if deep:
                    errs["plain"] = float((b - ref).abs().max()) / scale
                    errs["kernels vs plain"] = float((a - b).abs().max()) / scale
                    tol = max(tol, DEEP_PLAIN_X * errs["plain"])
                for key, r in errs.items():
                    worst[key][grp] = max(worst[key].get(grp, 0.0), r)
                if errs["kernels"] > tol:
                    failed.append(f"{nm} {errs['kernels']:.3g} (tolerance {tol:.3g})")
        worst = {k: {g: float(f"{v:.3g}") for g, v in w.items()} for k, w in worst.items() if w}
        if deep:
            print(f"gradient leaves compared: {n_leaves}; worst max|x-r|/max|r| by group "
                  f"against r, the step with the compositor in float64: {json.dumps(worst)}")
        else:
            print(f"gradient leaves compared: {n_leaves}; worst max|k-p|/max|p| by group: "
                  f"{json.dumps(worst['kernels'])}")
        require(not failed, f"train-step gradients beyond tolerance: {failed}")
        return ak

    def train_steps(step_fn, ts, sampler, n_warm, n_steps, label, per_step):
        """Warm up, then time ``n_steps`` synchronised steps with the launch
        counts set to 0 just before them and read just after; checks the
        counts per step and that every field with a gradient moved."""
        before = {f"{grp}.{n}": p.detach().clone()
                  for grp, ps in param_groups(ts).items() if grp in ("stat", "dyn")
                  for n, p in zip(G.DIFF_FIELDS, ps)}
        for _ in range(n_warm):
            ts, m = step_fn(ts, L.make_batch(data, sampler.next_ids(), dev))
        torch.cuda.synchronize()
        cuda_raster.reset_launches()
        step_s, hist = [], []
        for k in range(n_steps):
            b = L.make_batch(data, sampler.next_ids(), dev)
            torch.cuda.synchronize()
            t0 = time.time()
            ts, m = step_fn(ts, b)
            torch.cuda.synchronize()
            step_s.append(time.time() - t0)
            hist.append((float(m.loss), float(m.psnr), float(m.flow), int(m.tile_max)))
        counts = dict(cuda_raster.launches)
        by_instance = dict(cuda_raster.instance_launches)
        rate = n_steps / sum(step_s)
        for k, (loss, ps, fl, tm) in enumerate(hist):
            print(f"  step {n_warm + k + 1:2d}: loss {loss:.6f} flow {fl:.6g} psnr {ps:.4f} "
                  f"tile_max {tm} ({1e3 * step_s[k]:.1f} ms)")
        require(all(np.isfinite(h[0]) and np.isfinite(h[1]) and np.isfinite(h[2])
                    for h in hist), "loss, flow or PSNR not finite")
        print(f"train: {rate:.3f} it/s {label}, B={B_VIEWS} E={E_WARP} {W}x{H}, "
              f"{ts.stat.capacity}+{ts.dyn.capacity} slots, on {card}; "
              f"median step {1e3 * float(np.median(step_s)):.1f} ms")
        print(f"training-path launches {label} ({n_steps} steps): {json.dumps(counts)}; "
              f"by instance {json.dumps(by_instance)}")
        for key, n in per_step.items():
            require(counts[key] == n * n_steps,
                    f"{key}: {counts[key]} launches {label}, expected {n} per step")
        moved, still = 0, []
        for grp in ("stat", "dyn"):
            opt_state = getattr(ts, f"{grp}_opt")
            for n, p, mu in zip(G.DIFF_FIELDS, G.split_diff(getattr(ts, grp))[0],
                                opt_state.mu):
                if not mu.any():
                    continue  # no gradient reached this field
                if torch.equal(p.detach(), before[f"{grp}.{n}"]):
                    still.append(f"{grp}.{n}")
                moved += 1
        print(f"Gaussian fields with a gradient: {moved}, all changed: {not still}")
        require(moved > 0 and not still, f"fields with a gradient did not change: {still}")
        return ts, rate, counts, by_instance, hist

    def trace(fn, label):
        """Device time of one call of ``fn`` by kernel name: the top ten and
        the compositor kernels wherever they rank."""
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.time()
            out = fn()
            torch.cuda.synchronize()
            wall_us = (time.time() - t0) * 1e6
        by_name = {}
        for ev in prof.events():
            if ev.device_type == DeviceType.CUDA:
                by_name[ev.name] = by_name.get(ev.name, 0.0) + ev.time_range.elapsed_us()
        busy_us = sum(by_name.values())
        if busy_us:
            print(f"trace: {wall_us:.0f} us wall per {label}, {busy_us:.0f} us device "
                  f"busy ({100 * busy_us / wall_us:.1f} %), {len(by_name)} kernel names")
            ranked = sorted(by_name.items(), key=lambda kv: -kv[1])
            for rank, (name, us) in enumerate(ranked, 1):
                if rank <= 10 or "raster_" in name:
                    print(f"  {us:8.1f} us  #{rank:<3d} {name[:90]}")
        else:
            print("trace: the profiler recorded no device time (not measured)")
        return out, busy_us

    # bench.py's seesaw overlay: batch 2, flow off
    opt = OptimizationParams(iterations=10_000, batch_size=B_VIEWS, lambda_flow_loss=0.0)
    # the default configuration (config.py:139): flow on
    opt_flow = OptimizationParams(iterations=10_000, batch_size=B_VIEWS,
                                  lambda_flow_loss=LAMBDA_FLOW)

    phase("8 train step: kernels vs plain")
    t0 = time.time()
    ts = train_state()
    sampler = L.BatchSampler(FRAMES, B_VIEWS, seed=0)
    step_vs_plain(opt, ts, L.make_batch(data, sampler.next_ids(), dev))
    times["step_check_s"] = time.time() - t0

    phase("9 train")
    # per view: E-1 latent renders (plain chain) and the mid render (sub chain)
    per_step = {"raster_fwd": B_VIEWS * (E_WARP - 1), "raster_fwd_sub": B_VIEWS,
                "raster_bwd": B_VIEWS * (E_WARP - 1), "raster_bwd_sub": B_VIEWS}
    step_fn = S.make_train_step(opt, W, H, data.max_time, E_WARP, cfg)
    ts, rates["train_it_s"], train_launches, _, _ = train_steps(
        step_fn, ts, sampler, N_WARM, N_STEPS, "flow off", per_step)
    _, busy = trace(lambda: step_fn(ts, L.make_batch(data, sampler.next_ids(), dev)),
                    "train step")
    times["step_device_ms"] = busy / 1e3

    phase("10 flow-on train step: kernels vs plain")
    t0 = time.time()
    ts_f = train_state()
    sampler_f = L.BatchSampler(FRAMES, B_VIEWS, seed=1)
    aux = step_vs_plain(opt_flow, ts_f, L.make_batch(data, sampler_f.next_ids(), dev))
    require(np.isfinite(aux["flow"]) and aux["flow"] > 0, f"flow term {aux['flow']}")
    # more latent exposures than one kernel instance takes in the mid render:
    # E=11 gives CE = 9 + 22 + 2 = 33 + sub, two column groups
    e_w = E_WIDE[0]
    ts_w = train_state(e_w)
    batch_w = L.make_batch(data, L.BatchSampler(FRAMES, B_VIEWS, seed=2).next_ids(), dev)
    print(f"flow-on step at E={e_w} (mid render CE={2 * e_w + 11} + sub):")
    aux = step_vs_plain(opt_flow, ts_w, batch_w, e_w)
    require(np.isfinite(aux["flow"]) and aux["flow"] > 0, f"E={e_w} flow term {aux['flow']}")
    step_w = S.make_train_step(opt_flow, W, H, data.max_time, e_w, cfg)
    torch.cuda.synchronize()
    cuda_raster.reset_launches()
    ts_w, m_w = step_w(ts_w, batch_w)
    torch.cuda.synchronize()
    e11_launches, e11_instances = dict(cuda_raster.launches), dict(cuda_raster.instance_launches)
    n_groups = len(cuda_raster.column_groups(2 * e_w + 11))
    want = {"raster_fwd": B_VIEWS * (e_w - 1),
            "raster_fwd_sub": B_VIEWS * (e_w - 1) + B_VIEWS * n_groups}
    want.update(raster_bwd=want["raster_fwd"], raster_bwd_sub=want["raster_fwd_sub"])
    print(f"one E={e_w} flow-on step through the kernels: loss {float(m_w.loss)!r}, "
          f"launches {json.dumps(e11_launches)}; by instance {json.dumps(e11_instances)}")
    require(bool(torch.isfinite(m_w.loss)) and e11_launches == want,
            f"E={e_w} step launches {e11_launches}, expected {want}")
    del ts_w, step_w
    times["flow_step_check_s"] = time.time() - t0

    phase("11 flow-on train")
    # per view: E-1 latent renders (plain chain); E-1 exposure-flow passes and
    # the mid render with 2E flow columns (sub chain)
    per_step_f = {"raster_fwd": B_VIEWS * (E_WARP - 1), "raster_fwd_sub": B_VIEWS * E_WARP,
                  "raster_bwd": B_VIEWS * (E_WARP - 1), "raster_bwd_sub": B_VIEWS * E_WARP}
    flow_fn = S.make_train_step(opt_flow, W, H, data.max_time, E_WARP, cfg)
    ts_f, rates["train_it_s_flow_on"], flow_launches, flow_instances, hist = train_steps(
        flow_fn, ts_f, sampler_f, N_FLOW_WARM, N_FLOW_STEPS, "flow on", per_step_f)
    require(all(h[2] > 0 for h in hist), "a flow-on step has no flow term")
    mid_ce = 9 + 2 * E_WARP + 2
    for key, n in ((f"raster_fwd_sub CE={mid_ce}", B_VIEWS), ("raster_fwd_sub CE=11", B_VIEWS * (E_WARP - 1)),
                   (f"raster_bwd_sub CE={mid_ce}", B_VIEWS), ("raster_bwd_sub CE=11", B_VIEWS * (E_WARP - 1))):
        require(flow_instances.get(key, 0) == n * N_FLOW_STEPS,
                f"{key}: {flow_instances.get(key, 0)} launches, expected {n} per step")
    _, busy = trace(lambda: flow_fn(ts_f, L.make_batch(data, sampler_f.next_ids(), dev)),
                    "flow-on train step")
    times["flow_step_device_ms"] = busy / 1e3
    # the warp loss of one view alone (2E warps of W x H x 3, forward and
    # backward): images, alphas and coordinates a few pixels off the grid
    gen = torch.Generator(device=dev).manual_seed(3)
    pix = pixel_grid(W, H, device=dev)
    wl_in = [torch.rand(s, generator=gen, device=dev).requires_grad_(True)
             for s in ((H, W, 3), (E_WARP, H, W, 3), (E_WARP, H, W), (H, W))]
    wl_co = [(pix + 4 * torch.randn((E_WARP, H, W, 2), generator=gen, device=dev))
             .requires_grad_(True) for _ in range(2)]

    def warp_loss_fwd_bwd():
        loss = losses.flow_warp_loss(*wl_in, *wl_co, W, H)
        return torch.autograd.grad(loss, wl_in + wl_co)

    # ~1,500 small launches: the host's dispatch sets the wall time, so the
    # device's share is read from the profiler, not from CUDA events
    warp_loss_fwd_bwd()
    _, busy = trace(warp_loss_fwd_bwd, f"flow_warp_loss forward + backward of one view "
                    f"({2 * E_WARP} warps of {W}x{H}x3)")
    times["warp_loss_view_device_ms"] = busy / 1e3

    phase("12 exposure update")
    # a batch with an endpoint view; the loop's neighbour arguments
    # (loop.py:393-403)
    expo_ids = np.array([0, FRAMES // 2 - 1])
    nb_fwd = np.minimum(expo_ids + 1, FRAMES - 1)
    nb_bwd = np.maximum(expo_ids - 1, 0)
    on = lambda x, dt=torch.float32: torch.as_tensor(np.asarray(x), dtype=dt, device=dev)  # noqa: E731
    expo_args = (on(expo_ids, torch.int64), on(data.w2c[expo_ids]), on(data.K[expo_ids]),
                 on(data.time[expo_ids]), on(data.blur_feats[expo_ids]), on(data.w2c[nb_fwd]),
                 on(data.w2c[nb_bwd]), on((expo_ids == 0) | (expo_ids == FRAMES - 1), torch.bool))

    def expo_vs_plain(ts, rcfg):
        """``make_exposure_update`` through the kernels and the plain route
        at the budgets ``rcfg``; returns the kernels' new exposures."""
        old = ts.blce.exposure_expo.clone()
        new = {}
        for backend in ("cuda", "plain"):
            upd = S.make_exposure_update(W, H, data.max_time, E_WARP,
                                         rcfg._replace(backend=backend))
            new[backend] = upd(ts, *expo_args).blce.exposure_expo
        torch.cuda.synchronize()
        ek, ep = new["cuda"], new["plain"]
        expo_rel = float(((ek - ep).abs() / ep.abs().clamp(min=1e-30)).max())
        print(f"exposures at views {expo_ids.tolist()} (max_per_tile {rcfg.max_per_tile}): "
              f"kernels {ek[expo_ids].tolist()} plain {ep[expo_ids].tolist()} (was "
              f"{old[expo_ids].tolist()}); max rel diff {expo_rel:.3g}")
        require(bool(torch.isfinite(ek).all()), "exposures not finite")
        require(expo_rel <= EXPO_RTOL, f"exposure update kernels vs plain {expo_rel:.3g}")
        rest = torch.ones(FRAMES, dtype=torch.bool, device=dev)
        rest[expo_ids] = False
        require(torch.equal(ek[rest], old[rest]) and torch.equal(ts.blce.exposure_expo, old),
                "the update wrote outside the batch's views")
        return ek

    ek = expo_vs_plain(ts_f, cfg)
    expo_fn = S.make_exposure_update(W, H, data.max_time, E_WARP, cfg)
    expo_fn(ts_f, *expo_args)
    torch.cuda.synchronize()
    cuda_raster.reset_launches()
    t0 = time.time()
    for _ in range(N_EXPO):
        ts_e = expo_fn(ts_f, *expo_args)
    torch.cuda.synchronize()
    rates["exposure_update_per_s"] = N_EXPO / (time.time() - t0)
    expo_launches = dict(cuda_raster.launches)
    expo_instances = dict(cuda_raster.instance_launches)
    print(f"exposure update: {rates['exposure_update_per_s']:.2f} calls/s at B={B_VIEWS}; "
          f"launches ({N_EXPO} calls): {json.dumps(expo_instances)}")
    require(expo_launches == {"raster_fwd": 2 * B_VIEWS * N_EXPO, "raster_fwd_sub": 0,
                              "raster_bwd": 0, "raster_bwd_sub": 0}
            and expo_instances == {"raster_fwd CE=4": 2 * B_VIEWS * N_EXPO},
            f"exposure-update launches {expo_launches}")
    require(torch.equal(ts_e.blce.exposure_expo, ek), "the update does not repeat")
    trace(lambda: expo_fn(ts_f, *expo_args), "exposure update")

    phase("13 kernel timing")
    # launches of this phase are not counted above
    entries = []

    def fwd_cost(ids_, cnt_, rec, col, sub, ntx_=None):
        return raster_fwd_cost(ids_, cnt_, rec, col, sub, ntx_ or ntx)

    def bwd_cost(ids_, cnt_, rec, col, sub, ntx_=None):
        return raster_bwd_cost(ids_, cnt_, rec, col, sub, ntx_ or ntx)

    def entry(key, ms, plain_ms, ops, bytes_, err):
        entries.append({
            "name": key, "route": "cuda",
            "source": SOURCES["raster_bwd" if "bwd" in key else "raster_fwd"],
            "replaces": REPLACES[key], "launches": train_launches[key],
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound(ops, bytes_),
            "bound_by": bound_by(ops, bytes_),
            "library_ms": None,
        })

    def time_fwd(ids_, cnt_, rec, col, sub, ntx_=None, iters=50, plain_iters=5):
        n = ntx_ or ntx
        with torch.no_grad():
            ms = cuda_ms(lambda: cuda_raster.composite_fwd(ids_, cnt_, rec, col, n, sub), iters)
            plain_ms = cuda_ms(lambda: cuda_raster.composite_tiles_plain(
                ids_, cnt_, rec, col, n, sub), plain_iters)
        return ms, plain_ms

    def instance_line(label, ms, plain_ms, ops, bytes_, pairs, CE, launches):
        b = bound(ops, bytes_)
        print(f"{label}: {ms:.4f} ms kernel, {plain_ms:.3f} ms plain, bound {b:.4f} ms "
              f"({100 * b / ms:.1f} % of bound; {ops / 1e9:.3f} GOP, {bytes_ / 1e6:.2f} MB, "
              f"{pairs} pairs, CE={CE}); flow-on launches: {launches}")

    # the default render (CE=11) and the mid render's fused sub chain are
    # the table's entries; the other instances the training paths launch
    # are printed on lines of their own
    ext11 = torch.cat([geom.colors, splats.depths[:, None], ones], 1).detach().contiguous()
    for key, case, col in (("raster_fwd", "a_default_ce11", ext11),
                           ("raster_fwd_sub", "b_fused_sub", ext11)):
        sub = key == "raster_fwd_sub"
        rec = cuda_raster.pack_records(splats, geom.opacity, sub_op if sub else None).detach()
        ms, plain_ms = time_fwd(ids, cnt, rec, col, sub)
        ops, bytes_, pairs, _ = fwd_cost(ids, cnt, rec, col, sub)
        err = max(errs[case].get(k2, 0.0) for k2 in ("image", "alpha", "sub_alpha"))
        entry(key, ms, plain_ms, ops, bytes_, err)
        print(f"{key}: {ms:.4f} ms kernel, {plain_ms:.3f} ms plain, bound "
              f"{bound(ops, bytes_):.4f} ms ({ops / 1e9:.3f} GOP, {bytes_ / 1e6:.2f} MB, "
              f"{pairs} pairs, T={T_tiles}, K={ids.shape[1]}, CE={col.shape[1]})")

    rec_plain = cuda_raster.pack_records(splats, geom.opacity).detach()
    col9 = geom.colors.detach().contiguous()
    ms, plain_ms = time_fwd(ids, cnt, rec_plain, col9, False)
    ops, bytes_, pairs, _ = fwd_cost(ids, cnt, rec_plain, col9, False)
    instance_line("raster_fwd CE=9 image-only (latent render)", ms, plain_ms, ops, bytes_,
                  pairs, 9, flow_instances.get("raster_fwd CE=9", 0))

    # the exposure-flow pass: colours and this view's flow to the first
    # exposure's geometry as two columns, the dynamic chain, no depth or
    # weight column (CE = 9 + 2)
    _, splats_e = R.assemble_project(stat, dyn, cam(0), W, H, data.max_time, -1.0, cfg)
    col_flow = torch.cat([geom.colors, splats.means2d - splats_e.means2d], 1).detach().contiguous()
    rec_sub = cuda_raster.pack_records(splats, geom.opacity, sub_op).detach()
    with torch.no_grad():
        k = cuda_raster.composite_fwd(ids, cnt, rec_sub, col_flow, ntx, True)
        p = cuda_raster.composite_tiles_plain(ids, cnt, rec_sub, col_flow, ntx, True)
    errs_f = {"image": float((k[0][..., :9] - p[0][..., :9]).abs().max()),
              "sub_alpha": float((k[1] - p[1]).abs().max()),
              "flow/tol": flow_err(k[0][..., 9:], p[0][..., 9:])}
    print(f"raster_fwd_sub CE=11 exposure-flow pass vs plain: {json.dumps(errs_f)}")
    require(errs_f["image"] <= IMG_ATOL and errs_f["sub_alpha"] <= IMG_ATOL
            and errs_f["flow/tol"] <= 1.0, f"exposure-flow pass forward {errs_f}")
    ms, plain_ms = time_fwd(ids, cnt, rec_sub, col_flow, True)
    ops, bytes_, pairs, _ = fwd_cost(ids, cnt, rec_sub, col_flow, True)
    instance_line("raster_fwd_sub CE=11 exposure-flow pass", ms, plain_ms, ops, bytes_,
                  pairs, 11, flow_instances.get("raster_fwd_sub CE=11", 0))

    # the flow-on mid render, forward and backward (phase 7's operands)
    args29 = bwd_inputs["d_flow_mid_ce29_sub"]
    _, _, rec29, col29, *_ = args29
    ms, plain_ms = time_fwd(ids, cnt, rec29, col29, True)
    ops, bytes_, pairs, _ = fwd_cost(ids, cnt, rec29, col29, True)
    instance_line("raster_fwd_sub CE=29 flow-on mid render", ms, plain_ms, ops, bytes_,
                  pairs, 29, flow_instances.get("raster_fwd_sub CE=29", 0))
    ms = cuda_ms(lambda: cuda_raster.composite_bwd(*args29), 50)
    plain_ms = cuda_ms(lambda: cuda_raster.composite_bwd_plain(*args29), 5)
    ops, bytes_, pairs, _ = bwd_cost(ids, cnt, rec29, col29, True)
    instance_line("raster_bwd_sub CE=29 flow-on mid render (with the zeroed outputs)", ms,
                  plain_ms, ops, bytes_, pairs, 29,
                  flow_instances.get("raster_bwd_sub CE=29", 0))

    # the flow-on mid render at E=11 and E=27: column groups of the <32>
    # instances (launches per group: one E=11 flow-on step, phase 10)
    for e_w in E_WIDE:
        CE = 2 * e_w + 11
        argsw = bwd_inputs[f"wide_mid_ce{CE}_sub"]
        _, _, recw, colw, *_ = argsw
        fg, bg_ = wide_groups[CE]

        def on_path(groups):
            if e_w != E_WIDE[0]:
                return "no path run here"
            counts = {k2: e11_instances.get(k2, 0) for k2 in groups}
            return f"{counts} in one E={e_w} step"

        ms, plain_ms = time_fwd(ids, cnt, recw, colw, True)
        ops, bytes_, pairs, _ = fwd_cost(ids, cnt, recw, colw, True)
        instance_line(f"raster_fwd_sub CE={CE} mid render at E={e_w} (groups {fg})", ms,
                      plain_ms, ops, bytes_, pairs, CE, on_path(fg))
        ms = cuda_ms(lambda: cuda_raster.composite_bwd(*argsw), 50)
        plain_ms = cuda_ms(lambda: cuda_raster.composite_bwd_plain(*argsw), 5)
        ops, bytes_, pairs, _ = bwd_cost(ids, cnt, recw, colw, True)
        instance_line(f"raster_bwd_sub CE={CE} mid render at E={e_w} (groups {bg_}; with the "
                      f"zeroed outputs)", ms, plain_ms, ops, bytes_, pairs, CE, on_path(bg_))

    # get_flow_static's composite: the static set at the view's camera, the
    # flow between its neighbours' cameras, depth and weight (CE = 2 + 2)
    s_means, s_quats = stat.xyz, G.act_rotation(stat.rotation)
    s_scales, s_opac = G.act_scaling(stat), G.act_opacity(stat)

    def proj(c):
        return projection.project(s_means, s_quats, s_scales, c.w2c, c.K, W, H,
                                  eps2d=cfg.eps2d, near=cfg.near, sigma_cut=cfg.sigma_cut)

    s_splats = proj(cam(0))
    s_bins = tiles.bin_gaussians(s_splats, W, H, tiles_per_gauss=cfg.tiles_per_gauss,
                                 max_per_tile=cfg.max_per_tile)
    ids4, cnt4 = s_bins.gauss_ids.contiguous(), s_bins.counts.contiguous()
    col4 = torch.cat([proj(cam(1)).means2d - proj(cam(2)).means2d, s_splats.depths[:, None],
                      torch.ones(len(s_means), 1, device=dev)], 1).detach().contiguous()
    rec4 = cuda_raster.pack_records(s_splats, s_opac).detach()
    with torch.no_grad():
        k = cuda_raster.composite_fwd(ids4, cnt4, rec4, col4, ntx)[0]
        p = cuda_raster.composite_tiles_plain(ids4, cnt4, rec4, col4, ntx)[0]
    errs4 = {"flow/tol": flow_err(k[..., :2], p[..., :2]),
             "alpha": float((k[..., 3] - p[..., 3]).abs().max()),
             "flow max px": float(p[..., :2].abs().max())}
    print(f"raster_fwd CE=4 get_flow_static vs plain: {json.dumps(errs4)}")
    require(errs4["flow/tol"] <= 1.0 and errs4["alpha"] <= IMG_ATOL,
            f"get_flow_static forward {errs4}")
    ms, plain_ms = time_fwd(ids4, cnt4, rec4, col4, False)
    ops, bytes_, pairs, _ = fwd_cost(ids4, cnt4, rec4, col4, False)
    instance_line("raster_fwd CE=4 get_flow_static", ms, plain_ms, ops, bytes_, pairs, 4,
                  f"{expo_instances.get('raster_fwd CE=4', 0)} in {N_EXPO} exposure updates")

    for key, case in (("raster_bwd", "a_latent_ce9"), ("raster_bwd_sub", "b_mid_ce11_sub")):
        args = bwd_inputs[case]
        _, _, rec, col, _, _, _, _, _, sub = args
        ms = cuda_ms(lambda: cuda_raster.composite_bwd(*args), 50)
        plain_ms = cuda_ms(lambda: cuda_raster.composite_bwd_plain(*args), 5)
        ops, bytes_, pairs, work = bwd_cost(ids, cnt, rec, col, sub)
        entry(key, ms, plain_ms, ops, bytes_, bwd_errs[case])
        print(f"{key}: {ms:.4f} ms kernel (with the zeroed outputs), {plain_ms:.3f} ms "
              f"plain, bound {bound(ops, bytes_):.4f} ms ({ops / 1e9:.3f} GOP, "
              f"{bytes_ / 1e6:.2f} MB, {pairs} pairs, {int(work['valid'])} kept, "
              f"T={T_tiles}, CE={col.shape[1]})")
    print(f"times: {json.dumps({k: round(v, 2) for k, v in times.items()})}")
    print(f"rates: {json.dumps(rates)}")

    phase("14 K ladder")
    # a 128x128 view at a quarter of the protocol's focal length: each of
    # its 64 tiles holds thousands of entries; opacities x0.1 keep the walks
    # from saturating, so the kernels walk deep into the lists
    t0 = time.time()
    k_mat = np.array(data.K[0], np.float32).copy()
    k_mat[0, 0] *= 0.25
    k_mat[1, 1] *= 0.25
    k_mat[0, 2] = k_mat[1, 2] = K_VIEW / 2
    cam_k = Camera(w2c=cam(0).w2c, K=torch.as_tensor(k_mat, device=dev), time=cam(0).time)
    geom_k, splats_k = R.assemble_project(stat, dyn, cam_k, K_VIEW, K_VIEW, data.max_time,
                                          config=cfg)
    splats_k = projection.ProjectedSplats(*(x.detach() for x in splats_k))
    opac_k = (0.1 * geom_k.opacity).detach()
    ones_k = torch.ones(len(opac_k), 1, device=dev)
    ext_k = torch.cat([geom_k.colors, splats_k.depths[:, None], ones_k], 1).detach().contiguous()
    # the latent render, the capacity validation's render, the mid render
    k_cols = {"CE=9": (geom_k.colors.detach().contiguous(), False),
              "CE=11": (ext_k, False), "CE=11+sub": (ext_k, True)}
    rng_k = np.random.default_rng(9)

    def k_ladder(fwd_ks, bwd_ks):
        """The forward at each K of ``fwd_ks`` and the backward at each of
        ``bwd_ks`` on the 128x128 view, against their plain versions, timed
        beside their bounds."""
        for K in sorted(set(fwd_ks) | set(bwd_ks)):
            bins_k = tiles.bin_gaussians(splats_k, K_VIEW, K_VIEW,
                                         tiles_per_gauss=cfg.tiles_per_gauss, max_per_tile=K)
            ids_k, cnt_k, ntx_k = (bins_k.gauss_ids.contiguous(), bins_k.counts.contiguous(),
                                   bins_k.n_tiles_x)
            for label, (col, sub) in k_cols.items():
                rec = cuda_raster.pack_records(splats_k, opac_k,
                                               opac_k * geom_k.dyn_mask if sub else None).detach()
                work = {}
                with torch.no_grad():
                    out, out2 = cuda_raster.composite_fwd(ids_k, cnt_k, rec, col, ntx_k, sub)
                    p_out, p_out2 = cuda_raster.composite_tiles_plain(ids_k, cnt_k, rec, col,
                                                                      ntx_k, sub, work=work)
                CE = col.shape[1]
                e = {"image": float((out[..., :9] - p_out[..., :9]).abs().max())}
                if CE > 9:
                    e.update(depth_tol=flow_err(out[..., 9], p_out[..., 9]),
                             weight=float((out[..., 10] - p_out[..., 10]).abs().max()))
                if sub:
                    e.update(sub_alpha=float((out2 - p_out2).abs().max()))
                slots = work["slots"]
                print(f"K={K} forward {label}: {json.dumps(e)}; entries per tile mean "
                      f"{float(cnt_k.float().mean()):.0f} max {int(cnt_k.max())}, slots walked "
                      f"max {int(slots.max())} mean {float(slots.float().mean()):.0f}")
                require(e["image"] <= IMG_ATOL and e.get("weight", 0.0) <= IMG_ATOL
                        and e.get("sub_alpha", 0.0) <= IMG_ATOL
                        and e.get("depth_tol", 0.0) <= 1.0, f"K={K} forward {label} {e}")
                require(int(slots.max()) > K // 2,
                        f"K={K}: the walks stopped at {int(slots.max())}")
                if K in fwd_ks:
                    ms, plain_ms = time_fwd(ids_k, cnt_k, rec, col, sub, ntx_k, 20, 3)
                    ops, bytes_, pairs, _ = fwd_cost(ids_k, cnt_k, rec, col, sub, ntx_k)
                    instance_line(f"raster_fwd{'_sub' if sub else ''} {label} at K={K} "
                                  f"({K_VIEW}x{K_VIEW}, T={ids_k.shape[0]})", ms, plain_ms,
                                  ops, bytes_, pairs, CE, "the ladder's")
                if K not in bwd_ks:
                    continue
                g = torch.as_tensor(rng_k.normal(size=out.shape).astype(np.float32), device=dev)
                g2 = (torch.as_tensor(rng_k.normal(size=out2.shape).astype(np.float32),
                                      device=dev) if sub else None)
                args = (ids_k, cnt_k, rec, col, out, out2, g, g2, ntx_k, sub)
                kb = cuda_raster.composite_bwd(*args)
                pb = cuda_raster.composite_bwd_plain(*args)
                torch.cuda.synchronize()
                n_rows = 7 if sub else 6
                rel = [float((kb[0][:, j] - pb[0][:, j]).abs().max())
                       / max(float(pb[0][:, j].abs().max()), 1e-30) for j in range(n_rows)]
                rel.append(float((kb[1] - pb[1]).abs().max())
                           / max(float(pb[1].abs().max()), 1e-30))
                print(f"K={K} backward {label}: max |k-p|/max|p| per column "
                      f"{[float(f'{r:.3g}') for r in rel]}")
                require(all(np.isfinite(rel)) and max(rel) <= BWD_REL,
                        f"K={K} backward {label}")
                ms = cuda_ms(lambda: cuda_raster.composite_bwd(*args), 20)
                plain_ms = cuda_ms(lambda: cuda_raster.composite_bwd_plain(*args), 3)
                ops, bytes_, pairs, _ = bwd_cost(ids_k, cnt_k, rec, col, sub, ntx_k)
                instance_line(f"raster_bwd{'_sub' if sub else ''} {label} at K={K} (with the "
                              f"zeroed outputs)", ms, plain_ms, ops, bytes_, pairs, CE,
                              "the ladder's")

    k_ladder(K_FWD, K_BWD)
    times["k_ladder_s"] = time.time() - t0

    # ---- the host loop ----
    from mobgs_tpu_torch.config import BlceParams
    from mobgs_tpu_torch.train import densify as D

    phase("15 host loop at protocol width")
    # the densify schedule brought forward: boundaries 8, 12, ..., 28 (static
    # densify rounds at 8, 12, 16, prunes at 20, 24, 28), opacity reset at 16,
    # exposure updates at 10, 20, 30; opthr just under the reset's 0.01 so
    # the prunes after the reset remove the Gaussians that kept fading
    loop_opt = OptimizationParams(
        iterations=10_000, batch_size=B_VIEWS, lambda_flow_loss=LAMBDA_FLOW,
        densify_from_iter=4, densification_interval=4, desicnt=3,
        opacity_reset_interval=16, densify_grad_threshold=LOOP_GRAD_THR, opthr=0.009)
    loop_blce = BlceParams(num_warp=E_WARP, start_warp_exposure=4)
    extent = L.scene_extent_from_cameras(data.w2c)
    ts_l = train_state()
    caps0 = (ts_l.stat.capacity, ts_l.dyn.capacity)
    observed = {}

    def on_eval(ts_now, it):
        observed[it] = (ts_now.stat.capacity, ts_now.dyn.capacity,
                        float(G.act_opacity(ts_now.stat).detach().max()))
        if it == LOOP_ITERS - 1:  # the last iteration's peak, at the grown capacity
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    cuda_raster.reset_launches()
    t0 = time.time()
    # the loop prints its events ([tile_max], [budgets], [grow]) as they happen
    ts_l, hist_l = L.train(ts_l, data, loop_opt, loop_blce, LOOP_ITERS, raster_cfg=cfg,
                           scene_extent=extent, seed=0, log_every=1, eval_every=1,
                           on_eval=on_eval, base_raster_cfg=cfg, deescalate_every=12,
                           max_capacity=LOOP_MAX_CAP, device=dev)
    torch.cuda.synchronize()
    loop_s = time.time() - t0
    peak_last = torch.cuda.max_memory_allocated(dev)
    loop_launches, loop_instances = dict(cuda_raster.launches), dict(cuda_raster.instance_launches)
    rates["loop_it_s"] = LOOP_ITERS / loop_s
    prev = 0.0
    for h in hist_l:
        it = h["iter"]
        # the host clock of the iteration, densify and the hooks' sync included
        dt_ms, prev = 1e3 * (h["elapsed"] - prev), h["elapsed"]
        print(f"  iter {it:2d} ({dt_ms:7.1f} ms): loss {h['loss']:.6f} flow {h['flow']:.4g} "
              f"psnr {h['psnr']:.3f} "
              f"live {h['n_stat']} + {h['n_dyn']} in {observed[it][0]} + {observed[it][1]} "
              f"slots, max_per_tile {h['max_per_tile']}, tile_max {h['tile_max']}, dropped "
              f"{h['densify_dropped_stat']} + {h['densify_dropped_dyn']}, max opacity "
              f"{observed[it][2]:.4f}")
    budgets, grown = [], []
    for h, h0 in zip(hist_l[1:], hist_l):
        if (h["max_per_tile"], h["tiles_per_gauss"]) != (h0["max_per_tile"], h0["tiles_per_gauss"]):
            budgets.append(f"{h0['iter']}: K {h0['max_per_tile']} -> {h['max_per_tile']}, "
                           f"tiles_per_gauss {h0['tiles_per_gauss']} -> {h['tiles_per_gauss']}")
        if observed[h["iter"]][:2] != observed[h0["iter"]][:2]:
            grown.append(f"{h['iter']}: {observed[h0['iter']][:2]} -> {observed[h['iter']][:2]}")
    print(f"loop events: budgets changed after iterations {json.dumps(budgets)}; "
          f"pools grew at {json.dumps(grown)}")
    print(f"loop: {rates['loop_it_s']:.3f} it/s over {LOOP_ITERS} iterations ({loop_s:.1f} s; "
          f"B={B_VIEWS} E={E_WARP} {W}x{H}, flow on, extent {extent:.4f}), slots "
          f"{caps0[0]} + {caps0[1]} -> {ts_l.stat.capacity} + {ts_l.dyn.capacity}, on {card}")
    print(f"loop launches ({LOOP_ITERS} iterations): {json.dumps(loop_launches)}; by instance "
          f"{json.dumps(loop_instances)}")
    print(f"peak device memory: {peak_last / 2**30:.3f} GiB over the last iteration at "
          f"{ts_l.stat.capacity} + {ts_l.dyn.capacity} slots (torch.cuda.max_memory_allocated), "
          f"on {card}")
    n_stat = [h["n_stat"] for h in hist_l]
    require(len(hist_l) == LOOP_ITERS and all(np.isfinite(h["loss"]) for h in hist_l),
            "loop history")
    require(n_stat[7] > n_stat[6], "no clone/split at the first densify boundary (8)")
    require(any(n_stat[i] < n_stat[i - 1] for i in (19, 23, 27)),
            "no static prune after the densify rounds")
    require(observed[16][2] <= 0.01 + 1e-6, f"opacity reset at 16: max {observed[16][2]}")
    require(loop_instances.get("raster_fwd CE=4", 0) == 4 * B_VIEWS // 2 * 3,
            f"three exposure updates of 4 CE=4 forwards: {loop_instances}")
    require(grown, "no pool grew")
    require(all(loop_launches[k] > 0 for k in loop_launches), f"loop launches {loop_launches}")
    times["loop_s"] = loop_s
    # one more step at the grown capacity and the last iteration's budgets:
    # its peak memory alone, the step and an exposure update through the
    # kernels against the plain route (the step also against the float64
    # compositor), and where its device time goes
    last_cfg = cfg._replace(max_per_tile=hist_l[-1]["max_per_tile"],
                            tiles_per_gauss=hist_l[-1]["tiles_per_gauss"])
    step_l = S.make_train_step(loop_opt, W, H, data.max_time, E_WARP, last_cfg,
                               spatial_lr_scale=extent)
    batch_l = L.make_batch(data, L.BatchSampler(FRAMES, B_VIEWS, seed=5).next_ids(), dev)
    step_l(ts_l, batch_l)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    ts_l, _ = step_l(ts_l, batch_l)
    torch.cuda.synchronize()
    peak_step = torch.cuda.max_memory_allocated(dev)
    print(f"peak device memory of one step at {ts_l.stat.capacity} + {ts_l.dyn.capacity} slots, "
          f"max_per_tile {last_cfg.max_per_tile}: {peak_step / 2**30:.3f} GiB, on {card}")
    print(f"the step at {ts_l.stat.capacity} + {ts_l.dyn.capacity} slots, max_per_tile "
          f"{last_cfg.max_per_tile}, tiles_per_gauss {last_cfg.tiles_per_gauss}, kernels vs plain:")
    step_vs_plain(loop_opt, ts_l, batch_l, rcfg=last_cfg, deep=True)
    expo_vs_plain(ts_l, last_cfg)
    # every budget the loop could composite at above phase 4's, forward and
    # backward on the K ladder's view, where phase 14 did not: the budgets it
    # ran at, the top budget of its capacity validations (the largest tile
    # occupancy seen, rounded up to a chunk) and the validation's and the
    # de-escalation's ladders below that top
    top = max(-(-max(h["tile_max"] for h in hist_l) // 128) * 128,
              max(h["max_per_tile"] for h in hist_l))
    loop_ks = {h["max_per_tile"] for h in hist_l} | {top} | {
        k for k in (384, 512, 768, 1024, 1536, 2048) if k <= top}
    loop_ks = sorted(k for k in loop_ks if k > cfg.max_per_tile)
    print(f"the K ladder at the loop's budgets {loop_ks}:")
    k_ladder([k for k in loop_ks if k not in K_FWD], [k for k in loop_ks if k not in K_BWD])
    _, busy = trace(lambda: step_l(ts_l, batch_l), f"flow-on step at the grown capacity "
                    f"({ts_l.stat.capacity} + {ts_l.dyn.capacity} slots, K={last_cfg.max_per_tile})")
    times["loop_grown_step_device_ms"] = busy / 1e3
    del ts_l, step_l

    phase("16 loop: kernels vs plain")
    # a reduced scene (128x72, 8 frames, 1500 + 400 seeds at capacity x1.25)
    # and the same schedule from 2: densify rounds at 4 and 6 (then
    # prunes), reset at 6, an exposure update at 10; the same seeds and
    # split noise through both routes
    t0 = time.time()
    from mobgs_tpu_torch.data import synthetic
    from mobgs_tpu_torch.ops.rasterize import RasterConfig
    small_cfg = RasterConfig(tiles_per_gauss=9, max_per_tile=256)
    data_s, traj_s = synthetic.generate(width=128, height=72, num_frames=8, n_static=300,
                                        n_dyn=80, blur_substeps=3, raster_cfg=small_cfg,
                                        device=dev)
    sp_s, sc_s, dt_s = synthetic.init_point_clouds(data_s, traj_s, 1500, 400)

    def small_state():
        st = G.create_state(sp_s, sc_s, np.zeros(len(sp_s), np.float32),
                            capacity=len(sp_s) * 5 // 4,
                            generator=torch.Generator(device=dev).manual_seed(0), device=dev)
        dy = G.create_state(dt_s[:, 0], np.full((len(dt_s), 3), 0.5, np.float32),
                            np.zeros(len(dt_s), np.float32), capacity=len(dt_s) * 5 // 4,
                            trajectory=torch.as_tensor(dt_s),
                            traj_times=torch.as_tensor(data_s.time), device=dev)
        return S.init_train_state(
            st, dy, init_sandwich(torch.Generator(device=dev).manual_seed(1), device=dev),
            B.init_blce(torch.Generator(device=dev).manual_seed(2), num_views=len(data_s.time),
                        num_warp=E_WARP, device=dev))

    small_opt = OptimizationParams(
        iterations=10_000, batch_size=B_VIEWS, lambda_flow_loss=LAMBDA_FLOW,
        densify_from_iter=2, densification_interval=2, desicnt=2, opacity_reset_interval=6,
        densify_grad_threshold=LOOP_GRAD_THR, opthr=0.009)
    small_blce = BlceParams(num_warp=E_WARP, start_warp_exposure=5)
    runs, rounds = {}, {"cuda": {}, "plain": {}}
    real_controller = D.control_gaussians
    for backend in ("cuda", "plain"):
        D.control_gaussians = recording_controller(real_controller, rounds[backend])
        try:
            runs[backend] = L.train(small_state(), data_s, small_opt, small_blce, N_SMALL_LOOP,
                                    raster_cfg=small_cfg._replace(backend=backend),
                                    scene_extent=L.scene_extent_from_cameras(data_s.w2c),
                                    seed=0, log_every=1, device=dev)
        finally:
            D.control_gaussians = real_controller
    (ts_k, hk), (ts_p, hp) = runs["cuda"], runs["plain"]
    require(len(hk) == len(hp) == N_SMALL_LOOP, "reduced loop history lengths")
    # a densify decision that flipped between the routes, and each round's
    # margin: min over live slots of |g - thr| / |g_kernels - g_plain|
    flip_it, margins = None, {}
    for key in sorted(rounds["cuda"]):
        if key not in rounds["plain"]:
            break
        (a, live, thr), (b, _, _) = rounds["cuda"][key], rounds["plain"][key]
        m = live & (a > 0)
        margins[f"{key[0]}{'d' if key[1] else 's'}"] = float(
            (np.abs(a - thr)[m] / np.maximum(np.abs(a - b)[m], 1e-30)).min())
        flipped = live & ((a >= thr) != (b >= thr))
        if flipped.any() and flip_it is None:
            flip_it = key[0]
            print(f"densify decision flipped at iteration {key[0]} ({'dynamic' if key[1] else 'static'}"
                  f" pool): {int(flipped.sum())} slots, |g - thr| "
                  f"{float(np.abs(a - thr)[flipped].min()):.3g} vs thr {thr:.3g}")
    print(f"densify margins (min |g - thr| / |g_k - g_p| per round): {json.dumps(margins)}")
    worst = 0.0
    for a, b in zip(hk, hp):
        if flip_it is not None and a["iter"] > flip_it:
            break
        rel = abs(a["loss"] - b["loss"]) / abs(b["loss"])
        worst = max(worst, rel)
        require(rel <= LOSS_RTOL, f"reduced loop iteration {a['iter']}: loss {a['loss']!r} "
                f"vs {b['loss']!r}")
        for key2 in ("n_stat", "n_dyn", "max_per_tile"):
            require(a[key2] == b[key2], f"reduced loop iteration {a['iter']}: {key2}")
    expo_rel = float(((ts_k.blce.exposure_expo - ts_p.blce.exposure_expo).abs()
                      / ts_p.blce.exposure_expo.abs()).max())
    print(f"reduced loop: worst loss rel diff {worst:.3g}; live "
          f"{[(h['n_stat'], h['n_dyn']) for h in hk]}; slots {ts_k.stat.capacity} + "
          f"{ts_k.dyn.capacity} (plain {ts_p.stat.capacity} + {ts_p.dyn.capacity}); exposures "
          f"max rel diff {expo_rel:.3g}")
    if flip_it is None:
        require((ts_k.stat.capacity, ts_k.dyn.capacity) == (ts_p.stat.capacity, ts_p.dyn.capacity),
                "reduced loop capacities")
        require(expo_rel <= EXPO_RTOL, f"reduced loop exposures {expo_rel:.3g}")
    require((ts_k.stat.capacity, ts_k.dyn.capacity) != (len(sp_s) * 5 // 4, len(dt_s) * 5 // 4),
            "the reduced loop grew no pool")
    require(not torch.equal(ts_k.blce.exposure_expo,
                            torch.full_like(ts_k.blce.exposure_expo, 0.4)),
            "the reduced loop updated no exposure")
    times["loop_vs_plain_s"] = time.time() - t0

    phase("17 train CLI")
    cli_phase(dev, card, times, rates)
    print(f"rates: {json.dumps(rates)}")

    phase("18 stereo run: train.sh and eval.sh")
    stereo_phase(dev, card, times)

    phase("19 registry runs: the train CLI on an iPhone and a Blender scene")
    reg_launches = registry_phase(dev, card, times, (train_state, data, cfg, opt_flow), trace)
    for e in entries:
        e["launches"] += reg_launches.get(e["name"], 0)
    print(f"the kernels' launches in the two registry runs: {json.dumps(reg_launches)}")

    phase("20 the rest of the library on the card")
    lib_launches = library_phase(dev, card, times, (stat, dyn, data, cfg))
    for e in entries:
        e["launches"] += lib_launches.get(e["name"], 0)
    print(f"the kernels' launches through the gsplat shim: {json.dumps(lib_launches)}")
    times["total_s"] = time.time() - t_start
    print(f"times: {json.dumps({k: round(v, 2) for k, v in times.items()})}")

    phase("21 result")
    print(json.dumps({"kernels": entries}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
