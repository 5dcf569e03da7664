"""The port's CUDA kernel on the card, held against its plain version.

Imports neither JAX nor the JAX package, so it also runs where only the
port is installed. Every test is marked ``gpu`` and skips without a CUDA
card (decided inside the test). Run on the card with
``python -m pytest tests/test_torch_gpu.py -m gpu``.

Tolerances: forward image and alpha atol 1e-4, depth rtol 1e-3 where
α > 1e-3 — the kernel sums in another order than the plain version (serial
walk vs cumprod and batched matmul) and contracts the sums into FMAs.
Backward, each gradient column within BWD_REL of its largest magnitude:
the kernel's per-pixel running sums, its warp reductions and its atomics
(whose order changes from run to run) sum in other orders than cumsum and
index_add_, and the suffix-anchor subtraction amplifies that by up to
1/(1 − α) ≤ 100. The train step's gradients through the kernels vs the
plain route: the same, per leaf, STEP_REL, looser for BLCE's pose leaves,
where the exp-map's 1/|w| axis normalisation multiplies the differences.
"""

import numpy as np
import pytest
import torch

from mobgs_tpu_torch.data.cameras import Camera
from mobgs_tpu_torch.models import gaussians as G
from mobgs_tpu_torch.models import render as R
from mobgs_tpu_torch.config import OptimizationParams
from mobgs_tpu_torch.models import blce as B
from mobgs_tpu_torch.models.sandwich import init_sandwich
from mobgs_tpu_torch.ops import cuda_raster, projection, tiles
from mobgs_tpu_torch.ops.rasterize import RasterConfig
from mobgs_tpu_torch.train import step as S

W, H = 64, 48
KMAT = np.array([[60.0, 0, W / 2], [0, 60.0, H / 2], [0, 0, 1]], np.float32)
TILE_PX = 16
ATOL = 1e-4
BWD_REL = 1e-4   # measured at most 1.2e-6 at the protocol view (chip_smoke.py)
STEP_REL = 1e-3  # measured at most 6e-7 per leaf at protocol shape
CASES = ("default", "sub", "alpha_only", "image_only", "wide_ce29")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _inputs(case, dev, n=300, K=128, seed=0):
    rng = np.random.default_rng(seed)
    means = rng.normal(size=(n, 3)).astype(np.float32)
    means[:, 2] += 6.0
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    scales = np.exp(rng.uniform(-3.5, -1.5, size=(n, 3))).astype(np.float32)
    to = lambda x: torch.as_tensor(x, device=dev)  # noqa: E731
    splats = projection.project(to(means), to(quats), to(scales),
                                torch.eye(4, device=dev), to(KMAT), W, H)
    bins = tiles.bin_gaussians(splats, W, H, tiles_per_gauss=36, max_per_tile=K)
    opac = to(rng.uniform(0.2, 0.95, size=n).astype(np.float32))
    width = 27 if case == "wide_ce29" else 9
    kw = dict(colors=to(rng.uniform(size=(n, width)).astype(np.float32)),
              background=to(np.linspace(0.05, 0.45, width).astype(np.float32)))
    if case == "sub":
        kw["sub_opacities"] = opac * to((np.arange(n) % 3 == 0).astype(np.float32))
    elif case == "alpha_only":
        kw = dict(colors=torch.zeros(n, 0, device=dev))
    elif case == "image_only":
        kw = dict(colors=kw["colors"], want_depth=False, want_alpha=False)
    return bins, splats, opac, kw


def _check(k, p, depth=True):
    for i, name in enumerate(("image", "alpha")):
        np.testing.assert_allclose(k[i].cpu().numpy(), p[i].cpu().numpy(),
                                   atol=ATOL, err_msg=name)
    if depth:
        m = (p[1] > 1e-3).cpu().numpy()
        np.testing.assert_allclose(k[2].cpu().numpy()[m], p[2].cpu().numpy()[m],
                                   rtol=1e-3, err_msg="depth")
    if len(p) == 4:
        np.testing.assert_allclose(k[3].cpu().numpy(), p[3].cpu().numpy(),
                                   atol=ATOL, err_msg="sub alpha")


@pytest.mark.gpu
@pytest.mark.parametrize("case", CASES)
def test_kernel_matches_plain_on_card(case, cuda):
    bins, splats, opac, kw = _inputs(case, cuda)
    cols = kw.pop("colors")
    before = dict(cuda_raster.launches)
    k = cuda_raster.composite_tiles(bins, splats, cols, opac, W, H,
                                    backend="cuda", **kw)
    p = cuda_raster.composite_tiles(bins, splats, cols, opac, W, H,
                                    backend="plain", **kw)
    torch.cuda.synchronize()
    name = "raster_fwd_sub" if "sub_opacities" in kw else "raster_fwd"
    assert cuda_raster.launches[name] == before[name] + 1
    assert len(k) == len(p)
    _check(k, p, depth=kw.get("want_depth", True))


@pytest.mark.gpu
def test_kernel_rejects_what_it_cannot_take(cuda):
    bins, splats, opac, kw = _inputs("default", cuda)
    rec = cuda_raster.pack_records(splats, opac)
    col = torch.zeros(opac.shape[0], 33, device=cuda)
    with pytest.raises(ValueError, match="CE=33"):
        cuda_raster.composite_fwd(bins.gauss_ids, bins.counts, rec, col,
                                  bins.n_tiles_x)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_raster.composite_fwd(bins.gauss_ids, bins.counts, rec,
                                  torch.zeros(3, opac.shape[0], device=cuda).T,
                                  bins.n_tiles_x)


@pytest.mark.gpu
def test_render_view_on_card_matches_cpu(cuda):
    rng = np.random.default_rng(1)
    pts = rng.normal(size=(200, 3)).astype(np.float32)
    pts[:, 2] += 6.0
    cols = rng.uniform(size=(200, 3)).astype(np.float32)
    tt = np.linspace(0, 1, 16).astype(np.float32)
    traj = pts[:100, None] + rng.normal(size=(100, 1, 3)).astype(np.float32) \
        * 0.3 * tt[None, :, None]
    gen = torch.Generator().manual_seed(0)
    stat = G.create_state(pts[100:], cols[100:], np.zeros(100, np.float32), 128,
                          generator=gen, device="cpu")
    dyn = G.create_state(pts[:100], cols[:100], np.zeros(100, np.float32), 128,
                         trajectory=torch.as_tensor(traj),
                         traj_times=torch.as_tensor(tt), device="cpu")
    sw = init_sandwich(torch.Generator().manual_seed(1), device="cpu")
    cam = Camera(torch.eye(4), torch.as_tensor(KMAT), torch.tensor(0.5))
    cfg = RasterConfig(max_per_tile=128)
    flags = dict(get_dynamic=True, get_static=True, subset_alpha_only=True)
    with torch.no_grad():
        on_cpu = R.render_view(stat, dyn, sw, cam, W, H, torch.zeros(3),
                               config=cfg, **flags)
        on_card = R.render_view(stat.to(cuda), dyn.to(cuda), sw.to(cuda),
                                Camera(*(x.to(cuda) for x in cam)), W, H,
                                torch.zeros(3, device=cuda), config=cfg, **flags)
    for field in ("image", "alpha", "d_alpha", "s_alpha"):
        np.testing.assert_allclose(getattr(on_card, field).cpu().numpy(),
                                   getattr(on_cpu, field).numpy(), atol=ATOL,
                                   err_msg=field)


def _rel_err(k, p):
    return float((k - p).abs().max()) / max(float(p.abs().max()), 1e-30)


# name: (random colour columns, + depth and ones columns, sub chain, scene).
# "binned" is a projected and binned scene; the others are tile lists
# written out (_edge_operands) for the kernel's edges.
BWD_CASES = {"image_only_ce9": (9, False, False, "binned"),
             "sub_ce11": (9, True, True, "binned"),
             "alpha_only_ce2": (0, True, False, "binned"),
             "wide_sub_ce29": (27, True, True, "binned"),
             "ragged_counts_ce9": (9, False, False, "ragged"),
             "ragged_counts_sub_ce11": (9, True, True, "ragged"),
             "k64_ce11": (9, True, False, "k64"),
             "k64_sub_ce2": (0, True, True, "k64"),
             "early_exit_sub_ce11": (9, True, True, "saturating"),
             "early_exit_ce9": (9, False, False, "saturating"),
             "wide_gauss_ce9": (9, False, False, "wide_gauss"),
             "wide_gauss_sub_ce29": (27, True, True, "wide_gauss")}


def _edge_operands(scene, C, ext, sub, dev):
    """Tile lists over a 5x4-tile image, written out to reach the kernel's
    edges: "ragged" counts (0, 1, and counts that are no multiple of the
    sub-chunk or the chunk), "k64" (K=64, chunk 64), "saturating" (K=256:
    in the left three tile columns 128 wide faint splats take every
    pixel's transmittance under 1e-4 in both chains, so those tiles stop
    after their first chunk of a full list; the other tiles' lists are
    ordinary, so each gradient column's scale comes from well-conditioned
    sums: a saturated chain's opacity gradient is T_final-sized, the
    difference of terms of size 1) and
    "wide_gauss" (Gaussian 0 covers the image and sits in every tile's
    list: every block adds into its row). Returns ids, counts, rec, col,
    ntx."""
    rng = np.random.default_rng(3)
    ntx, nty, n = 5, 4, 400
    T = ntx * nty
    K = {"k64": 64, "saturating": 256}.get(scene, 128)
    m2d = rng.uniform((0, 0), (TILE_PX * ntx, TILE_PX * nty), size=(n, 2))
    sd = rng.uniform(1.0, 6.0, size=(n, 2))
    th = rng.uniform(0, np.pi, n)
    cs, sn = np.cos(th), np.sin(th)
    conic = np.stack([cs ** 2 / sd[:, 0] ** 2 + sn ** 2 / sd[:, 1] ** 2,
                      cs * sn * (1 / sd[:, 0] ** 2 - 1 / sd[:, 1] ** 2),
                      sn ** 2 / sd[:, 0] ** 2 + cs ** 2 / sd[:, 1] ** 2], 1)
    op = rng.uniform(0.2, 0.95, n)
    ids = np.stack([rng.permutation(n)[:K] for _ in range(T)])
    if scene == "ragged":
        counts = np.array([0, 37, 1, 128, 100, 65, 3, 127, 13, 90] * 2)
    elif scene == "k64":
        counts = rng.integers(0, K + 1, T)
        counts[:3] = (0, 64, 37)
    elif scene == "wide_gauss":
        counts = rng.integers(20, K + 1, T)
        m2d[0], conic[0], op[0] = (40.0, 32.0), (1e-4, 0.0, 1e-4), 0.6
        ids = np.stack([rng.permutation(np.arange(1, n))[:K] for _ in range(T)])
        ids[np.arange(T), rng.integers(0, counts)] = 0
    else:  # saturating: the left three tile columns
        sat = np.arange(T) % ntx < 3
        counts = np.where(sat, K, rng.integers(60, 129, T))
        m2d[:128], conic[:128], op[:128] = (40.0, 32.0), (1e-6, 0.0, 1e-6), 0.0781
        ids = np.stack([np.concatenate([rng.permutation(128), 128 + rng.permutation(n - 128)[:128]])
                        if sat[t] else 128 + rng.permutation(n - 128)[:K] for t in range(T)])
    sub_op = op * (np.arange(n) % 3 == 0)
    if scene == "saturating":
        sub_op[:128] = op[:128]
    depth = rng.uniform(2.0, 8.0, n)
    rec = np.zeros((n, cuda_raster.R), np.float32)
    rec[:, :2], rec[:, 2:5], rec[:, 5] = m2d, conic, op
    if sub:
        rec[:, 6] = sub_op
    cols = [rng.uniform(size=(n, C))]
    if ext:
        cols += [depth[:, None], np.ones((n, 1))]
    to = lambda x, dt=torch.float32: torch.as_tensor(  # noqa: E731
        np.ascontiguousarray(x), dtype=dt, device=dev)
    return (to(ids, torch.int32), to(counts, torch.int32), to(rec),
            to(np.concatenate(cols, 1)), ntx)


def _bwd_args(case, dev):
    """(ids, counts, rec, col, out, out2, g, g2, ntx, sub) of a case, with
    the forward kernel's outputs and seeded upstream gradients."""
    C, ext, sub, scene = BWD_CASES[case]
    rng = np.random.default_rng(2)
    if scene == "binned":
        bins, splats, opac, kw = _inputs("sub", dev, seed=1)
        n = opac.shape[0]
        cols = [torch.as_tensor(rng.uniform(size=(n, C)).astype(np.float32), device=dev)]
        if ext:
            cols += [splats.depths[:, None], torch.ones(n, 1, device=dev)]
        col = torch.cat(cols, 1).contiguous()
        rec = cuda_raster.pack_records(splats, opac, kw["sub_opacities"] if sub else None)
        ids, cnt, ntx = bins.gauss_ids.contiguous(), bins.counts.contiguous(), bins.n_tiles_x
    else:
        ids, cnt, rec, col, ntx = _edge_operands(scene, C, ext, sub, dev)
    with torch.no_grad():
        out, out2 = cuda_raster.composite_fwd(ids, cnt, rec, col, ntx, sub)
    g = torch.as_tensor(rng.normal(size=out.shape).astype(np.float32), device=dev)
    g2 = (torch.as_tensor(rng.normal(size=out2.shape).astype(np.float32), device=dev)
          if sub else None)
    return ids, cnt, rec, col, out, out2, g, g2, ntx, sub


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(BWD_CASES))
def test_backward_kernel_matches_plain_on_card(case, cuda):
    args = _bwd_args(case, cuda)
    sub = args[-1]
    name = "raster_bwd_sub" if sub else "raster_bwd"
    before = cuda_raster.launches[name]
    k = cuda_raster.composite_bwd(*args)
    p = cuda_raster.composite_bwd_plain(*args)
    torch.cuda.synchronize()
    assert cuda_raster.launches[name] == before + 1
    n_rows = 7 if sub else 6
    for j in range(n_rows):
        assert float(p[0][:, j].abs().max()) > 0, j
        assert _rel_err(k[0][:, j], p[0][:, j]) <= BWD_REL, j
    assert not k[0][:, n_rows:].any()
    assert _rel_err(k[1], p[1]) <= BWD_REL
    if BWD_CASES[case][3] == "saturating":
        work = {}
        ids, cnt, rec, col, *_ = args
        cuda_raster.composite_tiles_plain(ids, cnt, rec, col, args[8], sub, work=work)
        full = cnt == 256
        assert full.any() and (work["slots"][full] == 128).all()  # stopped after chunk 1


@pytest.mark.gpu
def test_backward_kernel_repeats_on_card(cuda):
    """Two launches on the same inputs agree within BWD_REL per column: the
    atomics across tiles add in an order that changes from run to run."""
    args = _bwd_args("wide_gauss_sub_ce29", cuda)
    a = cuda_raster.composite_bwd(*args)
    b = cuda_raster.composite_bwd(*args)
    torch.cuda.synchronize()
    for j in range(7):
        assert _rel_err(a[0][:, j], b[0][:, j]) <= BWD_REL, j
    assert _rel_err(a[1], b[1]) <= BWD_REL


def _small_train_state(dev, seed=0):
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(260, 3)).astype(np.float32)
    pts[:, 2] = pts[:, 2] * 0.5 + 6.0
    cols = rng.uniform(size=(260, 3)).astype(np.float32)
    tt = np.linspace(0, 1, 6).astype(np.float32)
    traj = pts[:60, None] + rng.normal(size=(60, 1, 3)).astype(np.float32) \
        * 0.3 * tt[None, :, None]
    stat = G.create_state(pts[60:], cols[60:], np.zeros(200, np.float32), 256,
                          generator=torch.Generator(device=dev).manual_seed(0),
                          device=dev)
    dyn = G.create_state(pts[:60], cols[:60], np.zeros(60, np.float32), 64,
                         trajectory=torch.as_tensor(traj),
                         traj_times=torch.as_tensor(tt), device=dev)
    sw = init_sandwich(torch.Generator(device=dev).manual_seed(1), device=dev)
    blce = B.init_blce(torch.Generator(device=dev).manual_seed(2), num_views=6,
                       num_warp=3, device=dev)
    to = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=dev)  # noqa: E731
    batch = S.Batch(view_idx=torch.tensor([1, 4], device=dev),
                    w2c=to(np.tile(np.eye(4), (2, 1, 1))), K=to(np.stack([KMAT] * 2)),
                    time=to([0.2, 0.8]), image=to(rng.uniform(size=(2, H, W, 3))),
                    depth=to(rng.uniform(4, 8, size=(2, H, W))),
                    blur_feat=to([0.3, 0.5]))
    return S.init_train_state(stat, dyn, sw, blce), batch


@pytest.mark.gpu
def test_train_step_kernels_match_plain_on_card(cuda):
    """One flow-off step's loss and gradients (B=2, E=3) through the
    kernels and through the plain route, from the same state and batch."""
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False  # the SSIM convolution in full f32
    try:
        _step_kernels_vs_plain(cuda)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32


def _step_kernels_vs_plain(cuda):
    ts, batch = _small_train_state(cuda)
    opt = OptimizationParams(iterations=100, lambda_flow_loss=0.0)
    cfg = RasterConfig(max_per_tile=256)
    leaves = [*G.split_diff(ts.stat)[0], *G.split_diff(ts.dyn)[0],
              *S.sandwich_leaves(ts.sandwich), *ts.blce.params.leaves()]
    res = {}
    for backend in ("cuda", "plain"):
        fwd = S.make_forward(opt, W, H, 1.0, 3, cfg._replace(backend=backend))
        off = torch.zeros((2, 320, 2), device=cuda, requires_grad=True)
        total, _ = fwd(ts.stat, ts.dyn, ts.sandwich, ts.blce, off, batch)
        res[backend] = (float(total.detach()), torch.autograd.grad(
            total, leaves + [off], allow_unused=True))
    np.testing.assert_allclose(res["cuda"][0], res["plain"][0], rtol=1e-5)
    n_checked = 0
    for k, p in zip(res["cuda"][1], res["plain"][1]):
        if p is None or not p.any():
            assert k is None or not k.any()
            continue
        n_checked += 1
        assert _rel_err(k, p) <= STEP_REL
    assert n_checked > 20
    before = dict(cuda_raster.launches)
    ts, m = S.make_train_step(opt, W, H, 1.0, 3, cfg)(ts, batch)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(m.loss)) and ts.step == 1
    # per view: 2 latent renders and the mid render with the sub chain
    assert {k: cuda_raster.launches[k] - before[k] for k in before} == {
        "raster_fwd": 4, "raster_fwd_sub": 2, "raster_bwd": 4, "raster_bwd_sub": 2}
