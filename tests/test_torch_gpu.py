"""The port's CUDA kernel on the card, held against its plain version.

Imports neither JAX nor the JAX package, so it also runs where only the
port is installed. Every test is marked ``gpu`` and skips without a CUDA
card (decided inside the test). Run on the card with
``python -m pytest tests/test_torch_gpu.py -m gpu``.

Tolerances: forward image and alpha atol 1e-4, depth rtol 1e-3 where
α > 1e-3 — the kernel sums in another order than the plain version (serial
walk vs cumprod and batched matmul) and contracts the sums into FMAs; on
written-out tile lists its raw output within 1e-4. Two forward launches on
the same inputs agree to the bit (no atomics).
The exposure update through the kernels vs the plain route: rtol 1e-3 on
the new exposures, medians of ratios of composited flow magnitudes.
Backward, each gradient column within BWD_REL of its largest magnitude:
the kernel's per-pixel running sums, its warp reductions and its atomics
(whose order changes from run to run) sum in other orders than cumsum and
index_add_, and the suffix-anchor subtraction amplifies that by up to
1/(1 − α) ≤ 100. The train step's gradients through the kernels vs the
plain route, flow off and flow on: the same, per leaf, STEP_REL, looser for
BLCE's pose leaves, where the exp-map's 1/|w| axis normalisation
multiplies the differences. Composites wider than 32 columns (column
groups) and max_per_tile up to 2560 at the same tolerances as the rest.
Densify on the card vs the CPU: masks and drop counts exactly, rows 1e-6
(the same formulas; the split noise is drawn on the CPU). Six loop
iterations through the kernels vs the plain route: loss rtol 1e-5 per
iteration, live counts, budgets and capacities equal.
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
from mobgs_tpu_torch.train import densify as D
from mobgs_tpu_torch.train import step as S

W, H = 64, 48
KMAT = np.array([[60.0, 0, W / 2], [0, 60.0, H / 2], [0, 0, 1]], np.float32)
TILE_PX = 16
ATOL = 1e-4
BWD_REL = 1e-4   # measured at most 1.2e-6 at the protocol view (chip_smoke.py)
STEP_REL = 1e-3  # measured at most 6e-7 per leaf at protocol shape
CASES = ("default", "sub", "alpha_only", "image_only", "wide_ce29", "wide_ce33_sub",
         "wide_ce65_sub")
# colour columns of the wide cases (the flow-on mid render at E = 9, 11, 27:
# 9 + 2E colours and flows, + depth and weight = CE 29, 33, 65)
WIDTH = {"wide_ce29": 27, "wide_ce33_sub": 31, "wide_ce65_sub": 63}
# the forward on the tile lists of _edge_operands: (scene, random colour
# columns, + depth and ones columns, sub chain) at CE = 2, 4 (get_flow_static),
# 9, 11 + sub and 29 + sub; counts that are no multiple of a thread's pixels
# or of a chunk, count 0, an exit after chunk 1 in both chains, a Gaussian in
# every list
FWD_EDGE = {f"{scene}_{width}": (scene, *spec)
            for scene in ("ragged", "k64", "saturating", "wide_gauss")
            for width, spec in (("ce2", (0, True, False)), ("ce4", (2, True, False)),
                                ("ce9", (9, False, False)),
                                ("ce11_sub", (9, True, True)),
                                ("ce29_sub", (27, True, True)))}


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
    width = WIDTH.get(case, 9)
    kw = dict(colors=to(rng.uniform(size=(n, width)).astype(np.float32)),
              background=to(np.linspace(0.05, 0.45, width).astype(np.float32)))
    if case.endswith("sub"):
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
@pytest.mark.parametrize("case", CASES + tuple(FWD_EDGE))
def test_kernel_matches_plain_on_card(case, cuda):
    if case in FWD_EDGE:
        _edge_forward_matches_plain(case, cuda)
        return
    bins, splats, opac, kw = _inputs(case, cuda)
    cols = kw.pop("colors")
    before = dict(cuda_raster.launches)
    k = cuda_raster.composite_tiles(bins, splats, cols, opac, W, H,
                                    backend="cuda", **kw)
    p = cuda_raster.composite_tiles(bins, splats, cols, opac, W, H,
                                    backend="plain", **kw)
    torch.cuda.synchronize()
    name = "raster_fwd_sub" if "sub_opacities" in kw else "raster_fwd"
    ce = cols.shape[1] + kw.get("want_depth", True) + kw.get("want_alpha", True)
    assert cuda_raster.launches[name] == before[name] + len(cuda_raster.column_groups(ce))
    assert len(cuda_raster.column_groups(ce)) == {33: 2, 65: 3}.get(ce, 1)
    assert len(k) == len(p)
    _check(k, p, depth=kw.get("want_depth", True))


@pytest.mark.gpu
def test_kernel_rejects_what_it_cannot_take(cuda):
    bins, splats, opac, kw = _inputs("default", cuda)
    rec = cuda_raster.pack_records(splats, opac)
    col = torch.zeros(opac.shape[0], 0, device=cuda)
    with pytest.raises(ValueError, match="CE=0"):
        cuda_raster.composite_fwd(bins.gauss_ids, bins.counts, rec, col,
                                  bins.n_tiles_x)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_raster.composite_fwd(bins.gauss_ids, bins.counts, rec,
                                  torch.zeros(3, opac.shape[0], device=cuda).T,
                                  bins.n_tiles_x)
    # records are copied 16 bytes at a time: a contiguous view 4 bytes off
    shifted = torch.zeros(rec.numel() + 1, device=cuda)[1:].view(rec.shape)
    with pytest.raises(ValueError, match="16-byte aligned"):
        cuda_raster.composite_fwd(bins.gauss_ids, bins.counts, shifted,
                                  torch.zeros(opac.shape[0], 3, device=cuda),
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
             "wide_sub_ce33": (31, True, True, "binned"),
             "wide_sub_ce65": (63, True, True, "binned"),
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


def _edge_forward_matches_plain(case, dev):
    scene, C, ext, sub = FWD_EDGE[case]
    ids, cnt, rec, col, ntx = _edge_operands(scene, C, ext, sub, dev)
    name = "raster_fwd_sub" if sub else "raster_fwd"
    before = cuda_raster.launches[name]
    work = {}
    with torch.no_grad():
        k = cuda_raster.composite_fwd(ids, cnt, rec, col, ntx, sub)
        p = cuda_raster.composite_tiles_plain(ids, cnt, rec, col, ntx, sub, work=work)
    torch.cuda.synchronize()
    assert cuda_raster.launches[name] == before + 1
    np.testing.assert_allclose(k[0].cpu().numpy(), p[0].cpu().numpy(), atol=ATOL)
    if sub:
        np.testing.assert_allclose(k[1].cpu().numpy(), p[1].cpu().numpy(), atol=ATOL)
    assert float(p[0].abs().max()) > 0
    assert not k[0][cnt == 0].any()  # a tile with no slot writes zeros
    if scene == "saturating":
        full = cnt == 256
        assert full.any() and (work["slots"][full] == 128).all()  # stopped after chunk 1


@pytest.mark.gpu
@pytest.mark.parametrize("case", ("ragged_ce9", "saturating_ce11_sub", "wide_gauss_ce29_sub",
                                  "wide_gauss_ce4"))
def test_forward_kernel_repeats_bitwise_on_card(case, cuda):
    """The forward has no atomics and a fixed order of operations per
    pixel: two launches on the same inputs agree to the bit."""
    scene, C, ext, sub = FWD_EDGE[case]
    ids, cnt, rec, col, ntx = _edge_operands(scene, C, ext, sub, cuda)
    with torch.no_grad():
        a = cuda_raster.composite_fwd(ids, cnt, rec, col, ntx, sub)
        b = cuda_raster.composite_fwd(ids, cnt, rec, col, ntx, sub)
    torch.cuda.synchronize()
    assert torch.equal(a[0], b[0])
    assert not sub or torch.equal(a[1], b[1])


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
    assert cuda_raster.launches[name] == before + len(cuda_raster.column_groups(args[3].shape[1]))
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


def _small_train_state(dev, seed=0, num_warp=3):
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
                       num_warp=num_warp, device=dev)
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
    _with_f32_convolutions(_step_kernels_vs_plain, cuda, 0.0)


@pytest.mark.gpu
def test_flow_train_step_kernels_match_plain_on_card(cuda):
    """As the flow-off test, with the flow-warp loss on (λ = 1e-2): per view
    two exposure-flow passes (CE=11 + sub) and the mid render with 2·E flow
    columns (CE = 9 + 6 + 2 + sub), forward and backward."""
    _with_f32_convolutions(_step_kernels_vs_plain, cuda, 1e-2)


@pytest.mark.gpu
def test_flow_train_step_e11_kernels_match_plain_on_card(cuda):
    """The flow-on step at E=11: its mid render is CE = 9 + 22 + 2 = 33 with
    the sub chain, wider than one kernel instance, so it runs in two column
    groups (C.1), forward and backward; the exposure-flow passes stay
    CE=11 + sub."""
    _with_f32_convolutions(_step_kernels_vs_plain, cuda, 1e-2, 11)


def _with_f32_convolutions(fn, *args):
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False  # the SSIM convolution in full f32
    try:
        fn(*args)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32


def _step_kernels_vs_plain(cuda, lambda_flow, num_warp=3):
    E = num_warp
    ts, batch = _small_train_state(cuda, num_warp=E)
    opt = OptimizationParams(iterations=100, lambda_flow_loss=lambda_flow)
    cfg = RasterConfig(max_per_tile=256)
    leaves = [*G.split_diff(ts.stat)[0], *G.split_diff(ts.dyn)[0],
              *S.sandwich_leaves(ts.sandwich), *ts.blce.params.leaves()]
    res = {}
    for backend in ("cuda", "plain"):
        fwd = S.make_forward(opt, W, H, 1.0, E, cfg._replace(backend=backend))
        off = torch.zeros((2, 320, 2), device=cuda, requires_grad=True)
        total, aux = fwd(ts.stat, ts.dyn, ts.sandwich, ts.blce, off, batch)
        res[backend] = (float(total.detach()), float(aux["flow"].detach()), torch.autograd.grad(
            total, leaves + [off], allow_unused=True))
    np.testing.assert_allclose(res["cuda"][0], res["plain"][0], rtol=1e-5)
    np.testing.assert_allclose(res["cuda"][1], res["plain"][1], rtol=1e-5)
    assert (res["cuda"][1] > 0) == (lambda_flow > 0)
    n_checked = 0
    for k, p in zip(res["cuda"][2], res["plain"][2]):
        if p is None or not p.any():
            assert k is None or not k.any()
            continue
        n_checked += 1
        assert _rel_err(k, p) <= STEP_REL
    assert n_checked > 20
    before = dict(cuda_raster.launches)
    ts, m = S.make_train_step(opt, W, H, 1.0, E, cfg)(ts, batch)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(m.loss)) and ts.step == 1
    # per view: E-1 latent renders and the mid render with the sub chain (in
    # column groups past CE=32), and with flow on E-1 exposure-flow passes
    # with it too
    mid_ce = 9 + 2 * E + 2 if lambda_flow > 0 else 11
    n_sub = 2 * len(cuda_raster.column_groups(mid_ce)) + (2 * (E - 1) if lambda_flow > 0 else 0)
    assert {k: cuda_raster.launches[k] - before[k] for k in before} == {
        "raster_fwd": 2 * (E - 1), "raster_fwd_sub": n_sub,
        "raster_bwd": 2 * (E - 1), "raster_bwd_sub": n_sub}


@pytest.mark.gpu
def test_exposure_update_kernels_match_plain_on_card(cuda):
    """``make_exposure_update`` through the kernels and through the plain
    route on a batch with an endpoint view: the new exposures within 1e-3
    (a median of ratios of composited flow magnitudes), written only at the
    batch's views; two CE=4 forward launches per view and no backward."""
    ts, _ = _small_train_state(cuda)
    V = 6
    w2c = np.tile(np.eye(4, dtype=np.float32), (V, 1, 1))
    for v in range(V):
        a = 0.05 * (v - V / 2)
        w2c[v, :3, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]]
        w2c[v, :3, 3] = [0.1 * v - 0.25, 0.02 * v, 0.05 * v]
    ids = np.array([0, 3])
    to = lambda x, dt=torch.float32: torch.as_tensor(np.asarray(x), dtype=dt, device=cuda)  # noqa: E731
    args = (to(ids, torch.int64), to(w2c[ids]), to(np.stack([KMAT] * 2)), to([0.0, 0.6]),
            to([0.3, 0.5]), to(w2c[np.minimum(ids + 1, V - 1)]),
            to(w2c[np.maximum(ids - 1, 0)]), to((ids == 0) | (ids == V - 1), torch.bool))
    cfg = RasterConfig(max_per_tile=256)
    old = ts.blce.exposure_expo.clone()
    before = dict(cuda_raster.launches)
    k = S.make_exposure_update(W, H, 1.0, 3, cfg)(ts, *args).blce.exposure_expo
    torch.cuda.synchronize()
    assert {n: cuda_raster.launches[n] - before[n] for n in before} == {
        "raster_fwd": 4, "raster_fwd_sub": 0, "raster_bwd": 0, "raster_bwd_sub": 0}
    p = S.make_exposure_update(W, H, 1.0, 3, cfg._replace(backend="plain"))(
        ts, *args).blce.exposure_expo
    assert bool(torch.isfinite(k).all())
    np.testing.assert_allclose(k.cpu().numpy(), p.cpu().numpy(), rtol=1e-3)
    rest = np.setdiff1d(np.arange(V), ids)
    assert torch.equal(k[rest], old[rest]) and torch.equal(ts.blce.exposure_expo, old)


def _deep_operands(K, sub, dev):
    """A binned scene whose tiles hold more than K entries each and whose
    walks do not saturate early (opacities 0.01-0.03), so the kernels walk
    deep into lists of K entries; CE=9, or 9 + depth + weight with the sub
    chain."""
    rng = np.random.default_rng(4)
    n = 3000 if K <= 2048 else 4000
    means = rng.normal(size=(n, 3)).astype(np.float32) * np.float32([0.6, 0.45, 0.3])
    means[:, 2] += 6.0
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    scales = np.exp(rng.uniform(-3.0, -2.0, size=(n, 3))).astype(np.float32)
    to = lambda x: torch.as_tensor(x, device=dev)  # noqa: E731
    splats = projection.project(to(means), to(quats), to(scales), torch.eye(4, device=dev),
                                to(KMAT), W, H)
    bins = tiles.bin_gaussians(splats, W, H, tiles_per_gauss=36, max_per_tile=K)
    opac = to(rng.uniform(0.01, 0.03, size=n).astype(np.float32))
    cols = [to(rng.uniform(size=(n, 9)).astype(np.float32))]
    if sub:
        cols += [splats.depths[:, None], torch.ones(n, 1, device=dev)]
    rec = cuda_raster.pack_records(splats, opac, opac * to((np.arange(n) % 3 == 0)
                                                           .astype(np.float32)) if sub else None)
    return (bins.gauss_ids.contiguous(), bins.counts.contiguous(), rec,
            torch.cat(cols, 1).contiguous(), bins.n_tiles_x)


@pytest.mark.gpu
@pytest.mark.parametrize("kernel,K", [("fwd", 1024), ("fwd", 1536), ("fwd", 2048),
                                      ("fwd", 2560), ("bwd", 1024), ("bwd", 1536),
                                      ("bwd", 2048), ("bwd", 2560)])
@pytest.mark.parametrize("sub", [False, True])
def test_large_max_per_tile_matches_plain_on_card(kernel, K, sub, cuda):
    """max_per_tile up to the loop's escalation ladder (1536), the
    validation's reference budget (2048) and beyond, where the capacity
    validation escalates to the largest occupancy it saw (2560 at the
    protocol view): the walks reach past the middle of the lists, and the
    kernels agree with the plain versions."""
    ids, cnt, rec, col, ntx = _deep_operands(K, sub, cuda)
    work = {}
    with torch.no_grad():
        out, out2 = cuda_raster.composite_fwd(ids, cnt, rec, col, ntx, sub)
        p = cuda_raster.composite_tiles_plain(ids, cnt, rec, col, ntx, sub, work=work)
    torch.cuda.synchronize()
    assert int(cnt.max()) == K and int(work["slots"].max()) > K // 2
    if kernel == "fwd":
        np.testing.assert_allclose(out.cpu().numpy(), p[0].cpu().numpy(), atol=ATOL)
        if sub:
            np.testing.assert_allclose(out2.cpu().numpy(), p[1].cpu().numpy(), atol=ATOL)
        return
    rng = np.random.default_rng(5)
    g = torch.as_tensor(rng.normal(size=out.shape).astype(np.float32), device=cuda)
    g2 = torch.as_tensor(rng.normal(size=out2.shape).astype(np.float32),
                         device=cuda) if sub else None
    args = (ids, cnt, rec, col, out, out2, g, g2, ntx, sub)
    k = cuda_raster.composite_bwd(*args)
    pb = cuda_raster.composite_bwd_plain(*args)
    for j in range(7 if sub else 6):
        assert _rel_err(k[0][:, j], pb[0][:, j]) <= BWD_REL, j
    assert _rel_err(k[1], pb[1]) <= BWD_REL


def _state_with_stats(dev):
    """A small training state whose densify statistics send some Gaussians
    to clone and some to split, on a pool with few free slots."""
    ts, _ = _small_train_state(torch.device("cpu"))
    rng = np.random.default_rng(6)
    M = ts.stat.capacity
    g = 1e-3 * np.exp(rng.uniform(-1.5, 1.5, size=M)).astype(np.float32)
    stats = D.DensifyStats(torch.as_tensor(2 * g), torch.full((M,), 2.0),
                           torch.zeros(M))
    with torch.no_grad():
        ts.stat.scaling.add_(torch.as_tensor(rng.uniform(-1.0, 1.0, size=(M, 3))
                                             .astype(np.float32)))
    if dev.type == "cuda":
        ts = _to_device(ts, dev)
        stats = D.DensifyStats(*(x.to(dev) for x in stats))
    return ts, stats


def _to_device(ts, dev):
    from mobgs_tpu_torch.io import checkpoint
    return checkpoint.unflatten_train_state(checkpoint.flatten_train_state(ts), dev)


@pytest.mark.gpu
def test_densify_clone_split_on_card_matches_cpu(cuda):
    """Clone and split on the card and on the CPU from the same state and
    statistics (the split noise is drawn on the CPU, keyed): the live masks
    and drop counts equal, rows within 1e-6."""
    out = {}
    for dev in (torch.device("cpu"), cuda):
        ts, stats = _state_with_stats(dev)
        st, opt, _, dropped = D.densify_clone_split(ts.stat, stats, ts.stat_opt, (0, 4, 1),
                                                    1e-3, percent_dense=0.01, scene_extent=5.0)
        out[dev.type] = (st, opt, int(dropped))
    (sc, oc, dc), (sk, ok, dk) = out["cpu"], out["cuda"]
    assert dc == dk > 0
    assert torch.equal(sc.live, sk.live.cpu()) and int(sc.num_live()) > 200
    for f in G.GaussianState._fields:
        np.testing.assert_allclose(getattr(sk, f).detach().cpu().numpy(),
                                   getattr(sc, f).detach().numpy(), atol=1e-6, rtol=1e-6,
                                   err_msg=f)
    for a, b in zip(ok.mu + ok.nu, oc.mu + oc.nu):
        assert torch.equal(a.cpu(), b)


@pytest.mark.gpu
def test_grow_pool_on_card(cuda):
    ts, _ = _state_with_stats(cuda)
    M = ts.stat.capacity
    st, opt, stats, cap = D.grow_pool(ts.stat, ts.stat_opt, ts.stat_stats, dropped=500)
    # 1.5 x (256 + 500), in 1024s; a new module, the old pool untouched
    assert cap == 2048 and st.capacity == cap and st is not ts.stat and ts.stat.capacity == M
    assert st.xyz.device.type == "cuda" and all(m.shape[0] == cap for m in opt.mu + opt.nu)
    assert torch.equal(st.xyz[:M], ts.stat.xyz) and torch.equal(st.live[:M], ts.stat.live)
    assert not st.live[M:].any() and bool((st.control_num[M:] == 4).all())
    assert not any(m[M:].any() for m in opt.mu + opt.nu) and not stats.denom[M:].any()


@pytest.mark.gpu
def test_train_loop_kernels_match_plain_on_card(cuda):
    """Six iterations of ``train/loop.py::train`` flow on, with densify
    rounds at 2, 4 and 6 and a pool that grows, through the kernels and
    through the plain route from the same state: the same live counts and
    capacities, loss per iteration within 1e-5."""
    from mobgs_tpu_torch.config import BlceParams
    from mobgs_tpu_torch.data.synthetic import SceneData
    from mobgs_tpu_torch.train import loop as L
    V = 6
    w2c = np.tile(np.eye(4, dtype=np.float32), (V, 1, 1))
    for v in range(V):
        a = 0.05 * (v - V / 2)
        w2c[v, :3, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]]
        w2c[v, :3, 3] = [0.1 * v - 0.25, 0.02 * v, 0.05 * v]
    rng = np.random.default_rng(7)
    data = SceneData(w2c=w2c, K=np.tile(KMAT, (V, 1, 1)),
                     time=np.linspace(0, 1, V).astype(np.float32),
                     images=rng.uniform(size=(V, H, W, 3)).astype(np.float32),
                     depths=rng.uniform(4.0, 8.0, size=(V, H, W)).astype(np.float32),
                     blur_feats=rng.uniform(0.2, 0.6, size=V).astype(np.float32),
                     masks=np.zeros((V, H, W), np.float32), width=W, height=H,
                     max_time=1.0, test_w2c=w2c,
                     test_images=np.zeros((V, H, W, 3), np.float32))
    opt = OptimizationParams(iterations=100, batch_size=2, densify_from_iter=1,
                             densification_interval=2, desicnt=2, opacity_reset_interval=4,
                             densify_grad_threshold=1e-5)
    hist = {}
    for backend in ("cuda", "plain"):
        ts, _ = _small_train_state(cuda)
        ts, hist[backend] = L.train(ts, data, opt, BlceParams(num_warp=3), 6,
                                    raster_cfg=RasterConfig(max_per_tile=256, backend=backend),
                                    scene_extent=6.0, log_every=1, device=cuda)
        hist[backend].append((ts.stat.capacity, ts.dyn.capacity))
    assert hist["cuda"][-1] == hist["plain"][-1] != (256, 64)
    for a, b in zip(hist["cuda"][:-1], hist["plain"][:-1], strict=True):
        assert (a["n_stat"], a["n_dyn"], a["max_per_tile"]) == (b["n_stat"], b["n_dyn"],
                                                                b["max_per_tile"])
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=1e-5, err_msg=str(a["iter"]))


CLI_OVERLAY = """_base_ = {base!r}
ModelHiddenParams = dict(
    kplanes_config={{'grid_dimensions': 2, 'input_coordinate_dim': 4,
                    'output_coordinate_dim': 4, 'resolution': [8, 8, 8, 4]}},
    multires=[1], net_width=16, timenet_width=8, timenet_output=8,
)
"""


@pytest.mark.gpu
def test_train_cli_on_card(cuda, tmp_path):
    """``python -m mobgs_tpu_torch.cli.train`` at a small size on the card
    (the seesaw overlay, 64x48x6, E=3, an eval with 5 TTO steps at 2 and 4):
    every artifact written, a finite history, all four kernels launched;
    then TTO at 3 steps on the trained state through the kernels and through
    the plain route: poses within 1e-5, PSNR within 1e-3 dB."""
    import json
    import os
    from mobgs_tpu_torch.cli import train as cli
    from mobgs_tpu_torch.data import synthetic
    from mobgs_tpu_torch.eval.tto import make_tto
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    overlay = tmp_path / "small.py"
    overlay.write_text(CLI_OVERLAY.format(
        base=os.path.join(root, "configs", "stereo", "seesaw.py")))
    out = tmp_path / "out"
    cuda_raster.reset_launches()
    ts, hist = cli.main(["--configs", str(overlay), "--synthetic", "--synthetic_size",
                         "64x48x6", "--num_warp", "3", "--iterations", "4",
                         "--test_iterations", "2", "--eval_tto", "--quiet", "-m", str(out)],
                        device="cuda")
    assert all(n > 0 for n in cuda_raster.launches.values()), cuda_raster.launches
    assert len(hist) == 1 and np.isfinite(hist[0]["loss"])
    assert [e["iter"] for e in json.loads((out / "eval_curve.json").read_text())] == [2, 4]
    for tag in ("4", "best"):
        d = out / "point_cloud" / f"iteration_{tag}"
        for name in ("point_cloud.ply", "point_cloud.pt", "point_cloud_static.ply",
                     "blce.pth", "deformation.pth", "deformation_table.pth",
                     "deformation_accum.pth", "train_state.npz"):
            assert (d / name).exists(), (tag, name)
    assert (out / "fine_debug" / "iter_000001.png").exists()
    assert ts.stat.xyz.device.type == "cuda" and ts.deform.grid.aabb.device.type == "cuda"

    data, _ = synthetic.generate(width=64, height=48, num_frames=6, device="cuda")
    args = [torch.as_tensor(x, device="cuda") for x in
            (data.test_w2c[:2], data.K[:2], data.time[:2], data.test_images[:2])]
    res = {}
    for backend in ("cuda", "plain"):
        cfg = RasterConfig(tiles_per_gauss=hist[0]["tiles_per_gauss"],
                           max_per_tile=hist[0]["max_per_tile"], backend=backend)
        res[backend] = make_tto(ts.stat, ts.dyn, ts.sandwich, 64, 48, data.max_time,
                                steps=3, decay_start=1, raster_cfg=cfg)(
            *args, torch.ones(2, device="cuda"))
    k, p = res["cuda"], res["plain"]
    assert float((k.w2c - p.w2c).abs().max()) <= 1e-5
    assert float((k.psnr - p.psnr).abs().max()) <= 1e-3
    assert float((k.w2c - args[0]).abs().max()) > 1e-5  # the poses moved


@pytest.fixture
def tf32_allowed():
    """TF32 allowed for cuDNN convolutions process-wide (PyTorch's default)."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    yield
    torch.backends.cudnn.allow_tf32 = prev


@pytest.mark.gpu
def test_ssim_is_float32_whatever_the_tf32_flag(cuda, tf32_allowed):
    """SSIM on the card with TF32 allowed globally against the same call on
    float64 CPU tensors: within 1e-5 (TF32's 10-bit mantissa misses by far
    more); its gradient (autograd runs the backward after the forward's
    guard has closed) equals the one with TF32 off."""
    from mobgs_tpu_torch.core.image import ssim
    rng = np.random.default_rng(0)
    a = rng.uniform(size=(2, 3, 288, 512))
    b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1)
    card = ssim(*(torch.as_tensor(x, dtype=torch.float32, device=cuda) for x in (a, b)),
                size_average=False)
    ref = ssim(*(torch.as_tensor(x, dtype=torch.float64) for x in (a, b)), size_average=False)
    assert float((card.cpu().double() - ref).abs().max()) <= 1e-5

    def grad():
        x = torch.as_tensor(a, dtype=torch.float32, device=cuda).requires_grad_(True)
        ssim(x, torch.as_tensor(b, dtype=torch.float32, device=cuda)).backward()
        return x.grad
    g_on = grad()
    torch.backends.cudnn.allow_tf32 = False
    g_off = grad()
    assert float((g_on - g_off).abs().max()) <= 1e-6 * float(g_off.abs().max())


@pytest.mark.gpu
def test_lpips_on_card_matches_cpu(cuda, tf32_allowed):
    """``lpips_distance`` on the card (TF32 allowed globally) against the CPU,
    rtol 1e-5, with the random backbone and the default lin weights."""
    from mobgs_tpu_torch.eval import lpips
    rng = np.random.default_rng(1)
    a = rng.uniform(-1, 1, (3, 3, 288, 512)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.2, a.shape), -1, 1).astype(np.float32)
    d = {dev: lpips.lpips_distance(lpips.load_lpips(device=dev),
                                   *(torch.as_tensor(x, device=dev) for x in (a, b))).cpu()
         for dev in (cuda, "cpu")}
    np.testing.assert_allclose(d[cuda].numpy(), d["cpu"].numpy(), rtol=1e-5, atol=0)


@pytest.mark.gpu
def test_warm_stage_on_card_matches_cpu(cuda, tmp_path):
    """The warm stage on the card against the CPU on the fabricated stereo
    scene (V = 4, 512x288): point maps atol 1e-5, error masks equal on all
    but 1e-4 of the pixels (a threshold at the frame mean), and ``warm_init``
    on the card gives the requested seed counts."""
    from mobgs_tpu_torch.data.stereo import load_stereo_scene
    from mobgs_tpu_torch.train import warm
    from test_data_loaders import make_stereo_fixture
    make_stereo_fixture(str(tmp_path / "scene"), V=4)
    scene = load_stereo_scene(str(tmp_path / "scene"))
    d = scene.data
    out = {}
    for dev in (cuda, "cpu"):
        t = [torch.as_tensor(x, device=dev) for x in (d.images, d.depths, d.w2c, d.K)]
        out[dev] = (warm.photometric_error_masks(*t).cpu(),
                    torch.stack([warm.unproject_depth(*(x[v] for x in t[1:]))
                                 for v in range(4)]).cpu())
    assert float((out[cuda][0] != out["cpu"][0]).float().mean()) <= 1e-4
    assert float((out[cuda][1] - out["cpu"][1]).abs().max()) <= 1e-5
    pc = warm.warm_init(d.images, d.depths, d.w2c, d.K, d.time,
                        (d.masks > 0.5).astype(np.float32), scene.tracklet, 3000, 700,
                        seed=0, device=cuda)
    assert pc.stat_points.shape == (3000, 3) and pc.dyn_trajectory.shape == (700, 4, 3)
    assert np.isfinite(pc.dyn_trajectory).all()


@pytest.mark.gpu
def test_eval_and_metrics_cli_on_card(cuda, tmp_path, monkeypatch):
    """``eval_cli`` at a small size on the card (a 64x48x6 checkpoint of the
    train CLI, 3 TTO steps) through the kernels and, on a copy, through the
    plain route: solved poses within 1e-5; then ``metrics_cli`` on the
    card: finite PSNR, SSIM and ``lpips_randfeat``."""
    import json
    import os
    import shutil
    from mobgs_tpu_torch.cli import eval_cli, metrics_cli
    from mobgs_tpu_torch.cli import train as cli
    from mobgs_tpu_torch.eval import tto
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    overlay = tmp_path / "small.py"
    overlay.write_text(CLI_OVERLAY.format(
        base=os.path.join(root, "configs", "stereo", "seesaw.py")))
    size = ["--synthetic", "--synthetic_size", "64x48x6"]
    cli.main(["--configs", str(overlay), *size, "--num_warp", "3", "--iterations", "4",
              "--test_iterations", "2", "--quiet", "-m", str(tmp_path / "kernels")])
    shutil.copytree(tmp_path / "kernels", tmp_path / "plain")
    argv = [*size, "--iteration", "best", "--tto_steps", "3", "--tto_decay_start", "1"]
    cuda_raster.reset_launches()
    eval_cli.main(argv + ["-m", str(tmp_path / "kernels")])
    launches = dict(cuda_raster.instance_launches)
    assert launches.get("raster_fwd CE=11", 0) > 0 and launches.get("raster_bwd CE=11", 0) > 0
    real = tto.make_tto
    monkeypatch.setattr(tto, "make_tto", lambda *a, **kw: real(
        *a, raster_cfg=RasterConfig(backend="plain"), **kw))
    eval_cli.main(argv + ["-m", str(tmp_path / "plain")])
    k, p = (np.load(tmp_path / d / "solved_poses.npy") for d in ("kernels", "plain"))
    assert k.shape == (6, 4, 4) and float(np.abs(k - p).max()) <= 1e-5
    metrics_cli.main(["-m", str(tmp_path / "kernels")])
    res = json.loads((tmp_path / "kernels" / "results.json").read_text())
    assert res["n_frames"] == 6
    assert all(np.isfinite(res[k]) for k in ("psnr", "ssim", "lpips_randfeat"))


# the registry layouts' views: the dycheck iPhone 2x frame (360x480, 22.5
# tile columns, an off-centre principal point and a skew entry, which the
# projection does not read, as in the JAX package) and the D-NeRF Blender
# frame (800x800, 2,500 tiles, several waves of blocks)
REGISTRY_VIEWS = {
    "iphone_360x480": (360, 480, np.array([[466.7, 0.75, 185.625], [0, 467.1, 227.75],
                                           [0, 0, 1]], np.float32)),
    "blender_800x800": (800, 800, np.array([[1111.1, 0, 400.0], [0, 1111.1, 400.0],
                                            [0, 0, 1]], np.float32)),
}


def _registry_operands(view, C, sub, dev, n=20000, K=256):
    """A seeded cloud projected into one registry view and binned at the
    train CLI's default budgets: (ids, counts, rec, col, ntx, sub, W, H)."""
    w, h, kmat = REGISTRY_VIEWS[view]
    rng = np.random.default_rng(11)
    means = rng.normal(size=(n, 3)).astype(np.float32) * np.float32([1.2, 1.6, 0.8])
    means[:, 2] += 5.0
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    scales = np.exp(rng.uniform(-4.0, -2.0, size=(n, 3))).astype(np.float32)
    to = lambda x: torch.as_tensor(x, device=dev)  # noqa: E731
    splats = projection.project(to(means), to(quats), to(scales), torch.eye(4, device=dev),
                                to(kmat), w, h)
    bins = tiles.bin_gaussians(splats, w, h, tiles_per_gauss=36, max_per_tile=K)
    opac = to(rng.uniform(0.2, 0.95, size=n).astype(np.float32))
    cols = [to(rng.uniform(size=(n, C)).astype(np.float32))]
    if sub:
        cols += [splats.depths[:, None], torch.ones(n, 1, device=dev)]
    rec = cuda_raster.pack_records(splats, opac, opac * to((np.arange(n) % 5 == 0)
                                                          .astype(np.float32)) if sub else None)
    return (bins.gauss_ids.contiguous(), bins.counts.contiguous(), rec,
            torch.cat(cols, 1).contiguous(), bins.n_tiles_x, sub, w, h)


@pytest.mark.gpu
@pytest.mark.parametrize("view", list(REGISTRY_VIEWS))
@pytest.mark.parametrize("ce", ["ce9", "ce29_sub"])
def test_registry_views_kernels_match_plain_on_card(view, ce, cuda):
    """Both kernels at the registry runs' views against their plain
    versions, the latent render's CE=9 and the flow-on mid render's CE=29
    with the sub chain; the tile grid's pad (the 23rd tile column of a
    360-wide view) is cropped from the image, and the tiles beyond the
    first wave of blocks are as right as the rest."""
    ids, cnt, rec, col, ntx, sub, w, h = _registry_operands(
        view, 9 if ce == "ce9" else 27, ce != "ce9", cuda)
    assert ids.shape[0] == ntx * -(-h // TILE_PX) and (ntx * TILE_PX == w) == (w % 16 == 0)
    assert int((cnt > 0).sum()) > 0.5 * ids.shape[0], "most tiles are empty"
    with torch.no_grad():
        k = cuda_raster.composite_fwd(ids, cnt, rec, col, ntx, sub)
        p = cuda_raster.composite_tiles_plain(ids, cnt, rec, col, ntx, sub)
    for a, b in zip(k, p):
        if b is not None:
            assert float((a - b).abs().max()) <= ATOL * max(1.0, float(b.abs().max()))
    assert cuda_raster._untile(k[0], ntx, ids.shape[0] // ntx, w, h).shape[:2] == (h, w)
    rng = np.random.default_rng(3)
    g = torch.as_tensor(rng.normal(size=k[0].shape).astype(np.float32), device=cuda)
    g2 = (torch.as_tensor(rng.normal(size=k[1].shape).astype(np.float32), device=cuda)
          if sub else None)
    args = (ids, cnt, rec, col, k[0], k[1], g, g2, ntx, sub)
    kb = cuda_raster.composite_bwd(*args)
    pb = cuda_raster.composite_bwd_plain(*args)
    torch.cuda.synchronize()
    for j in range(7 if sub else 6):
        assert float(pb[0][:, j].abs().max()) > 0, j
        assert _rel_err(kb[0][:, j], pb[0][:, j]) <= BWD_REL, j
    assert _rel_err(kb[1], pb[1]) <= BWD_REL


@pytest.mark.gpu
@pytest.mark.parametrize("view", list(REGISTRY_VIEWS))
def test_registry_view_render_crops_the_tile_pad_on_card(view, cuda):
    """``composite_tiles`` at a registry view through the kernel and the
    plain route: [H, W] outputs, equal within the forward tolerances, and
    a backward whose gradient is the same whatever the pad would hold."""
    w, h, kmat = REGISTRY_VIEWS[view]
    rng = np.random.default_rng(5)
    n = 4000
    means = rng.normal(size=(n, 3)).astype(np.float32) * np.float32([1.2, 1.6, 0.8])
    means[:, 2] += 5.0
    to = lambda x: torch.as_tensor(x, device=cuda)  # noqa: E731
    m = to(means).requires_grad_(True)
    quats = to(rng.normal(size=(n, 4)).astype(np.float32))
    scales = to(np.exp(rng.uniform(-3.0, -1.5, size=(n, 3))).astype(np.float32))
    opac = to(rng.uniform(0.2, 0.95, size=n).astype(np.float32))
    colors = to(rng.uniform(size=(n, 9)).astype(np.float32))
    from mobgs_tpu_torch.ops.rasterize import rasterize
    grads = {}
    for backend in ("cuda", "plain"):
        out = rasterize(m, quats, scales, opac, colors, torch.eye(4, device=cuda), to(kmat),
                        w, h, background=torch.full((9,), 0.3, device=cuda),
                        config=RasterConfig(max_per_tile=256, backend=backend))
        assert out.images.shape == (1, h, w, 9) and out.alphas.shape == (1, h, w)
        (grads[backend],) = torch.autograd.grad((out.images ** 2).sum() + out.alphas.sum(), m)
        grads[backend + "_img"] = out.images.detach()
    assert float((grads["cuda_img"] - grads["plain_img"]).abs().max()) <= ATOL
    assert _rel_err(grads["cuda"], grads["plain"]) <= STEP_REL


@pytest.mark.gpu
def test_merge_dyn_bins_matches_bin_gaussians_on_card(cuda):
    """The camera-shared binning on the card: ``merge_dyn_bins`` of a
    static and a dynamic cloud (the dynamic one piled in front, so tiles
    overflow, and a quarter of it at the very place of a static splat, so
    keys tie) bit-equal to ``bin_gaussians`` over the concatenation and to
    the same merge on the CPU."""
    rng = np.random.default_rng(0)
    ms = rng.normal(size=(3000, 3)).astype(np.float32)
    ms[:, 2] += 7.0
    md = rng.normal(size=(1000, 3)).astype(np.float32) * np.float32([0.2, 0.2, 0.05])
    md[:, 2] += 5.0
    ms[:250] = md[:250]
    q = rng.normal(size=(4000, 4)).astype(np.float32)
    s = np.exp(rng.uniform(-3.5, -2, (4000, 3))).astype(np.float32)
    kw = dict(tiles_per_gauss=9, max_per_tile=64)
    res = {}
    for dev in ("cpu", cuda):
        to = lambda x: torch.as_tensor(x, device=dev)  # noqa: E731
        sp = projection.project(to(np.concatenate([ms, md])), to(q), to(s),
                                torch.eye(4, device=dev), to(KMAT), W, H)
        ps = projection.ProjectedSplats(*(x[:3000] for x in sp))
        pd = projection.ProjectedSplats(*(x[3000:] for x in sp))
        merged = tiles.merge_dyn_bins(tiles.bin_static(ps, W, H, **kw), pd, 3000, W, H, **kw)
        ref = tiles.bin_gaussians(sp, W, H, **kw)
        live = torch.arange(64, device=dev)[None] < ref.counts[:, None]
        assert int(merged.max_count) == int(ref.max_count) > 64
        assert torch.equal(merged.counts, ref.counts)
        assert torch.equal(torch.where(live, merged.gauss_ids, -1),
                           torch.where(live, ref.gauss_ids, -1))
        res[str(dev)] = torch.where(live, merged.gauss_ids, -1).cpu()
    assert torch.equal(res["cpu"], res[str(cuda)])


@pytest.mark.gpu
def test_shared_static_flow_step_matches_unshared_on_card(cuda):
    """One flow-on step (B=2, E=3) through the kernels with
    ``shared_static=True`` and with the default: the loss within 1e-5, each
    gradient leaf within STEP_REL of its largest magnitude, and the same
    kernel launches."""
    ts, batch = _small_train_state(cuda)
    opt = OptimizationParams(iterations=100, lambda_flow_loss=1e-2)
    cfg = RasterConfig(max_per_tile=256)
    leaves = [*G.split_diff(ts.stat)[0], *G.split_diff(ts.dyn)[0],
              *S.sandwich_leaves(ts.sandwich), *ts.blce.params.leaves()]
    res, launches = {}, {}
    for shared in (True, False):
        fwd = S.make_forward(opt, W, H, 1.0, 3, cfg, shared_static=shared)
        off = torch.zeros((2, 320, 2), device=cuda, requires_grad=True)
        before = dict(cuda_raster.launches)
        total, aux = fwd(ts.stat, ts.dyn, ts.sandwich, ts.blce, off, batch)
        grads = torch.autograd.grad(total, leaves + [off], allow_unused=True)
        torch.cuda.synchronize()
        launches[shared] = {k: cuda_raster.launches[k] - before[k] for k in before}
        res[shared] = (float(total.detach()), grads)
    assert launches[True] == launches[False]
    np.testing.assert_allclose(res[True][0], res[False][0], rtol=1e-5)
    for a, b in zip(res[True][1], res[False][1]):
        if b is None or not b.any():
            assert a is None or not a.any()
            continue
        assert _rel_err(a, b) <= STEP_REL


@pytest.mark.gpu
@pytest.mark.parametrize("C,mode", [(3, "RGB+ED"), (9, "RGB")])
def test_compat_shim_kernels_match_plain_on_card(C, mode, cuda):
    """``compat.rasterization`` through the kernels (CE = C + 2) and through
    the plain route: forward at ATOL (depth rtol 1e-3 where α > 1e-3), each
    input's gradient within BWD_REL of its largest magnitude, one forward
    and one backward launch of the non-sub kernels."""
    from mobgs_tpu_torch import compat

    rng = np.random.default_rng(C)
    n = 400
    means = rng.normal(size=(n, 3)).astype(np.float32)
    means[:, 2] += 6.0
    host = [means, rng.normal(size=(n, 4)), np.exp(rng.uniform(-3.5, -1.5, (n, 3))),
            rng.uniform(0.2, 0.95, n), rng.uniform(size=(n, C))]
    g_img = torch.as_tensor(rng.normal(size=(1, H, W, C + (mode == "RGB+ED"))),
                            dtype=torch.float32, device=cuda)
    g_alpha = torch.as_tensor(rng.normal(size=(1, H, W, 1)), dtype=torch.float32, device=cuda)
    res = {}
    for backend in ("cuda", "plain"):
        leaves = [torch.as_tensor(x, dtype=torch.float32, device=cuda).requires_grad_(True)
                  for x in host]
        before = dict(cuda_raster.launches)
        img, alpha, info = compat.rasterization(
            *leaves, torch.eye(4, device=cuda)[None], torch.as_tensor(KMAT, device=cuda)[None],
            W, H, backgrounds=torch.linspace(0.1, 0.4, C, device=cuda)[None],
            render_mode=mode, config=RasterConfig(max_per_tile=128, backend=backend))
        if mode == "RGB+ED":
            img = torch.cat([img[..., :-1], torch.where(alpha > 1e-3, img[..., -1:],
                                                        torch.zeros_like(alpha))], -1)
        grads = torch.autograd.grad(torch.sum(img * g_img) + torch.sum(alpha * g_alpha), leaves)
        torch.cuda.synchronize()
        res[backend] = (img.detach(), alpha.detach(), grads,
                        {k: cuda_raster.launches[k] - before[k] for k in before})
    (ik, ak, gk, lk), (ip, ap, gp, lp) = res["cuda"], res["plain"]
    assert lk == {"raster_fwd": 1, "raster_fwd_sub": 0, "raster_bwd": 1, "raster_bwd_sub": 0}
    assert not any(lp.values())
    np.testing.assert_allclose(ak.cpu().numpy(), ap.cpu().numpy(), atol=ATOL)
    np.testing.assert_allclose(ik[..., :C].cpu().numpy(), ip[..., :C].cpu().numpy(), atol=ATOL)
    if mode == "RGB+ED":
        m = (ap[..., 0] > 1e-3).cpu().numpy()
        np.testing.assert_allclose(ik[..., -1].cpu().numpy()[m], ip[..., -1].cpu().numpy()[m],
                                   rtol=1e-3)
    for a, b in zip(gk, gp):
        assert _rel_err(a, b) <= BWD_REL


@pytest.mark.gpu
def test_ball_query_and_deformation_on_card_match_cpu(cuda):
    """``ball_query`` on the card: indices equal to the CPU's, in row
    blocks; ``apply_deformation`` and ``regulation_loss`` forward at rtol
    1e-5 and each gradient leaf within 1e-4 of its largest magnitude (the
    gathers' backward is an index_add_ whose atomics reorder sums)."""
    from mobgs_tpu_torch.config import ModelHiddenParams
    from mobgs_tpu_torch.models import deformation as DF
    from mobgs_tpu_torch.train import losses_extra as LX

    rng = np.random.default_rng(3)
    pts = torch.as_tensor(rng.uniform(-1, 1, (2, 2000, 3)), dtype=torch.float32)
    for blk in (LX.BALL_QUERY_PANEL, 300 * 2000):
        old, LX.BALL_QUERY_PANEL = LX.BALL_QUERY_PANEL, blk
        try:
            dc, ic = LX.ball_query(pts.to(cuda), pts.to(cuda), k=16, radius=0.2)
        finally:
            LX.BALL_QUERY_PANEL = old
        dp, ip = LX.ball_query(pts, pts, k=16, radius=0.2)
        assert torch.equal(ic.cpu(), ip)
        np.testing.assert_allclose(dc.cpu().numpy(), dp.numpy(), rtol=1e-5, atol=1e-6)

    hidden = ModelHiddenParams(net_width=32, kplanes_config={
        "grid_dimensions": 2, "input_coordinate_dim": 4, "output_coordinate_dim": 8,
        "resolution": [16, 16, 16, 6]}, multires=[1, 2])
    params = DF.init_deformation(torch.Generator().manual_seed(0), hidden, device="cpu")
    host = [rng.uniform(-1.6, 1.6, (3000, 3)), rng.normal(size=(3000, 3)),
            rng.normal(size=(3000, 4)), rng.uniform(0, 1, 3000)]
    res = {}
    for dev in ("cpu", cuda):
        ps = [p.detach().to(dev).requires_grad_(True)
              for p in params.grid.grids[0] + params.grid.grids[1]]
        grid = params.grid._replace(grids=(tuple(ps[:6]), tuple(ps[6:])),
                                    aabb=params.grid.aabb.to(dev))
        mlp = {f: DF.MLPParams(*(tuple(w.detach().to(dev).requires_grad_(True) for w in part)
                                 for part in getattr(params, f)))
               for f in DF.DeformationParams._fields if f != "grid"}
        p = DF.DeformationParams(grid=grid, **mlp)
        ins = [torch.as_tensor(x, dtype=torch.float32, device=dev) for x in host]
        outs = DF.apply_deformation(p, *ins)
        reg = DF.regulation_loss(p, 0.01, 1e-4, 2e-4)
        loss = sum(torch.sum(o * o) for o in outs) + reg
        leaves = ps + [w for f in mlp for part in mlp[f] for w in part if f != "timenet"]
        res[str(dev)] = ([o.detach().cpu() for o in outs] + [reg.detach().cpu()],
                         [g.cpu() for g in torch.autograd.grad(loss, leaves)])
    for a, b in zip(res[str(cuda)][0], res["cpu"][0]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-6)
    for a, b in zip(res[str(cuda)][1], res["cpu"][1]):
        assert _rel_err(a, b) <= 1e-4
