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
