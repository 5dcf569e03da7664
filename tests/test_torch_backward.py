"""The port's plain backward compositor vs the JAX package's Pallas VJP.

``composite_bwd_plain`` keeps the Pallas backward's semantics (the replay
with the forward output as the suffix anchor, the gates, the chunk-level
early exit), so gradients through the port's ``composite_tiles`` (whose
CPU route runs ``composite_tiles_plain`` forward and ``composite_bwd_plain``
backward) are held against ``jax.vjp`` of ``composite_tiles_pallas`` in
interpret mode, at that suite's gradient tolerance, atol 3e-4 and rtol 2e-3
(``tests/test_pallas_raster.py:99``): the sums over slots and pixels run in
another order (cumsum vs doubling scan, index_add_ vs XLA's scatter-add).

The plain backward is also held against autograd through the plain
forward's own ops, which share its arithmetic but not its algorithm
(cumprod's autograd vs the suffix-anchor identity), at the same tolerance.

The CUDA kernel is held against ``composite_bwd_plain`` on the card in
``tests/test_torch_gpu.py``.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mobgs_tpu.ops import pallas_raster
from mobgs_tpu.ops import projection as jproj
from mobgs_tpu.ops import tiles as jtiles

from mobgs_tpu_torch.ops import cuda_raster, projection, tiles

W, H = 64, 48
GRAD_TOL = dict(atol=3e-4, rtol=2e-3)
# (colour channels, want_depth, want_alpha, sub chain): CE = 2, 9, 11
CASES = {
    "ce2_alpha_only": (0, True, True, False),
    "ce9_image_only": (9, False, False, False),
    "ce11_default": (9, True, True, False),
    "ce9_image_only_sub": (9, False, False, True),
    "ce11_sub": (9, True, True, True),
}
NAMES = ("means2d", "conics", "depths", "colors", "opac", "sub_opac")


def t(x):
    return torch.as_tensor(np.array(x))


def _scene(n=420, seed=0, max_per_tile=256):
    """A scene dense enough that tiles hold more than one chunk of 128."""
    rng = np.random.default_rng(seed)
    means = rng.normal(size=(n, 3)).astype(np.float32) * 0.8
    means[:, 2] += 6.0
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    scales = np.exp(rng.uniform(-3.0, -1.2, size=(n, 3))).astype(np.float32)
    K = np.array([[60.0, 0, W / 2], [0, 60.0, H / 2], [0, 0, 1]], np.float32)
    js = jproj.project(jnp.asarray(means), jnp.asarray(quats),
                       jnp.asarray(scales), jnp.eye(4), jnp.asarray(K), W, H)
    jb = jtiles.bin_gaussians(js, W, H, tiles_per_gauss=36,
                              max_per_tile=max_per_tile)
    return dict(
        js=js, jb=jb,
        colors=rng.uniform(size=(n, 9)).astype(np.float32),
        opac=rng.uniform(0.1, 0.9, size=n).astype(np.float32),
        sub=((np.arange(n) % 3 == 0) * rng.uniform(0.1, 0.9, size=n)
             ).astype(np.float32), ct_scale=1.0)


def _saturating():
    """The saturating tiles of ``test_torch_raster.py``: a front layer of
    128 wide splats takes every pixel to T <= 1e-4, so each tile exits after
    its first chunk and the bright back layer gets no gradient. The splats
    span the image, so a conic's gradient sums dx²/2 over ~1000 pixels; the
    cotangents are scaled by 1e-3 to bring the gradients to O(1), the scale
    at which the suite's absolute tolerance applies."""
    n = 256
    rng = np.random.default_rng(1)
    m2d = np.tile(np.array([[W / 2, H / 2]], np.float32), (n, 1))
    m2d += rng.normal(size=(n, 2)).astype(np.float32)
    conics = np.tile(np.array([[1e-4, 0.0, 1e-4]], np.float32), (n, 1))
    depths = np.concatenate([1.0 + 0.01 * np.arange(128),
                             10.0 + 0.01 * np.arange(128)]).astype(np.float32)
    js = jproj.ProjectedSplats(jnp.asarray(m2d), jnp.asarray(conics),
                               jnp.asarray(depths),
                               jnp.full((n,), 100, jnp.int32))
    jb = jtiles.bin_gaussians(js, W, H, tiles_per_gauss=16, max_per_tile=256)
    assert int(jb.counts.min()) == 256
    opac = np.concatenate([np.full(128, 0.0781), np.full(128, 0.99)])
    colors = np.concatenate([rng.uniform(size=(128, 9)),
                             np.full((128, 9), 20.0)])
    return dict(js=js, jb=jb, colors=colors.astype(np.float32),
                opac=opac.astype(np.float32), sub=opac.astype(np.float32),
                ct_scale=1e-3)


@pytest.fixture(scope="module")
def scenes():
    sc = _scene()
    assert int(sc["jb"].counts.max()) > 128, "want tiles of two chunks"
    return {"dense": sc, "saturating": _saturating()}


def _cotangents(n_out, shapes, seed, scale):
    rng = np.random.default_rng(seed)
    return [(scale * rng.normal(size=s)).astype(np.float32)
            for s in shapes[:n_out]]


def _jax_grads(sc, case):
    C, wd, wa, sub = case
    js = sc["js"]
    cols = jnp.asarray(sc["colors"][:, :C])

    def f(m2d, con, dep, col, op, sop):
        s2 = js._replace(means2d=m2d, conics=con, depths=dep)
        return pallas_raster.composite_tiles_pallas(
            sc["jb"], s2, col, op, W, H, sub_opacities=sop if sub else None,
            want_depth=wd, want_alpha=wa)

    primals = (js.means2d, js.conics, js.depths, cols,
               jnp.asarray(sc["opac"]), jnp.asarray(sc["sub"]))
    outs, vjp = jax.vjp(f, *primals)
    cts = _cotangents(len(outs), [o.shape for o in outs], 7, sc["ct_scale"])
    if wd:
        # expected depth only where the pixel is covered, as a loss would
        cts[2] = cts[2] * (np.asarray(outs[1]) > 0.05)
    grads = vjp(tuple(jnp.asarray(c) for c in cts))
    return [np.asarray(x) for x in outs], cts, [np.asarray(x) for x in grads]


def _port_grads(sc, case, cts):
    C, wd, wa, sub = case
    js, jb = sc["js"], sc["jb"]
    leaves = [t(js.means2d), t(js.conics), t(js.depths),
              t(sc["colors"][:, :C]), t(sc["opac"]), t(sc["sub"])]
    for x in leaves:
        x.requires_grad_(True)
    splats = projection.ProjectedSplats(leaves[0], leaves[1], leaves[2],
                                        t(js.radii))
    bins = tiles.TileBins(t(jb.gauss_ids), t(jb.counts), jb.n_tiles_x,
                          jb.n_tiles_y, t(jb.max_count))
    outs = cuda_raster.composite_tiles(
        bins, splats, leaves[3], leaves[4], W, H,
        sub_opacities=leaves[5] if sub else None, want_depth=wd, want_alpha=wa)
    loss = sum(torch.sum(o * t(c)) for o, c in zip(outs, cts))
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return [o.detach().numpy() for o in outs], grads


@pytest.mark.parametrize("name", list(CASES) + ["saturating_ce11_sub"])
def test_plain_backward_matches_pallas_vjp(scenes, name):
    if name.startswith("saturating"):
        sc, case = scenes["saturating"], CASES["ce11_sub"]
    else:
        sc, case = scenes["dense"], CASES[name]
    j_outs, cts, j_grads = _jax_grads(sc, case)
    before = dict(cuda_raster.launches)
    p_outs, p_grads = _port_grads(sc, case, cts)
    assert cuda_raster.launches == before  # the CPU route launches nothing
    for a, b in zip(p_outs, j_outs):
        np.testing.assert_allclose(a, b, atol=2e-5, rtol=1e-4)
    sub = case[3]
    for nm, a, b in zip(NAMES, p_grads, j_grads):
        if nm == "sub_opac" and not sub:
            assert a is None
            continue
        if (nm == "colors" and case[0] == 0) or (nm == "depths" and not case[1]):
            assert a is None or not a.any(), nm  # no such column composited
            continue
        assert np.abs(b).max() > 0, nm  # the case exercises this leaf
        np.testing.assert_allclose(a.numpy(), b, err_msg=nm, **GRAD_TOL)
    if name.startswith("saturating"):
        # the back layer sits past the early exit: no gradient reaches it
        assert not p_grads[3][128:].any() and not p_grads[4][128:].any()


def _records(sc, C, sub):
    js = sc["js"]
    rec = cuda_raster.pack_records(
        projection.ProjectedSplats(t(js.means2d), t(js.conics), t(js.depths),
                                   t(js.radii)),
        t(sc["opac"]), t(sc["sub"]) if sub else None)
    n = rec.shape[0]
    col = torch.cat([t(sc["colors"][:, :C]), t(js.depths)[:, None],
                     torch.ones(n, 1)], 1).contiguous()
    jb = sc["jb"]
    return (t(jb.gauss_ids).to(torch.int32), t(jb.counts).to(torch.int32),
            rec, col, jb.n_tiles_x)


@pytest.mark.parametrize("sub", [False, True], ids=["main", "sub"])
def test_plain_backward_matches_autograd_of_plain_forward(scenes, sub):
    ids, counts, rec, col, ntx = _records(scenes["dense"], 9, sub)
    rec.requires_grad_(True)
    col.requires_grad_(True)
    out, out2 = cuda_raster.composite_tiles_plain(ids, counts, rec, col, ntx, sub)
    rng = np.random.default_rng(3)
    g = t(rng.normal(size=out.shape).astype(np.float32))
    g2 = t(rng.normal(size=out2.shape).astype(np.float32)) if sub else None
    loss = torch.sum(out * g) + (torch.sum(out2 * g2) if sub else 0.0)
    want_rec, want_col = torch.autograd.grad(loss, (rec, col))
    got_rec, got_col = cuda_raster.composite_bwd_plain(
        ids, counts, rec.detach(), col.detach(), out.detach(),
        None if out2 is None else out2.detach(), g, g2, ntx, sub)
    n_rows = 7 if sub else 6
    np.testing.assert_allclose(got_rec[:, :n_rows].numpy(),
                               want_rec[:, :n_rows].numpy(), **GRAD_TOL)
    assert not got_rec[:, n_rows:].any()
    np.testing.assert_allclose(got_col.numpy(), want_col.numpy(), **GRAD_TOL)
    # the wrapper's CPU route is the plain backward
    wr, wc = cuda_raster.composite_bwd(ids, counts, rec.detach(), col.detach(),
                                       out.detach(),
                                       None if out2 is None else out2.detach(),
                                       g, g2, ntx, sub)
    assert torch.equal(wr, got_rec) and torch.equal(wc, got_col)


@pytest.mark.parametrize("sub", [False, True], ids=["main", "sub"])
def test_plain_versions_run_in_the_records_dtype(scenes, sub):
    """Given float64 records the plain forward and backward sum in float64
    (the reference for walks deep enough that float32 rounding shows) and
    agree with their float32 results."""
    ids, counts, rec, col, ntx = _records(scenes["dense"], 9, sub)
    rng = np.random.default_rng(4)
    g = torch.as_tensor(rng.normal(size=(ids.shape[0], cuda_raster.P, col.shape[1])))
    g2 = torch.as_tensor(rng.normal(size=(ids.shape[0], cuda_raster.P))) if sub else None
    res = {}
    for dt in (torch.float32, torch.float64):
        out, out2 = cuda_raster.composite_tiles_plain(ids, counts, rec.to(dt), col.to(dt),
                                                      ntx, sub)
        grads = cuda_raster.composite_bwd_plain(
            ids, counts, rec.to(dt), col.to(dt), out, out2, g.to(dt),
            None if g2 is None else g2.to(dt), ntx, sub)
        res[dt] = [out, *grads] + ([out2] if sub else [])
        assert all(x.dtype == dt for x in res[dt])
    for a, b in zip(res[torch.float32], res[torch.float64]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **GRAD_TOL)


# ---------------------------------------------------------------------------
# gradients of the layers above the compositor

def test_projection_gradients_match():
    """``project``'s gradients into means, quats, scales and the view
    matrix (autograd here, ``jax.grad`` there), atol/rtol 1e-4 relative to
    O(1) upstream gradients: the 2D covariance products round differently."""
    rng = np.random.default_rng(5)
    n = 120
    means = rng.normal(size=(n, 3)).astype(np.float32)
    means[:, 2] += 6.0
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    scales = np.exp(rng.uniform(-3.0, -1.0, size=(n, 3))).astype(np.float32)
    view = np.eye(4, dtype=np.float32)
    view[:3, 3] = [0.1, -0.2, 0.3]
    K = np.array([[60.0, 0, W / 2], [0, 60.0, H / 2], [0, 0, 1]], np.float32)
    gm, gc, gd = (rng.normal(size=s).astype(np.float32)
                  for s in ((n, 2), (n, 3), (n,)))

    def jloss(m, q, s, v):
        sp = jproj.project(m, q, s, v, jnp.asarray(K), W, H)
        return (jnp.sum(sp.means2d * gm) + jnp.sum(sp.conics * gc)
                + jnp.sum(sp.depths * gd))

    jg = jax.grad(jloss, argnums=(0, 1, 2, 3))(
        *map(jnp.asarray, (means, quats, scales, view)))
    args = [t(x).requires_grad_(True) for x in (means, quats, scales, view)]
    sp = projection.project(*args, t(K), W, H)
    loss = (torch.sum(sp.means2d * t(gm)) + torch.sum(sp.conics * t(gc))
            + torch.sum(sp.depths * t(gd)))
    pg = torch.autograd.grad(loss, args)
    for nm, a, b in zip(("means", "quats", "scales", "viewmat"), pg, jg):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, atol=1e-4 * max(1.0, np.abs(b).max()),
                                   rtol=1e-4, err_msg=nm)


RENDERS = {
    # the train step's latent render: image only, exposure-shifted
    "latent": dict(delta_exposure=0.3, want_depth=False, want_alpha=False),
    # its mid render: the dynamic alpha fused in, the densify gradient tap
    "mid": dict(get_dynamic=True, subset_alpha_only=True, offset=True),
}


@pytest.fixture(scope="module")
def render_scene():
    from mobgs_tpu.models import gaussians as jG
    from mobgs_tpu.models import sandwich as jsand
    from mobgs_tpu_torch.io import from_jax

    rng = np.random.default_rng(6)

    def cloud(n):
        pts = rng.normal(size=(n, 3)).astype(np.float32)
        pts[:, 2] = pts[:, 2] * 0.5 + 6.0
        return (jnp.asarray(pts), jnp.asarray(rng.uniform(size=(n, 3)).astype(np.float32)),
                jnp.zeros(n))

    stat = jG.create_state(*cloud(150), 192, rng=jax.random.PRNGKey(0))
    dp, dc, dt = cloud(60)
    times = jnp.linspace(0, 1, 8)
    vel = jnp.asarray(rng.normal(size=(60, 3)).astype(np.float32) * 0.3)
    dyn = jG.create_state(dp, dc, dt, 64, trajectory=dp[:, None]
                          + vel[:, None] * times[None, :, None], traj_times=times)
    dyn = dyn._replace(
        omega=jnp.asarray(rng.normal(size=(64, 4)).astype(np.float32) * 0.1),
        features_t=jnp.asarray(rng.normal(size=(64, 3)).astype(np.float32)))
    sw = jsand.init_sandwich(jax.random.PRNGKey(1))

    def anisotropic(st):
        # the k-NN init gives isotropic splats, whose rotation gradient is
        # rounding noise; random rotations and log-scales give it substance
        M = st.capacity
        return st._replace(
            scaling=st.scaling + jnp.asarray(
                rng.normal(0, 0.4, size=(M, 3)).astype(np.float32)),
            rotation=jnp.asarray(rng.normal(size=(M, 4)).astype(np.float32)))

    stat, dyn = anisotropic(stat), anisotropic(dyn)

    def fields(nt):
        return {f: np.asarray(getattr(nt, f)) for f in nt._fields}

    return dict(j=(stat, dyn, sw),
                p=(from_jax.gaussian_state_from_numpy(fields(stat), device="cpu"),
                   from_jax.gaussian_state_from_numpy(fields(dyn), device="cpu"),
                   from_jax.sandwich_from_numpy(fields(sw), device="cpu")))


@pytest.mark.parametrize("name", list(RENDERS))
def test_render_view_gradients_match(render_scene, name):
    """``render_view``'s gradients into every Gaussian field, the Sandwich
    weights and the ``means2d_offset`` tap, through the plain backward here
    and the Pallas VJP there. Per leaf relative to its largest magnitude,
    2e-3: the compositor's sums run in another order and projection carries
    the difference into the 3D fields."""
    from mobgs_tpu.data import cameras as jcam
    from mobgs_tpu.models import gaussians as jG
    from mobgs_tpu.models import render as jR
    from mobgs_tpu.ops.rasterize import RasterConfig as JRasterConfig
    from mobgs_tpu_torch.data import cameras
    from mobgs_tpu_torch.models import gaussians as G
    from mobgs_tpu_torch.models import render as R
    from mobgs_tpu_torch.ops.rasterize import RasterConfig

    kw = dict(RENDERS[name])
    use_offset = kw.pop("offset", False)
    stat_j, dyn_j, sw_j = render_scene["j"]
    stat_p, dyn_p, sw_p = render_scene["p"]
    N = stat_j.capacity + dyn_j.capacity
    w2c = np.eye(4, dtype=np.float32)
    w2c[:3, 3] = [0.05, -0.1, 0.2]
    K = np.array([[60.0, 0, W / 2], [0, 60.0, H / 2], [0, 0, 1]], np.float32)
    rng = np.random.default_rng(8)
    g_img = rng.normal(size=(H, W, 3)).astype(np.float32)
    g_dep = rng.normal(size=(H, W)).astype(np.float32) * 0.1
    g_da = rng.normal(size=(H, W)).astype(np.float32)
    jcfg = JRasterConfig(max_per_tile=256, backend="pallas")

    def jloss(sd, dd, sw, off):
        out = jR.render_view(
            jG.merge_diff(sd, jG.split_diff(stat_j)[1]),
            jG.merge_diff(dd, jG.split_diff(dyn_j)[1]), sw,
            jcam.Camera(jnp.asarray(w2c), jnp.asarray(K), jnp.float32(0.4)), W, H,
            jnp.zeros(3), 1.0, means2d_offset=off if use_offset else None,
            config=jcfg, **kw)
        loss = jnp.sum(out.image * g_img)
        if kw.get("want_depth", True):
            loss = loss + jnp.sum(jnp.where(out.alpha > 0.05, out.depth, 0.0) * g_dep)
        if out.d_alpha is not None:
            loss = loss + jnp.sum(out.d_alpha * g_da)
        return loss

    jg = jax.jit(jax.grad(jloss, argnums=(0, 1, 2, 3)))(
        jG.split_diff(stat_j)[0], jG.split_diff(dyn_j)[0], sw_j, jnp.zeros((N, 2)))

    off = torch.zeros((N, 2), requires_grad=True)
    leaves = [*G.split_diff(stat_p)[0], *G.split_diff(dyn_p)[0], sw_p.w1, sw_p.w2, off]
    out = R.render_view(stat_p, dyn_p, sw_p,
                        cameras.Camera(t(w2c), t(K), torch.tensor(0.4)), W, H,
                        torch.zeros(3), 1.0, means2d_offset=off if use_offset else None,
                        config=RasterConfig(max_per_tile=256), **kw)
    loss = torch.sum(out.image * t(g_img))
    if kw.get("want_depth", True):
        loss = loss + torch.sum(torch.where(out.alpha > 0.05, out.depth, 0.0) * t(g_dep))
    if out.d_alpha is not None:
        loss = loss + torch.sum(out.d_alpha * t(g_da))
    pg = torch.autograd.grad(loss, leaves, allow_unused=True)

    want = [*jg[0], *jg[1], jg[2].w1, jg[2].w2, jg[3]]
    names = ([f"stat.{f}" for f in G.DIFF_FIELDS] + [f"dyn.{f}" for f in G.DIFF_FIELDS]
             + ["sandwich.w1", "sandwich.w2", "means2d_offset"])
    n_checked = 0
    for nm, a, b in zip(names, pg, want):
        b = np.asarray(b)
        scale = np.abs(b).max()
        if a is None or not scale:
            assert a is None or float(a.abs().max()) <= 1e-7, nm
            continue
        n_checked += 1
        err = float((a - t(b)).abs().max())
        assert err <= 2e-3 * scale, f"{nm}: max err {err:.3e} vs max {scale:.3e}"
    assert n_checked >= (12 if use_offset else 11)
