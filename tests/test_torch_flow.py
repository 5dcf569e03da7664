"""The port's flow-on train step and exposure re-estimation vs the JAX
package's, and the modules they add: the packed-footprint warp
(``warp_images``, values and VJP), ``flow_warp_loss``, ``get_flow`` and
``get_flow_static``.

Inputs are made from a seed with numpy (the scene, and the JAX package's
initial state carried across with ``io/from_jax.py``) and fed to both. The
JAX side composites with its Pallas kernels in interpret mode
(``RasterConfig(backend="pallas")``) and its step is built with
``scan_passes=True, scan_views=True`` (numerically the unrolled step,
compiled once per pass body); the port's CPU step composites with the plain
forward and the plain backward, which keep the Pallas semantics.

Tolerances, and why:
- the warp and the warp loss: values atol 1e-6 / rtol 1e-6 and gradients
  atol 1e-6 (the same float32 formulas; ``index_add_`` and XLA's scatter
  add a pixel's up to four contributions in another order);
- ``get_flow_static`` / ``get_flow``: atol 2e-5 on images and on flows in
  pixels (the compositor's sums run in another order); ``get_flow``'s
  coordinate maps within 2e-6 of their largest magnitude, since they reach
  hundreds of pixels where a dynamic Gaussian moves far and a float32 of
  800 has a spacing of 6.1e-5;
- the step: loss and Metrics rtol 1e-5 (flow rtol 1e-4: it is 1e-2 of a
  masked L1 whose mask and coordinates come out of the compositor; PSNR
  atol 1e-4), every gradient leaf and the Adam moments relative to the
  leaf's largest magnitude at STEP_TOL, the tolerances of
  ``tests/test_torch_train.py`` (the compositor's sums run in another
  order and the suffix-anchor subtraction amplifies that by up to
  1/(1 − α) ≤ 100; with flow on, the warp carries it on through the
  composited coordinates, and projection into the 3D fields);
  updated parameters only where |g| > 1e-3·max|g| of the leaf (the Adam
  trap: with eps=1e-15 an update is ±lr wherever a gradient is tiny but
  nonzero); densify stats as a gradient leaf, the counts and radii exactly;
  the 3-step loss history rtol 1e-4;
- the exposure update: rtol 1e-4 on the new exposures (a median of ratios
  of flow magnitudes that come out of the compositor).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mobgs_tpu.config import OptimizationParams as JOpt
from mobgs_tpu.data.cameras import Camera as JCamera
from mobgs_tpu.data.synthetic import SceneData as JSceneData
from mobgs_tpu.models import blce as jB
from mobgs_tpu.models import gaussians as jG
from mobgs_tpu.models import render as jR
from mobgs_tpu.models import sandwich as jsand
from mobgs_tpu.ops.rasterize import RasterConfig as JRasterConfig
from mobgs_tpu.train import loop as jL
from mobgs_tpu.train import losses as jlosses
from mobgs_tpu.train import step as jstep

from mobgs_tpu_torch.config import OptimizationParams
from mobgs_tpu_torch.core import se3
from mobgs_tpu_torch.data.cameras import Camera
from mobgs_tpu_torch.data.synthetic import SceneData
from mobgs_tpu_torch.io import from_jax
from mobgs_tpu_torch.models import blce as B
from mobgs_tpu_torch.models import gaussians as G
from mobgs_tpu_torch.models import render as R
from mobgs_tpu_torch.ops import cuda_raster
from mobgs_tpu_torch.ops.rasterize import RasterConfig
from mobgs_tpu_torch.train import loop, losses, step

W, H, V, E = 48, 32, 6, 3
KMAT = np.array([[50.0, 0, W / 2], [0, 50.0, H / 2], [0, 0, 1]], np.float32)
CFG = RasterConfig(max_per_tile=256)
JCFG = JRasterConfig(max_per_tile=256, tile_chunk=6, backend="pallas")
STEP_TOL = {"stat": 2e-3, "dyn": 2e-3, "sandwich": 1e-4, "blce": 1e-3,
            "offsets": 2e-3}
LAMBDA_FLOW = 1e-2



@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's side runs on one CPU thread: its many small ops gain
    little from more, and beside the suite's other workers a team of
    threads waits on its slowest member at every op."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def t(x):
    return torch.as_tensor(np.array(x))


def to_numpy(x):
    """A JAX NamedTuple (nested) as dicts of numpy arrays."""
    if hasattr(x, "_fields"):
        return {f: to_numpy(getattr(x, f)) for f in x._fields}
    return None if x is None else np.asarray(x)


def rel_close(a, b, rel, what):
    a = a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    scale = float(np.abs(b).max())
    assert np.isfinite(a).all(), what
    err = float(np.abs(a - b).max())
    assert err <= rel * scale + 1e-12, f"{what}: max err {err:.3e} vs max {scale:.3e}"


# ---------------------------------------------------------------------------
# the warp and the warp loss


def _warp_inputs(seed=0, K=4, h=10, w=14, C=3):
    """Images, and coordinate maps that hold integer pixel positions (the
    pixel grid: a zero flow), points outside [0, w-1] × [0, h-1] on every
    side, and random points inside."""
    rng = np.random.default_rng(seed)
    imgs = rng.uniform(size=(K, h, w, C)).astype(np.float32)
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    grid = np.stack([xx, yy], -1).astype(np.float32)
    coords = rng.uniform(-0.2, 1.2, size=(K, h, w, 2)).astype(np.float32) \
        * np.asarray([w - 1, h - 1], np.float32)
    coords[0] = grid                                   # integer positions
    coords[1, :, :, 0] = rng.uniform(-3.0, w + 2.0, size=(h, w))
    coords[1, :3] = grid[:3] + np.float32(0.0)         # integers, row-wise
    coords[2, :, :2] = [-1.5, 4.0]                     # left of the image
    coords[2, :, -2:] = [w + 0.5, 2.0]                 # right of it
    coords[3, :2] = [5.0, -2.0]                        # above
    coords[3, -2:] = [3.0, h + 1.0]                    # below
    g = rng.normal(size=(K, h, w, C)).astype(np.float32)
    return imgs, coords, g


def test_warp_images_values_and_vjp():
    imgs, coords, g = _warp_inputs()
    K, h, w, C = imgs.shape
    jout, jvjp = jax.vjp(lambda a, b: jlosses.warp_images(a, b, w, h),
                         jnp.asarray(imgs), jnp.asarray(coords))
    jgi, jgc = jvjp(jnp.asarray(g))
    a, b = t(imgs).requires_grad_(True), t(coords).requires_grad_(True)
    pout = losses.warp_images(a, b, w, h)
    pgi, pgc = torch.autograd.grad(pout, (a, b), t(g))
    np.testing.assert_allclose(pout.detach().numpy(), np.asarray(jout),
                               atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(pgi.numpy(), np.asarray(jgi), atol=1e-6)
    np.testing.assert_allclose(pgc.numpy(), np.asarray(jgc), atol=1e-6)
    # outside the image the coordinate gradient is zero, as torch's
    assert not pgc[2, :, :2, 0].any() and not pgc[3, :2, :, 1].any()
    assert float(pgc.abs().max()) > 0


def test_grid_sample_helpers_match():
    imgs, coords, _ = _warp_inputs(seed=1)
    _, h, w, _ = imgs.shape
    img = np.ascontiguousarray(imgs[1].transpose(2, 0, 1))  # [C, h, w]
    jgrid = jlosses.normalize_coords(jnp.asarray(coords[1]), w, h)
    pgrid = losses.normalize_coords(t(coords[1]), w, h)
    np.testing.assert_allclose(pgrid.numpy(), np.asarray(jgrid), atol=1e-6)
    sampled = losses.grid_sample_border(t(img), pgrid)
    np.testing.assert_allclose(
        sampled.numpy(),
        np.asarray(jlosses.grid_sample_border(jnp.asarray(img), jgrid)), atol=1e-6)
    # both are torch's own sampler, and the packed warp is too
    ref = torch.nn.functional.grid_sample(t(img)[None], pgrid[None], mode="bilinear",
                                          padding_mode="border", align_corners=False)[0]
    np.testing.assert_allclose(sampled.numpy(), ref.numpy(), atol=1e-5)
    warped = losses.warp_images(t(imgs), t(coords), w, h)[1].permute(2, 0, 1)
    np.testing.assert_allclose(warped.numpy(), ref.numpy(), atol=1e-5)


def test_flow_warp_loss_value_and_grads():
    rng = np.random.default_rng(3)
    e, h, w = 3, 10, 14
    ori = rng.uniform(size=(h, w, 3)).astype(np.float32)
    lat = rng.uniform(size=(e, h, w, 3)).astype(np.float32)
    la = rng.uniform(size=(e, h, w)).astype(np.float32)
    da = rng.uniform(size=(h, w)).astype(np.float32)
    e2m = (rng.uniform(-0.1, 1.1, size=(e, h, w, 2))
           * np.asarray([w - 1, h - 1])).astype(np.float32)
    m2e = (rng.uniform(-0.1, 1.1, size=(e, h, w, 2))
           * np.asarray([w - 1, h - 1])).astype(np.float32)
    args = (ori, lat, la, da, e2m, m2e)
    jv, jg = jax.value_and_grad(
        lambda *a: jlosses.flow_warp_loss(*a, w, h), argnums=tuple(range(6)))(
            *map(jnp.asarray, args))
    xs = [t(a).requires_grad_(True) for a in args]
    pv = losses.flow_warp_loss(*xs, w, h)
    pg = torch.autograd.grad(pv, xs)
    np.testing.assert_allclose(float(pv.detach()), float(jv), rtol=1e-6)
    for name, a, b in zip(("ori", "lat", "lat_alpha", "d_alpha", "e2m", "m2e"),
                          pg, jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6,
                                   err_msg=name)


# ---------------------------------------------------------------------------
# the world: a small scene, the JAX state carried across


@pytest.fixture(scope="module")
def world():
    rng = np.random.default_rng(0)
    n_stat, n_dyn = 200, 60
    pts = rng.normal(size=(n_stat + n_dyn, 3)).astype(np.float32)
    pts[:, :2] *= 0.9
    pts[:, 2] = pts[:, 2] * 0.5 + 6.0
    cols = rng.uniform(size=(n_stat + n_dyn, 3)).astype(np.float32)
    times = np.linspace(0, 1, V).astype(np.float32)
    vel = rng.normal(size=(n_dyn, 3)).astype(np.float32) * 0.3
    traj = pts[n_stat:, None] + vel[:, None] * times[None, :, None]
    stat = jG.create_state(jnp.asarray(pts[:n_stat]), jnp.asarray(cols[:n_stat]),
                           jnp.zeros(n_stat), 256, rng=jax.random.PRNGKey(0))
    dyn = jG.create_state(jnp.asarray(pts[n_stat:]), jnp.full((n_dyn, 3), 0.5),
                          jnp.zeros(n_dyn), 64, trajectory=jnp.asarray(traj),
                          traj_times=jnp.asarray(times))
    dyn = dyn._replace(
        omega=jnp.asarray(rng.normal(size=(64, 4)).astype(np.float32) * 0.1),
        features_t=jnp.asarray(rng.normal(size=(64, 3)).astype(np.float32)))

    def anisotropic(st):
        # random rotations and log-scales give the rotation gradient
        # substance (the k-NN init's isotropic splats leave it rounding noise)
        M = st.capacity
        return st._replace(
            scaling=st.scaling + jnp.asarray(
                rng.normal(0, 0.4, size=(M, 3)).astype(np.float32)),
            rotation=jnp.asarray(rng.normal(size=(M, 4)).astype(np.float32)))

    stat, dyn = anisotropic(stat), anisotropic(dyn)
    blce = jB.init_blce(jax.random.PRNGKey(2), num_views=V, num_warp=E)
    # decoders larger than the tiny init, so the latent poses (and with
    # them the exposure update's latent flow) move
    blce = blce._replace(params=blce.params._replace(**{
        k: jnp.asarray(rng.normal(size=getattr(blce.params, k).shape)
                       .astype(np.float32) * s)
        for k, s in (("rot_w", 0.02), ("trans_w", 0.02), ("theta_w", 0.02),
                     ("view_embed", 0.5), ("time_embed", 0.5))}))
    jts = jstep.init_train_state(stat, dyn, jsand.init_sandwich(jax.random.PRNGKey(1)),
                                 blce)

    w2c = np.tile(np.eye(4, dtype=np.float32), (V, 1, 1))
    for v in range(V):
        a = 0.05 * (v - V / 2)
        w2c[v, :3, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                          [-np.sin(a), 0, np.cos(a)]]
        w2c[v, :3, 3] = [0.1 * v - 0.25, 0.02 * v, 0.05 * v]
    arrays = dict(w2c=w2c, K=np.tile(KMAT, (V, 1, 1)), time=times,
                  images=rng.uniform(size=(V, H, W, 3)).astype(np.float32),
                  depths=rng.uniform(4.0, 8.0, size=(V, H, W)).astype(np.float32),
                  blur_feats=rng.uniform(0.2, 0.6, size=V).astype(np.float32),
                  masks=np.zeros((V, H, W), np.float32),
                  width=W, height=H, max_time=1.0,
                  test_w2c=w2c, test_images=np.zeros((V, H, W, 3), np.float32))
    kw = dict(iterations=100, batch_size=2, lambda_flow_loss=LAMBDA_FLOW)
    jopt, popt = JOpt(**kw), OptimizationParams(**kw)
    return dict(
        jts_np=jax.tree.map(np.asarray, jts), fields=to_numpy(jts),
        jdata=JSceneData(**arrays), pdata=SceneData(**arrays),
        jopt=jopt, popt=popt,
        jstep=jstep.make_train_step(jopt, W, H, 1.0, E, JCFG, scan_passes=True,
                                    scan_views=True),
        pstep=step.make_train_step(popt, W, H, 1.0, E, CFG))


def _jax_state(world):
    return jax.tree.map(jnp.asarray, world["jts_np"])


def _port_state(world):
    return from_jax.train_state_from_numpy(world["fields"], device="cpu")


def _cams(world, v, delta_w2c=None):
    """The view's camera in both packages."""
    d = world["pdata"]
    w2c = d.w2c[v] if delta_w2c is None else delta_w2c
    return (JCamera(w2c=jnp.asarray(w2c), K=jnp.asarray(d.K[v]),
                    time=jnp.asarray(d.time[v])),
            Camera(w2c=t(w2c), K=t(d.K[v]), time=t(d.time[v])))


def test_get_flow_static_matches(world):
    jts, pts = _jax_state(world), _port_state(world)
    (jsrc, psrc), (jtgt, ptgt), (jsp, psp) = (_cams(world, v) for v in (1, 3, 2))
    jflow2d, jrend = jax.jit(lambda st, a, b, c: jR.get_flow_static(
        st, a, b, c, W, H, config=JCFG))(jts.stat, jsrc, jtgt, jsp)
    before = dict(cuda_raster.launches)
    with torch.no_grad():
        pflow2d, prend = R.get_flow_static(pts.stat, psrc, ptgt, psp, W, H,
                                           config=CFG)
    assert cuda_raster.launches == before  # CPU tensors: the plain route
    assert prend.shape == (H, W, 2)
    np.testing.assert_allclose(pflow2d.numpy(), np.asarray(jflow2d), atol=2e-5)
    np.testing.assert_allclose(prend.numpy(), np.asarray(jrend), atol=2e-5)
    assert float(prend.abs().max()) > 0.5


def test_get_flow_matches(world):
    jts, pts = _jax_state(world), _port_state(world)
    jcam, pcam = _cams(world, 2)
    bg = np.array([0.1, 0.2, 0.3], np.float32)
    jout = jax.jit(lambda s, d, sw, c: jR.get_flow(
        s, d, sw, c, W, H, jnp.asarray(bg), 0.3, 1.0, config=JCFG))(
            jts.stat, jts.dyn, jts.sandwich, jcam)
    with torch.no_grad():
        pout = R.get_flow(pts.stat, pts.dyn, pts.sandwich, pcam, W, H, t(bg),
                          0.3, 1.0, config=CFG)
    for name, a, b in zip(("exp2mid", "mid2exp"), pout, jout):
        rel_close(a, b, 2e-6, name)
    for name, a, b in zip(("latent_img", "latent_alpha"), pout[2:], jout[2:]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=2e-5, err_msg=name)
    pix = np.stack(np.meshgrid(np.arange(W), np.arange(H)), -1)
    assert float(np.abs(pout[0].numpy() - pix).max()) > 0.05  # the scene moves


# ---------------------------------------------------------------------------
# the step


def _port_grads(world, pts, pb):
    fwd = step.make_forward(world["popt"], W, H, 1.0, E, CFG)
    off = torch.zeros((2, pts.stat.capacity + pts.dyn.capacity, 2),
                      requires_grad=True)
    total, aux = fwd(pts.stat, pts.dyn, pts.sandwich, pts.blce, off, pb)
    groups = (G.split_diff(pts.stat)[0], G.split_diff(pts.dyn)[0],
              step.sandwich_leaves(pts.sandwich), pts.blce.params.leaves(), (off,))
    leaves = [p for grp in groups for p in grp]
    grads = torch.autograd.grad(total, leaves, allow_unused=True)
    out, i = [], 0
    for grp in groups:
        out.append([torch.zeros_like(p) if g is None else g
                    for p, g in zip(grp, grads[i:i + len(grp)])])
        i += len(grp)
    return float(total.detach()), float(aux["flow"].detach()), out


@pytest.fixture(scope="module")
def one_step(world):
    ids = np.array([1, 4])
    j_new, j_metrics = world["jstep"](_jax_state(world),
                                      jL.make_batch(world["jdata"], ids))
    pb = loop.make_batch(world["pdata"], ids, device="cpu")
    p_total, p_flow, p_grads = _port_grads(world, _port_state(world), pb)
    before = dict(cuda_raster.launches)
    p_new, p_metrics = world["pstep"](_port_state(world), pb)
    assert cuda_raster.launches == before  # CPU tensors: the plain route
    return dict(j_new=to_numpy(j_new), j_metrics=j_metrics, p_total=p_total,
                p_flow=p_flow, p_grads=p_grads, p_new=p_new, p_metrics=p_metrics)


def test_flow_step_loss_and_metrics_match(one_step):
    jm, pm = one_step["j_metrics"], one_step["p_metrics"]
    for f in ("loss", "photo", "depth_l1", "mask"):
        np.testing.assert_allclose(float(getattr(pm, f)), float(getattr(jm, f)),
                                   rtol=1e-5, err_msg=f)
    np.testing.assert_allclose(float(pm.flow), float(jm.flow), rtol=1e-4)
    np.testing.assert_allclose(float(pm.psnr), float(jm.psnr), atol=1e-4)
    assert float(pm.flow) > 0 and float(pm.flow) == one_step["p_flow"]
    assert int(pm.tile_max) == int(jm.tile_max)
    assert float(pm.loss) == one_step["p_total"]


@pytest.mark.parametrize("group", ["stat", "dyn", "sandwich", "blce"])
def test_flow_step_gradients_match(one_step, group):
    """The port's raw gradients against the JAX step's first Adam moment
    from zero, m = (1 − β1)·g, with BLCE's global-norm clip applied before
    Adam. The offsets' gradient is held through the densify statistics."""
    gi = ["stat", "dyn", "sandwich", "blce"].index(group)
    pg = one_step["p_grads"][gi]
    mu = one_step["j_new"][f"{group}_opt"]["mu"]
    scale = 1.0
    if group == "blce":
        gnorm = float(torch.sqrt(sum(torch.sum(g * g) for g in pg) + 1e-20))
        scale = min(1.0, 1.0 / gnorm)
    n_nonzero = 0
    for name, a in zip(list(mu), pg):
        b = np.asarray(mu[name]) / np.float32(0.1)
        assert tuple(a.shape) == b.shape, name
        if not np.abs(b).max():
            assert not a.any(), f"{group}.{name}: the reference has no gradient"
            continue
        n_nonzero += 1
        rel_close(a * scale, b, STEP_TOL[group], f"{group}.{name}")
    assert n_nonzero > 0


@pytest.mark.parametrize("group", ["stat_opt", "dyn_opt", "sandwich_opt",
                                   "blce_opt"])
def test_flow_step_adam_state_matches(one_step, group):
    pst, jst = getattr(one_step["p_new"], group), one_step["j_new"][group]
    names = list(jst["mu"])
    assert pst.step == int(jst["step"]) == 1
    tol = STEP_TOL[group[:-4]]
    for name, m, v in zip(names, pst.mu, pst.nu):
        rel_close(m, jst["mu"][name], tol, f"{group}.mu.{name}")
        rel_close(v, jst["nu"][name], 2 * tol, f"{group}.nu.{name}")
    src = group[:-4]
    p_new = one_step["p_new"]
    leaves = {"stat": G.split_diff(p_new.stat)[0], "dyn": G.split_diff(p_new.dyn)[0],
              "sandwich": step.sandwich_leaves(p_new.sandwich),
              "blce": p_new.blce.params.leaves()}[src]
    jparams = (one_step["j_new"][src]["params"] if src == "blce"
               else one_step["j_new"][src])
    for name, p in zip(names, leaves):
        jm = np.asarray(jst["mu"][name])
        if not np.abs(jm).max():
            continue
        sel = np.abs(jm) > 1e-3 * np.abs(jm).max()
        np.testing.assert_allclose(p.detach().numpy()[sel], jparams[name][sel],
                                   atol=1e-5, rtol=1e-5, err_msg=f"{src}.{name}")


def test_flow_step_densify_stats_match(one_step):
    for key in ("stat_stats", "dyn_stats"):
        ps, js = getattr(one_step["p_new"], key), one_step["j_new"][key]
        rel_close(ps.xyz_grad_accum, js["xyz_grad_accum"], STEP_TOL["offsets"],
                  f"{key}.xyz_grad_accum")
        np.testing.assert_array_equal(ps.denom.numpy(), js["denom"])
        np.testing.assert_array_equal(ps.max_radii2d.numpy(), js["max_radii2d"])
        assert float(ps.denom.sum()) > 0
    assert one_step["p_new"].step == int(one_step["j_new"]["step"]) == 1


def test_flow_loss_history_of_three_steps(world):
    jts, pts = _jax_state(world), _port_state(world)
    js, ps = jL.BatchSampler(V, 2, seed=1), loop.BatchSampler(V, 2, seed=1)
    for k in range(3):
        ids = ps.next_ids()
        np.testing.assert_array_equal(ids, js.next_ids())
        jts, jm = world["jstep"](jts, jL.make_batch(world["jdata"], ids))
        pts, pm = world["pstep"](pts, loop.make_batch(world["pdata"], ids, "cpu"))
        np.testing.assert_allclose(float(pm.loss), float(jm.loss), rtol=1e-4,
                                   err_msg=f"step {k}")
        np.testing.assert_allclose(float(pm.flow), float(jm.flow), rtol=1e-3,
                                   err_msg=f"step {k}")
        np.testing.assert_allclose(float(pm.psnr), float(jm.psnr), atol=1e-3)
        assert float(pm.flow) > 0
    assert pts.step == 3


# ---------------------------------------------------------------------------
# the exposure re-estimation

EXPO_IDS = np.array([0, 3])  # view 0 is an endpoint


def _expo_args(data, ids):
    """The loop's arguments for a batch (``loop.py:393-403``)."""
    fwd = np.minimum(ids + 1, V - 1)
    bwd = np.maximum(ids - 1, 0)
    return (ids, data.w2c[ids], data.K[ids], data.time[ids], data.blur_feats[ids],
            data.w2c[fwd], data.w2c[bwd], (ids == 0) | (ids == V - 1))


def _valid_ratios(pts, data, ids, b):
    """The ratios the update takes the median of, for view b of the batch."""
    ids_, w2c, K, time, bf, fwd, bwd, _ = _expo_args(data, ids)
    cam = Camera(t(w2c[b]), t(K[b]), t(time[b]))
    lat_c2w, _ = B.latent_poses(pts.blce, se3.view_to_world(t(w2c[b])), t(bf[b]),
                                int(ids_[b]), E)
    lat_w2c = se3.view_to_world(lat_c2w)
    _, cam_flow = R.get_flow_static(pts.stat, Camera(t(bwd[b]), t(K[b]), t(time[b])),
                                    Camera(t(fwd[b]), t(K[b]), t(time[b])), cam, W, H,
                                    config=CFG)
    _, lat_flow = R.get_flow_static(pts.stat, Camera(lat_w2c[0], t(K[b]), t(time[b])),
                                    Camera(lat_w2c[-1], t(K[b]), t(time[b])), cam, W, H,
                                    config=CFG)
    cam_mag = torch.linalg.norm(cam_flow, dim=-1).reshape(-1)
    lat_mag = torch.linalg.norm(lat_flow, dim=-1).reshape(-1)
    valid = cam_mag > torch.quantile(cam_mag, 0.01)
    return (lat_mag / cam_mag)[valid]


def test_exposure_update_matches(world):
    jts, pts = _jax_state(world), _port_state(world)
    args = _expo_args(world["pdata"], EXPO_IDS)
    jnew = jstep.make_exposure_update(W, H, 1.0, E, JCFG)(
        jts, *(jnp.asarray(a) for a in args))
    update = step.make_exposure_update(W, H, 1.0, E, CFG)
    before = pts.blce.exposure_expo.clone()
    pnew = update(pts, t(args[0]), *(t(a) for a in args[1:]))
    assert torch.equal(pts.blce.exposure_expo, before)  # the old state untouched
    got, want = pnew.blce.exposure_expo.numpy(), np.asarray(jnew.blce.exposure_expo)
    np.testing.assert_allclose(got, want, rtol=1e-4)
    # written only at the batch's views, and finite there
    rest = np.setdiff1d(np.arange(V), EXPO_IDS)
    np.testing.assert_array_equal(got[rest], before.numpy()[rest])
    assert np.isfinite(got).all() and (got[EXPO_IDS] != before.numpy()[EXPO_IDS]).all()
    assert pnew.blce.params is pts.blce.params
    # the median trap: view 3 has an even count of valid ratios, whose two
    # middle values differ; jnp.nanmedian takes their mean, torch.nanmedian
    # would take the lower one
    with torch.no_grad():
        ratio = _valid_ratios(pts, world["pdata"], EXPO_IDS, 1)
    assert ratio.numel() % 2 == 0
    lo = float(torch.nanmedian(ratio))
    assert lo != float(torch.quantile(ratio, 0.5))
    assert abs(float(got[3]) - lo) > 1e-4 * abs(lo)
    np.testing.assert_allclose(float(got[3]), float(torch.quantile(ratio, 0.5)),
                               rtol=1e-6)
    # the endpoint view's estimate is halved
    with torch.no_grad():
        ratio0 = _valid_ratios(pts, world["pdata"], EXPO_IDS, 0)
    np.testing.assert_allclose(float(got[0]), 0.5 * float(torch.quantile(ratio0, 0.5)),
                               rtol=1e-6)
