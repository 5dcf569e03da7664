"""The port's flow-off train step vs the JAX package's, and the modules it
runs: the SE(3) exp-map, SSIM/PSNR, the four flow-off losses, the learning
rate schedules, Adam, the densify statistics and BLCE's latent poses.

Inputs are made from a seed with numpy (the scene, the JAX package's
initial state carried across with ``io/from_jax.py``) and fed to both. The
JAX step composites with its Pallas kernels in interpret mode
(``RasterConfig(backend="pallas")``); the port's CPU step with the plain
forward and the plain backward, which keep the Pallas semantics.

Tolerances, and why:
- elementwise math (se3, losses, lr schedules, Adam on given inputs,
  densify stats): atol/rtol 1e-5, float32 rounding of the same formulas;
- SSIM: 1e-5 on the value, gradients atol 1e-6 (the conv sums run in
  another order; the gradients are O(1e-4));
- latent poses: values 1e-5; parameter gradients relative to the leaf's
  norm, 1e-3: the exp-map's 1/|w| axis normalisation multiplies rounding
  in the pose gradients (the reason for the clip at ``step.py:446-454``);
- the step: loss and Metrics rtol 1e-5 (PSNR atol 1e-4), every gradient
  leaf and the Adam moments relative to the leaf's largest magnitude at
  the tolerances in STEP_TOL (the compositor's sums run in another order,
  the suffix-anchor subtraction amplifies that by up to 1/(1 − α) ≤ 100,
  and projection carries it into the 3D fields); updated parameters only
  where |g| > 1e-3·max|g| of the leaf: with eps=1e-15 an Adam step is ±lr
  wherever a gradient is tiny but nonzero, and two implementations can
  round such a gradient to opposite signs (the Adam trap);
- densify stats: the view-space gradient norm like a gradient leaf; the
  visibility count and the radii exactly.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mobgs_tpu.config import OptimizationParams as JOpt
from mobgs_tpu.core import image as jimage
from mobgs_tpu.core import se3 as jse3
from mobgs_tpu.data.synthetic import SceneData as JSceneData
from mobgs_tpu.models import blce as jB
from mobgs_tpu.models import gaussians as jG
from mobgs_tpu.models import sandwich as jsand
from mobgs_tpu.ops.rasterize import RasterConfig as JRasterConfig
from mobgs_tpu.train import densify as jD
from mobgs_tpu.train import loop as jL
from mobgs_tpu.train import losses as jlosses
from mobgs_tpu.train import optim as joptim
from mobgs_tpu.train import step as jstep

from mobgs_tpu_torch.config import OptimizationParams
from mobgs_tpu_torch.core import image, se3
from mobgs_tpu_torch.data.synthetic import SceneData
from mobgs_tpu_torch.io import from_jax
from mobgs_tpu_torch.models import blce as B
from mobgs_tpu_torch.models import gaussians as G
from mobgs_tpu_torch.ops import cuda_raster
from mobgs_tpu_torch.ops.rasterize import RasterConfig
from mobgs_tpu_torch.train import densify, loop, losses, optim, step

W, H, V, E = 48, 32, 6, 3
KMAT = np.array([[50.0, 0, W / 2], [0, 50.0, H / 2], [0, 0, 1]], np.float32)
CFG = RasterConfig(max_per_tile=256)
JCFG = JRasterConfig(max_per_tile=256, tile_chunk=6, backend="pallas")
TOL = dict(atol=1e-5, rtol=1e-5)
# per-leaf tolerance relative to the leaf's largest magnitude
STEP_TOL = {"stat": 2e-3, "dyn": 2e-3, "sandwich": 1e-4, "blce": 1e-3,
            "offsets": 2e-3}


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
# the modules


def test_se3_exp_wvtheta_values_and_grads():
    rng = np.random.default_rng(0)
    w = rng.normal(size=(9, 3)).astype(np.float32)
    w[0] = 0.0  # the rsqrt clamp keeps a zero axis finite
    v = rng.normal(size=(9, 3)).astype(np.float32)
    th = rng.normal(size=(9, 1)).astype(np.float32)
    g = rng.normal(size=(9, 4, 4)).astype(np.float32)

    def jf(w, v, th):
        return jnp.sum(jse3.se3_exp_wvtheta(w, v, th) * g)

    jv = jse3.se3_exp_wvtheta(*map(jnp.asarray, (w, v, th)))
    jg = jax.jit(jax.grad(jf, argnums=(0, 1, 2)))(*map(jnp.asarray, (w, v, th)))
    args = [t(x).requires_grad_(True) for x in (w, v, th)]
    pv = se3.se3_exp_wvtheta(*args)
    pg = torch.autograd.grad(torch.sum(pv * t(g)), args)
    np.testing.assert_allclose(pv.detach().numpy(), np.asarray(jv), **TOL)
    for a, b in zip(pg, jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(se3.skew(t(w)).numpy(), np.asarray(jse3.skew(w)))


def test_ssim_psnr_values_and_grads():
    rng = np.random.default_rng(1)
    a = rng.uniform(size=(2, 3, 20, 24)).astype(np.float32)
    b = np.clip(a + 0.1 * rng.normal(size=a.shape), 0, 1).astype(np.float32)
    jv, jg = jax.value_and_grad(lambda x: jimage.ssim(x, jnp.asarray(b)))(
        jnp.asarray(a))
    x = t(a).requires_grad_(True)
    pv = image.ssim(x, t(b))
    (pg,) = torch.autograd.grad(pv, x)
    np.testing.assert_allclose(float(pv.detach()), float(jv), **TOL)
    np.testing.assert_allclose(pg.numpy(), np.asarray(jg), atol=1e-6, rtol=1e-4)
    np.testing.assert_allclose(image.ssim(t(a), t(b), size_average=False).numpy(),
                               np.asarray(jimage.ssim(a, b, size_average=False)),
                               **TOL)
    mask = (rng.uniform(size=(2, 1, 20, 24)) > 0.5).astype(np.float32)
    np.testing.assert_allclose(image.psnr(t(a), t(b)).numpy(),
                               np.asarray(jimage.psnr(a, b)), **TOL)
    np.testing.assert_allclose(image.psnr(t(a), t(b), t(mask)).numpy(),
                               np.asarray(jimage.psnr(a, b, mask)), **TOL)


@pytest.mark.parametrize("name", ["l1", "l1_masked", "ssim_term", "entropy",
                                  "sparsity"])
def test_losses_values_and_grads(name):
    rng = np.random.default_rng(2)
    a = rng.uniform(-0.05, 1.05, size=(2, 3, 16, 20)).astype(np.float32)
    b = rng.uniform(size=a.shape).astype(np.float32)
    mask = (rng.uniform(size=(2, 1, 16, 20)) > 0.3).astype(np.float32)
    fns = {
        "l1": (lambda x: jlosses.l1_loss(x, b), lambda x: losses.l1_loss(x, t(b))),
        "l1_masked": (lambda x: jlosses.l1_loss(x, b, mask),
                      lambda x: losses.l1_loss(x, t(b), t(mask))),
        "ssim_term": (lambda x: jlosses.ssim_loss_term(x, b),
                      lambda x: losses.ssim_loss_term(x, t(b))),
        "entropy": (jlosses.entropy_loss, losses.entropy_loss),
        "sparsity": (jlosses.sparsity_loss, losses.sparsity_loss),
    }
    jfn, pfn = fns[name]
    jv, jg = jax.value_and_grad(jfn)(jnp.asarray(a))
    x = t(a).requires_grad_(True)
    pv = pfn(x)
    (pg,) = torch.autograd.grad(pv, x)
    np.testing.assert_allclose(float(pv.detach()), float(jv), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(pg.numpy(), np.asarray(jg), rtol=1e-5, atol=1e-6)


def test_lr_schedules_match():
    jopt, popt = JOpt(), OptimizationParams()
    for s in (0, 1, 7, 5000, 19_999, 20_000, 30_000):
        np.testing.assert_allclose(
            optim.expon_lr(s, 1e-3, 1e-5, 20_000),
            float(joptim.expon_lr(s, 1e-3, 1e-5, 20_000)), rtol=1e-6)
        np.testing.assert_allclose(
            optim.expon_lr(s, 1e-3, 1e-5, 20_000, 100, 0.01),
            float(joptim.expon_lr(s, 1e-3, 1e-5, 20_000, 100, 0.01)), rtol=1e-6)
        got = optim.gaussian_lrs(popt, s, 5.0)
        want = joptim.gaussian_lrs(jopt, s, 5.0)
        for f in G.DIFF_FIELDS:
            np.testing.assert_allclose(getattr(got, f), float(getattr(want, f)),
                                       rtol=1e-6, err_msg=f)
    assert optim.expon_lr(10, 0.0, 0.0, 100) == 0.0


def test_adam_update_matches():
    rng = np.random.default_rng(3)
    shapes = [(5, 3), (4,), (2, 2, 2)]
    params = [rng.normal(size=s).astype(np.float32) for s in shapes]
    lrs = [1e-2, 0.0, 3e-4]
    jp, jst = tuple(map(jnp.asarray, params)), None
    pp = [t(p) for p in params]
    jst, pst = joptim.init_adam(jp), optim.init_adam(pp)
    for k in range(3):
        grads = [rng.normal(size=s).astype(np.float32) * 10.0 ** -k
                 for s in shapes]
        jp, jst = joptim.adam_update(jp, tuple(map(jnp.asarray, grads)), jst,
                                     tuple(map(jnp.float32, lrs)))
        pst = optim.adam_update(pp, [t(g) for g in grads], pst, lrs)
    assert pst.step == int(jst.step) == 3
    for a, b in zip(pp, jp):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    for a, b in zip(pst.mu + pst.nu, jst.mu + jst.nu):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    np.testing.assert_array_equal(pp[1].numpy(), params[1])  # lr 0


def test_add_stats_matches():
    rng = np.random.default_rng(4)
    M = 50
    grads = rng.normal(size=(M, 2)).astype(np.float32)
    radii = rng.integers(0, 9, size=M).astype(np.int32)
    vis = radii > 0
    js = jD.add_stats(jD.init_stats(M), jnp.asarray(grads), jnp.asarray(radii),
                      jnp.asarray(vis))
    js = jD.add_stats(js, jnp.asarray(grads[::-1].copy()), jnp.asarray(radii // 2),
                      jnp.asarray(vis))
    ps = densify.add_stats(densify.init_stats(M, "cpu"), t(grads), t(radii), t(vis))
    ps = densify.add_stats(ps, t(grads[::-1].copy()), t(radii // 2), t(vis))
    for a, b in zip(ps, js):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


def test_latent_poses_values_and_grads():
    rng = np.random.default_rng(5)
    jstate = jB.init_blce(jax.random.PRNGKey(7), num_views=4, num_warp=9)
    # larger decoders than the tiny init, so the poses move and every
    # parameter has a gradient
    params = jstate.params._replace(**{
        k: jnp.asarray(rng.normal(size=getattr(jstate.params, k).shape)
                       .astype(np.float32) * s)
        for k, s in (("rot_w", 0.3), ("theta_w", 0.3), ("trans_w", 0.3),
                     ("view_embed", 0.5), ("time_embed", 0.5))})
    jstate = jstate._replace(params=params,
                             exposure_expo=jnp.asarray([0.4, 0.3, 0.5, 0.2]))
    pstate = from_jax.blce_from_numpy(to_numpy(jstate), device="cpu")
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, :3] = np.asarray(jse3.quat_to_rotmat(jnp.asarray([0.9, 0.1, -0.2, 0.3])))
    c2w[:3, 3] = [0.3, -0.1, 0.5]
    bf, vi = np.float32(0.37), 2
    gp = rng.normal(size=(9, 4, 4)).astype(np.float32)

    def jloss(p):
        poses, expo = jB.latent_poses(jstate._replace(params=p), jnp.asarray(c2w),
                                      jnp.asarray(bf), vi, 9)
        return jnp.sum(poses * gp), (poses, expo)

    (_, (jposes, jexpo)), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        params)
    pposes, pexpo = B.latent_poses(pstate, t(c2w), t(bf), vi, 9)
    pg = torch.autograd.grad(torch.sum(pposes * t(gp)), pstate.params.leaves())
    np.testing.assert_allclose(pposes.detach().numpy(), np.asarray(jposes), **TOL)
    np.testing.assert_allclose(pexpo.numpy(), np.asarray(jexpo), **TOL)
    for name, a in zip(B.BLCE_FIELDS, pg):
        b = np.asarray(getattr(jg, name))
        rel_close(a, b, 1e-3, name)
        assert not a[[0, 1, 3]].any(), name  # only this view's row


def test_init_blce_laws():
    """Same shapes and laws as the JAX init (its numbers come from another
    generator): U(±1/√fan_in) for the linears, the tiny Xavier bound for
    the decoders, zeros for the embeddings and decoder biases."""
    V, D, Ew = 3, 32, 9
    st = B.init_blce(torch.Generator().manual_seed(0), num_views=V, device="cpu")
    js = jB.init_blce(jax.random.PRNGKey(0), num_views=V)
    tiny = 1e-5 / np.sqrt((D // 2 + 3) / 6.0)
    for name in B.BLCE_FIELDS:
        a, b = getattr(st.params, name).detach().numpy(), np.asarray(
            getattr(js.params, name))
        assert a.shape == b.shape, name
        if name in ("view_embed", "time_embed", "rot_b", "trans_b", "theta_b"):
            assert not a.any() and not b.any(), name
            continue
        w = name.replace("_b", "_w").replace("bf_b", "bf_w")
        fan_in, fan_out = getattr(js.params, w).shape[1:]
        bound = (tiny * np.sqrt(6.0 / (fan_in + fan_out))
                 if name in ("rot_w", "trans_w", "theta_w")
                 else 1.0 / np.sqrt(fan_in))
        for x in (a, b):
            assert 0.5 * bound < np.abs(x).max() <= bound * (1 + 1e-6), name
    np.testing.assert_array_equal(st.exposure_expo.numpy(), np.asarray(js.exposure_expo))
    assert st.params.view_embed.shape == (V, D)
    assert st.params.time_embed.shape == (V, Ew, 8)


# ---------------------------------------------------------------------------
# the step


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
        # the k-NN init gives isotropic splats, whose rotation gradient is
        # rounding noise; random rotations and log-scales give it substance
        M = st.capacity
        return st._replace(
            scaling=st.scaling + jnp.asarray(
                rng.normal(0, 0.4, size=(M, 3)).astype(np.float32)),
            rotation=jnp.asarray(rng.normal(size=(M, 4)).astype(np.float32)))

    stat, dyn = anisotropic(stat), anisotropic(dyn)
    jts = jstep.init_train_state(
        stat, dyn, jsand.init_sandwich(jax.random.PRNGKey(1)),
        jB.init_blce(jax.random.PRNGKey(2), num_views=V, num_warp=E))

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
    kw = dict(iterations=100, batch_size=2, lambda_flow_loss=0.0)
    jopt, popt = JOpt(**kw), OptimizationParams(**kw)
    return dict(
        jts_np=jax.tree.map(np.asarray, jts), fields=to_numpy(jts),
        jdata=JSceneData(**arrays), pdata=SceneData(**arrays),
        jopt=jopt, popt=popt,
        # scanned views and passes: numerically the unrolled step
        # (step.py:143-146), compiled once per pass body
        jstep=jstep.make_train_step(jopt, W, H, 1.0, E, JCFG, scan_passes=True,
                                    scan_views=True),
        pstep=step.make_train_step(popt, W, H, 1.0, E, CFG))


def _jax_state(world):
    return jax.tree.map(jnp.asarray, world["jts_np"])


def _port_state(world):
    return from_jax.train_state_from_numpy(world["fields"], device="cpu")


def _port_grads(world, pts, pb):
    fwd = step.make_forward(world["popt"], W, H, 1.0, E, CFG)
    off = torch.zeros((2, pts.stat.capacity + pts.dyn.capacity, 2),
                      requires_grad=True)
    total, _ = fwd(pts.stat, pts.dyn, pts.sandwich, pts.blce, off, pb)
    groups = (G.split_diff(pts.stat)[0], G.split_diff(pts.dyn)[0],
              step.sandwich_leaves(pts.sandwich), pts.blce.params.leaves(), (off,))
    leaves = [p for grp in groups for p in grp]
    grads = torch.autograd.grad(total, leaves, allow_unused=True)
    out, i = [], 0
    for grp in groups:
        out.append([torch.zeros_like(p) if g is None else g
                    for p, g in zip(grp, grads[i:i + len(grp)])])
        i += len(grp)
    return float(total.detach()), out


@pytest.fixture(scope="module")
def one_step(world):
    ids = np.array([1, 4])
    j_new, j_metrics = world["jstep"](_jax_state(world),
                                      jL.make_batch(world["jdata"], ids))
    pb = loop.make_batch(world["pdata"], ids, device="cpu")
    p_total, p_grads = _port_grads(world, _port_state(world), pb)
    before = dict(cuda_raster.launches)
    pts = _port_state(world)
    p_new, p_metrics = world["pstep"](pts, pb)
    assert cuda_raster.launches == before  # CPU tensors: the plain route
    return dict(j_new=to_numpy(j_new), j_metrics=j_metrics, p_total=p_total,
                p_grads=p_grads, p_new=p_new, p_metrics=p_metrics)


def test_step_loss_and_metrics_match(one_step):
    jm, pm = one_step["j_metrics"], one_step["p_metrics"]
    for f in ("loss", "photo", "depth_l1", "mask"):
        np.testing.assert_allclose(float(getattr(pm, f)), float(getattr(jm, f)),
                                   rtol=1e-5, err_msg=f)
    np.testing.assert_allclose(float(pm.psnr), float(jm.psnr), atol=1e-4)
    assert float(pm.flow) == float(jm.flow) == 0.0
    assert int(pm.tile_max) == int(jm.tile_max)
    assert float(pm.loss) == one_step["p_total"]


@pytest.mark.parametrize("group", ["stat", "dyn", "sandwich", "blce"])
def test_step_gradients_match(one_step, group):
    """The port's raw gradients (autograd through its forward) against the
    JAX step's: its first Adam moment from zero is m = (1 − β1)·g, with
    BLCE's global-norm clip applied before Adam. The offsets' gradient is
    held through the densify statistics it feeds."""
    gi = ["stat", "dyn", "sandwich", "blce"].index(group)
    pg = one_step["p_grads"][gi]
    mu = one_step["j_new"][f"{group}_opt"]["mu"]
    names = list(mu)
    scale = 1.0
    if group == "blce":
        gnorm = float(torch.sqrt(sum(torch.sum(g * g) for g in pg) + 1e-20))
        scale = min(1.0, 1.0 / gnorm)
    n_nonzero = 0
    for name, a in zip(names, pg):
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
def test_step_adam_state_matches(one_step, group):
    pst, jst = getattr(one_step["p_new"], group), one_step["j_new"][group]
    names = list(jst["mu"])
    assert pst.step == int(jst["step"]) == 1
    tol = STEP_TOL[group[:-4]]
    for name, m, v in zip(names, pst.mu, pst.nu):
        rel_close(m, jst["mu"][name], tol, f"{group}.mu.{name}")
        rel_close(v, jst["nu"][name], 2 * tol, f"{group}.nu.{name}")
    # the updated parameters, where the gradient is not tiny
    pgroup = {"stat_opt": ("stat", G.split_diff(one_step["p_new"].stat)[0]),
              "dyn_opt": ("dyn", G.split_diff(one_step["p_new"].dyn)[0]),
              "sandwich_opt": ("sandwich",
                               step.sandwich_leaves(one_step["p_new"].sandwich)),
              "blce_opt": ("blce", one_step["p_new"].blce.params.leaves())}[group]
    src, leaves = pgroup
    jparams = (one_step["j_new"][src]["params"] if src == "blce"
               else one_step["j_new"][src])
    for name, p, m in zip(names, leaves, pst.mu):
        jm = np.asarray(jst["mu"][name])
        sel = np.abs(jm) > 1e-3 * np.abs(jm).max() if np.abs(jm).max() else None
        if sel is None or not sel.any():
            continue
        np.testing.assert_allclose(p.detach().numpy()[sel], jparams[name][sel],
                                   atol=1e-5, rtol=1e-5, err_msg=f"{src}.{name}")


def test_step_densify_stats_match(one_step):
    for key in ("stat_stats", "dyn_stats"):
        ps, js = getattr(one_step["p_new"], key), one_step["j_new"][key]
        rel_close(ps.xyz_grad_accum, js["xyz_grad_accum"], STEP_TOL["offsets"],
                  f"{key}.xyz_grad_accum")
        np.testing.assert_array_equal(ps.denom.numpy(), js["denom"])
        np.testing.assert_array_equal(ps.max_radii2d.numpy(), js["max_radii2d"])
        assert float(ps.denom.sum()) > 0
    assert one_step["p_new"].step == int(one_step["j_new"]["step"]) == 1


def test_loss_history_of_three_steps(world):
    jts, pts = _jax_state(world), _port_state(world)
    js, ps = jL.BatchSampler(V, 2, seed=0), loop.BatchSampler(V, 2, seed=0)
    for k in range(3):
        ids = ps.next_ids()
        np.testing.assert_array_equal(ids, js.next_ids())
        jts, jm = world["jstep"](jts, jL.make_batch(world["jdata"], ids))
        pts, pm = world["pstep"](pts, loop.make_batch(world["pdata"], ids, "cpu"))
        np.testing.assert_allclose(float(pm.loss), float(jm.loss), rtol=1e-4,
                                   err_msg=f"step {k}")
        np.testing.assert_allclose(float(pm.psnr), float(jm.psnr), atol=1e-3)
    assert pts.step == 3


def test_flow_on_step_is_refused(world):
    """The flow-on step builds (``tests/test_torch_flow.py`` holds it
    against the JAX step); before start_warp (``with_latents=False``) the
    flow term is refused, as ``compute_flow`` at ``step.py:163`` says: the
    step takes no flow passes and ``Metrics.flow`` is 0."""
    kw = dict(iterations=100, batch_size=2, lambda_flow_loss=1e-2)
    step.make_train_step(OptimizationParams(**kw), W, H, 1.0, E, CFG)
    flow_off = step.make_train_step(OptimizationParams(**kw), W, H, 1.0, E, CFG,
                                    with_latents=False)
    pb = loop.make_batch(world["pdata"], np.array([1, 4]), device="cpu")
    pts, m = flow_off(_port_state(world), pb)
    assert float(m.flow) == 0.0 and np.isfinite(float(m.loss))
    assert pts.step == 1
