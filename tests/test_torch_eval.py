"""The port's eval modules vs the JAX package's: test-pose alignment
(``eval/align.py``), test-time pose optimization (``eval/tto.py``), the
train CLI's debug images (``train/debug_vis.py``) and the debug grid and
seeding helpers (``utils/observability.py``).

A world made from a seed with numpy (Gaussians in front of the cameras,
anisotropic so the pose gradient has substance; BLCE decoders larger than
the tiny init, so the aligned poses move) is built in the JAX package and
carried across. The JAX renders composite with its Pallas kernels in
interpret mode, the port's with the plain forward and backward. The test
images are renders at the training poses; TTO starts from poses a little
off them.

Tolerances, and why: alignment atol 1e-6 (a chain of 4x4 products of the
same float32 poses); TTO at 0 steps, the render at the suite's forward
tolerance (atol 2e-5, rtol 1e-4) and the PSNR at 1e-3 dB; the first step's
pose gradients at the suite's gradient tolerance (atol 3e-4, rtol 2e-3,
``tests/test_pallas_raster.py``); after 3 steps the refined w2c atol 1e-5
(Adam's first steps move each pose scalar by about lr = 3e-4 whatever the
gradient's size, so the poses agree far closer than the gradients), with
their renders at the forward tolerance and PSNR at 1e-3 dB; the
debug PNGs within one 8-bit level (a value on a rounding boundary); the
host-side numpy helpers (flow colours, normals, image grids, the FLOP
model) exactly.
"""

import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from mobgs_tpu.core import se3 as jse3
from mobgs_tpu.data.cameras import Camera as JCamera
from mobgs_tpu.data.synthetic import SceneData as JSceneData
from mobgs_tpu.eval import align as jalign
from mobgs_tpu.eval import tto as jtto
from mobgs_tpu.models import blce as jB
from mobgs_tpu.models import gaussians as jG
from mobgs_tpu.models import render as jR
from mobgs_tpu.models import sandwich as jsand
from mobgs_tpu.ops.rasterize import RasterConfig as JRasterConfig
from mobgs_tpu.train import debug_vis as jdebug
from mobgs_tpu.utils import observability as jobs

from mobgs_tpu_torch.core import se3
from mobgs_tpu_torch.data.synthetic import SceneData
from mobgs_tpu_torch.eval import align, tto
from mobgs_tpu_torch.io import from_jax
from mobgs_tpu_torch.ops.rasterize import RasterConfig
from mobgs_tpu_torch.train import debug_vis
from mobgs_tpu_torch.utils import observability as obs

W, H, V, E = 48, 32, 4, 5
KMAT = np.array([[50.0, 0, W / 2], [0, 50.0, H / 2], [0, 0, 1]], np.float32)
JCFG = JRasterConfig(tiles_per_gauss=64, max_per_tile=512, tile_chunk=6, backend="pallas")
CFG = RasterConfig(tiles_per_gauss=64, max_per_tile=512)
FWD = dict(atol=2e-5, rtol=1e-4)
GRAD = dict(atol=3e-4, rtol=2e-3)
TTO_STEPS, DECAY_START = 3, 1


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's side runs on one CPU thread (as in test_torch_loop.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def t(x):
    return torch.as_tensor(np.array(x))


def to_numpy(x):
    if hasattr(x, "_fields"):
        return {f: to_numpy(getattr(x, f)) for f in x._fields}
    return None if x is None else np.asarray(x)


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

    def anisotropic(st):
        M = st.capacity
        return st._replace(
            scaling=st.scaling + jnp.asarray(rng.normal(0, 0.4, size=(M, 3)).astype(np.float32)),
            rotation=jnp.asarray(rng.normal(size=(M, 4)).astype(np.float32)))

    stat, dyn = anisotropic(stat), anisotropic(dyn)
    sw = jsand.init_sandwich(jax.random.PRNGKey(1))
    blce = jB.init_blce(jax.random.PRNGKey(2), num_views=V, num_warp=E)
    blce = blce._replace(params=blce.params._replace(**{
        k: jnp.asarray(rng.normal(size=getattr(blce.params, k).shape).astype(np.float32) * s)
        for k, s in (("rot_w", 0.02), ("trans_w", 0.02), ("theta_w", 0.02),
                     ("view_embed", 0.5), ("time_embed", 0.5))}))

    w2c = np.tile(np.eye(4, dtype=np.float32), (V, 1, 1))
    for v in range(V):
        a = 0.05 * (v - V / 2)
        w2c[v, :3, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]]
        w2c[v, :3, 3] = [0.1 * v - 0.25, 0.02 * v, 0.05 * v]
    # the test images: the scene at the training poses; the test poses a
    # small rotation and shift off them
    gt = np.stack([np.asarray(jR.render_view(
        stat, dyn, sw, JCamera(jnp.asarray(w2c[v]), jnp.asarray(KMAT), jnp.asarray(times[v])),
        W, H, jnp.zeros(3), 1.0, config=JCFG).image) for v in range(V)])
    test_w2c = w2c.copy()
    for v in range(V):
        b = 0.01 * (v + 1)
        test_w2c[v, :3, :3] = np.array([[1, 0, 0], [0, np.cos(b), -np.sin(b)],
                                        [0, np.sin(b), np.cos(b)]], np.float32) @ w2c[v, :3, :3]
        test_w2c[v, :3, 3] += [0.02, -0.01, 0.03]
    arrays = dict(w2c=w2c, K=np.tile(KMAT, (V, 1, 1)), time=times,
                  images=rng.uniform(size=(V, H, W, 3)).astype(np.float32),
                  depths=rng.uniform(4.0, 8.0, size=(V, H, W)).astype(np.float32),
                  blur_feats=rng.uniform(0.2, 0.6, size=V).astype(np.float32),
                  masks=np.zeros((V, H, W), np.float32), width=W, height=H,
                  max_time=1.0, test_w2c=test_w2c, test_images=gt)
    j = types.SimpleNamespace(stat=stat, dyn=dyn, sandwich=sw, blce=blce)
    p = types.SimpleNamespace(
        stat=from_jax.gaussian_state_from_numpy(to_numpy(stat), device="cpu"),
        dyn=from_jax.gaussian_state_from_numpy(to_numpy(dyn), device="cpu"),
        sandwich=from_jax.sandwich_from_numpy(to_numpy(sw), device="cpu"),
        blce=from_jax.blce_from_numpy(to_numpy(blce), device="cpu"))
    return dict(j=j, p=p, jdata=JSceneData(**arrays), pdata=SceneData(**arrays))


def _tto_inputs(d):
    return (d.test_w2c, d.K, d.time, d.test_images, np.ones(V, np.float32))


def test_align_test_poses_matches(world):
    d = world["pdata"]
    want = np.asarray(jalign.align_test_poses(
        world["j"].blce, jnp.asarray(d.w2c), jnp.asarray(d.test_w2c),
        jnp.asarray(d.blur_feats), num_warp=E))
    got = align.align_test_poses(world["p"].blce, t(d.w2c), t(d.test_w2c),
                                 t(d.blur_feats), num_warp=E).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    assert np.abs(want - d.test_w2c).max() > 1e-4  # the BLCE poses moved it


def test_tto_without_steps_is_a_render(world):
    j, p, d = world["j"], world["p"], world["pdata"]
    want = jtto.make_tto(j.stat, j.dyn, j.sandwich, W, H, 1.0, steps=0,
                         raster_cfg=JCFG)(*map(jnp.asarray, _tto_inputs(d)))
    got = tto.make_tto(p.stat, p.dyn, p.sandwich, W, H, 1.0, steps=0,
                       raster_cfg=CFG)(*map(t, _tto_inputs(d)))
    np.testing.assert_allclose(got.renders.numpy(), np.asarray(want.renders), **FWD)
    np.testing.assert_allclose(got.psnr.numpy(), np.asarray(want.psnr), atol=1e-3)
    np.testing.assert_allclose(got.w2c.numpy(), np.asarray(want.w2c), atol=1e-6)
    assert np.all(np.asarray(want.psnr) < 60.0)  # the test poses are off


@pytest.fixture(scope="module")
def jax_tto_steps(world):
    j, d = world["j"], world["pdata"]
    return jtto.make_tto(j.stat, j.dyn, j.sandwich, W, H, 1.0, steps=TTO_STEPS,
                         decay_start=DECAY_START, raster_cfg=JCFG)(
        *map(jnp.asarray, _tto_inputs(d)))


def _jax_neg_psnr(j, K, time, gt):
    """The JAX TTO's objective (``tto.py:94-108``) from its public parts."""
    def f(q, tv):
        top = jnp.concatenate([jse3.quat_to_rotmat(q), tv[:, None]], axis=1)
        w2c = jnp.concatenate([top, jnp.array([[0.0, 0.0, 0.0, 1.0]])], axis=0)
        img = jR.render_view(j.stat, j.dyn, j.sandwich, JCamera(w2c=w2c, K=K, time=time),
                             W, H, jnp.zeros(3, jnp.float32), 1.0, config=JCFG).image
        mse = jnp.mean((img - gt) ** 2)
        return -(20.0 * jnp.log10(1.0 / jnp.sqrt(jnp.maximum(mse, 1e-12))))
    return f


@pytest.mark.parametrize("view", [0, V - 1])
def test_tto_first_step_pose_gradients_match(world, view):
    j, p, d = world["j"], world["p"], world["pdata"]
    w2c = d.test_w2c[view]
    q0 = np.asarray(jse3.rotmat_to_quat(jnp.asarray(w2c[:3, :3])))
    t0 = w2c[:3, 3]
    jg = jax.grad(_jax_neg_psnr(j, jnp.asarray(d.K[view]), jnp.asarray(d.time[view]),
                                jnp.asarray(d.test_images[view])), argnums=(0, 1))(
        jnp.asarray(q0), jnp.asarray(t0))
    _, neg_psnr = tto.pose_objective(p.stat, p.dyn, p.sandwich, W, H, 1.0, CFG)
    q = se3.rotmat_to_quat(t(w2c[:3, :3])).requires_grad_(True)
    tv = t(t0).requires_grad_(True)
    np.testing.assert_allclose(q.detach().numpy(), q0, atol=1e-7)
    pg = torch.autograd.grad(neg_psnr(q, tv, t(d.K[view]), t(d.time[view]),
                                      t(d.test_images[view])), (q, tv))
    for a, b, name in zip(pg, jg, ("q", "t")):
        assert float(np.abs(np.asarray(b)).max()) > 1e-2, name  # a real gradient
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **GRAD, err_msg=name)


def test_tto_steps_refine_the_poses_alike(world, jax_tto_steps):
    p, d = world["p"], world["pdata"]
    got = tto.make_tto(p.stat, p.dyn, p.sandwich, W, H, 1.0, steps=TTO_STEPS,
                       decay_start=DECAY_START, raster_cfg=CFG)(*map(t, _tto_inputs(d)))
    want = jax_tto_steps
    np.testing.assert_allclose(got.w2c.numpy(), np.asarray(want.w2c), atol=1e-5, rtol=0)
    moved = np.abs(np.asarray(want.w2c) - d.test_w2c).max()
    assert moved > 1e-4, moved
    np.testing.assert_allclose(got.renders.numpy(), np.asarray(want.renders), **FWD)
    np.testing.assert_allclose(got.psnr.numpy(), np.asarray(want.psnr), atol=1e-3)


def test_dump_debug_images_matches(world, tmp_path):
    jpath = jdebug.dump_debug_images(world["j"], world["jdata"], 7, str(tmp_path / "j"),
                                     view=1, raster_cfg=JCFG)
    ppath = debug_vis.dump_debug_images(world["p"], world["pdata"], 7, str(tmp_path / "p"),
                                        view=1, raster_cfg=CFG)
    assert ppath.endswith("fine_debug/iter_000007.png")
    a = np.asarray(Image.open(ppath)).astype(int)
    b = np.asarray(Image.open(jpath)).astype(int)
    assert a.shape == b.shape == (H, 7 * W, 3)
    assert np.abs(a - b).max() <= 1


def test_debug_vis_helpers_match():
    rng = np.random.default_rng(3)
    flow = rng.normal(0, 4, size=(H, W, 2)).astype(np.float32)
    np.testing.assert_array_equal(debug_vis.flow_to_color(flow), jdebug.flow_to_color(flow))
    np.testing.assert_array_equal(debug_vis.flow_to_color(flow, 2.0),
                                  jdebug.flow_to_color(flow, 2.0))
    depth = rng.uniform(3, 6, size=(H, W)).astype(np.float32)
    np.testing.assert_array_equal(debug_vis.normals_from_depth_screen(depth, KMAT),
                                  jdebug.normals_from_depth_screen(depth, KMAT))


@pytest.mark.parametrize("with_latents", [True, False])
def test_render_training_panels_layout(world, tmp_path, with_latents):
    """The panel files of ``render_training_image`` (the layout the JAX
    suite's ``tests/test_debug_vis.py`` holds), and the E latent renders at
    the BLCE poses."""
    p, d = world["p"], world["pdata"]
    out = debug_vis.render_training_panels(p, d, 300, str(tmp_path), view=2, num_warp=E,
                                           with_latents=with_latents, raster_cfg=CFG)
    name = "view002_it000300"
    want = {f"{name}.png", f"{name}_decomp.png"}
    if with_latents:
        want |= {f"{name}_{kind}_{e:02d}.png" for kind in ("latent", "flow")
                 for e in range(E)}
    assert set(os.listdir(out)) == want
    grid = np.asarray(Image.open(os.path.join(out, f"{name}.png")))
    assert grid.shape == (H, 4 * W, 3)
    assert np.asarray(Image.open(os.path.join(out, f"{name}_decomp.png"))).shape == (H, 3 * W, 3)


def test_observability_matches(tmp_path):
    imgs = {"a": np.linspace(0, 1, H * W * 3).reshape(H, W, 3), "b": np.full((H, W), 0.5)}
    obs.save_debug_grid(str(tmp_path / "p.png"), imgs)
    jobs.save_debug_grid(str(tmp_path / "j.png"), imgs)
    assert (tmp_path / "p.png").read_bytes() == (tmp_path / "j.png").read_bytes()
    obs.setup_seed(5)
    a = np.random.rand(3)
    jobs.setup_seed(5)
    np.testing.assert_array_equal(a, np.random.rand(3))
