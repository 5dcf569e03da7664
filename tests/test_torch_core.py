"""PyTorch port vs the JAX package: core math, splines, k-NN, Gaussian
state, Sandwich decoder, cameras, projection and binning.

Inputs are made from a seed with numpy and fed to both. Tolerances:
atol/rtol 1e-5 for float math; radii equal; binning bit-identical given
the JAX splats.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mobgs_tpu.core import knn as jknn
from mobgs_tpu.core import se3 as jse3
from mobgs_tpu.core import sh as jsh
from mobgs_tpu.core import spline as jspline
from mobgs_tpu.data import cameras as jcam
from mobgs_tpu.models import blce as jblce
from mobgs_tpu.models import gaussians as jG
from mobgs_tpu.models import sandwich as jsand
from mobgs_tpu.ops import projection as jproj
from mobgs_tpu.ops import tiles as jtiles

from mobgs_tpu_torch.core import knn, se3, sh, spline
from mobgs_tpu_torch.data import cameras
from mobgs_tpu_torch.io import from_jax
from mobgs_tpu_torch.models import blce
from mobgs_tpu_torch.models import gaussians as G
from mobgs_tpu_torch.models import sandwich
from mobgs_tpu_torch.ops import projection, tiles

TOL = dict(atol=1e-5, rtol=1e-5)
W, H = 64, 48


def t(x):
    return torch.as_tensor(np.asarray(x))


def close(a, b, **kw):
    np.testing.assert_allclose(np.asarray(a.detach().cpu() if isinstance(
        a, torch.Tensor) else a), np.asarray(b), **(kw or TOL))


def test_se3_and_sh_match():
    rng = np.random.default_rng(0)
    q = rng.normal(size=(50, 4)).astype(np.float32)
    q[0] = 0.0  # dead slot: the rsqrt clamp keeps it finite
    close(se3.normalize(t(q)), jse3.normalize(jnp.asarray(q)))
    close(se3.quat_to_rotmat(t(q)), jse3.quat_to_rotmat(jnp.asarray(q)))
    R = np.asarray(jse3.quat_to_rotmat(jnp.asarray(q[1:5])))
    w2c = np.tile(np.eye(4, dtype=np.float32), (4, 1, 1))
    w2c[:, :3, :3] = R
    w2c[:, :3, 3] = rng.normal(size=(4, 3))
    close(se3.view_to_world(t(w2c)), jse3.view_to_world(jnp.asarray(w2c)))
    rgb = rng.uniform(size=(10, 3)).astype(np.float32)
    close(sh.rgb_to_sh(t(rgb)), jsh.rgb_to_sh(jnp.asarray(rgb)))
    close(sh.sh_to_rgb(t(rgb)), jsh.sh_to_rgb(jnp.asarray(rgb)))
    # zero quaternion: the gradient stays finite too
    z = torch.zeros(1, 4, requires_grad=True)
    se3.normalize(z).sum().backward()
    assert torch.isfinite(z.grad).all()


def test_spline_eval_and_fit_match():
    rng = np.random.default_rng(1)
    P, K, C = 40, 12, 3
    control = rng.normal(size=(P, K, C)).astype(np.float32)
    n = rng.integers(4, K + 1, size=P).astype(np.int32)
    tt = rng.uniform(size=P).astype(np.float32)
    close(spline.eval_spline(t(control), t(tt), t(n)),
          jspline.eval_spline(jnp.asarray(control), jnp.asarray(tt),
                              jnp.asarray(n)))
    close(spline.eval_spline(t(control), 0.37, t(n)),
          jspline.eval_spline(jnp.asarray(control), 0.37, jnp.asarray(n)))
    times = np.linspace(0, 1, 9).astype(np.float32)
    close(spline.design_matrix(t(times), torch.tensor(7, dtype=torch.int32), 12),
          jspline.design_matrix(jnp.asarray(times), jnp.int32(7), 12))
    traj = rng.normal(size=(P, 9, 3)).astype(np.float32)
    close(spline.fit_spline_shared(t(traj), t(times), 6, 12),
          jspline.fit_spline_shared(jnp.asarray(traj), jnp.asarray(times), 6, 12),
          atol=1e-4, rtol=1e-4)


def test_knn_matches():
    rng = np.random.default_rng(2)
    pts = rng.normal(size=(300, 3)).astype(np.float32)
    close(knn.mean_knn_sq_dist(t(pts), block=128),
          jknn.mean_knn_sq_dist(jnp.asarray(pts), block=128))


def _jax_state(dynamic: bool, seed=0, n=60, cap=80):
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(n, 3)).astype(np.float32)
    pts[:, 2] += 6.0
    cols = rng.uniform(size=(n, 3)).astype(np.float32)
    times = rng.uniform(size=n).astype(np.float32)
    kw = {}
    if dynamic:
        tt = np.linspace(0, 1, 24).astype(np.float32)  # >= 12 knots
        vel = rng.normal(size=(n, 3)).astype(np.float32) * 0.3
        kw = dict(trajectory=pts[:, None] + vel[:, None] * tt[None, :, None],
                  traj_times=tt)
    js = jG.create_state(jnp.asarray(pts), jnp.asarray(cols),
                         jnp.asarray(times), cap,
                         **{k: jnp.asarray(v) for k, v in kw.items()},
                         rng=jax.random.PRNGKey(seed))
    return js, (pts, cols, times, cap, kw)


def test_create_state_matches():
    js, (pts, cols, times, cap, kw) = _jax_state(dynamic=True)
    ps = G.create_state(pts, cols, times, cap,
                        **{k: t(v) for k, v in kw.items()}, device="cpu")
    for f in jG.GaussianState._fields:
        # control points come out of a 12x12 least-squares solve in
        # 1e2-scaled units (values ~1e2): the two LAPACKs differ there
        tol = dict(atol=1e-3, rtol=1e-4) if f == "control_xyz" else TOL
        close(getattr(ps, f), getattr(js, f), err_msg=f, **tol)
    assert isinstance(ps.xyz, torch.nn.Parameter)
    assert ps.control_num.dtype == torch.int32 and ps.live.dtype == torch.bool
    # static pool: the control points are seeded noise around the cloud
    gen = torch.Generator().manual_seed(3)
    st = G.create_state(pts, cols, times, cap, generator=gen, device="cpu")
    assert st.control_xyz.shape == (cap, G.CONTROL_NUM, 3)
    assert not st.live[len(pts):].any()
    assert (st.control_num[len(pts):] == 4).all()


def test_state_accessors_match():
    js, _ = _jax_state(dynamic=True, seed=4)
    ps = from_jax.gaussian_state_from_numpy(
        {f: np.asarray(getattr(js, f)) for f in js._fields}, device="cpu")
    rng = np.random.default_rng(4)
    omega = rng.normal(size=ps.omega.shape).astype(np.float32) * 0.1
    ft = rng.normal(size=ps.features_t.shape).astype(np.float32)
    js = js._replace(omega=jnp.asarray(omega), features_t=jnp.asarray(ft))
    with torch.no_grad():
        ps.omega.copy_(t(omega))
        ps.features_t.copy_(t(ft))
    dt_j = jG.time_offset(js, 0.3)
    dt_p = G.time_offset(ps, 0.3)
    close(dt_p, dt_j)
    close(G.rotation_at(ps, dt_p), jG.rotation_at(js, dt_j))
    close(G.features_at(ps, dt_p), jG.features_at(js, dt_j))
    close(G.positions_at(ps, 0.3), jG.positions_at(js, 0.3), atol=1e-5, rtol=1e-4)
    close(G.act_opacity(ps), jG.act_opacity(js))
    close(G.act_scaling(ps), jG.act_scaling(js))
    assert int(ps.num_live()) == int(js.num_live())


def test_sandwich_and_rays_match():
    jparams = jsand.init_sandwich(jax.random.PRNGKey(5))
    p = from_jax.sandwich_from_numpy(
        {f: np.asarray(getattr(jparams, f)) for f in jparams._fields},
        device="cpu")
    rng = np.random.default_rng(5)
    feat = rng.normal(size=(H, W, 9)).astype(np.float32)
    Kn = np.array([[55.0, 0, W / 2], [0, 57.0, H / 2], [0, 0, 1]], np.float32)
    w2c = np.eye(4, dtype=np.float32)
    w2c[:3, :3] = np.asarray(jse3.quat_to_rotmat(jnp.asarray([0.9, 0.1, -0.2, 0.3])))
    w2c[:3, 3] = [0.2, -0.1, 0.5]
    jc = jcam.Camera(jnp.asarray(w2c), jnp.asarray(Kn), jnp.float32(0.4))
    pc = cameras.Camera(t(w2c), t(Kn), torch.tensor(0.4))
    rays_j = jcam.cam_rays(jc, W, H)
    rays_p = cameras.cam_rays(pc, W, H)
    close(rays_p, rays_j)
    close(sandwich.apply_sandwich(p, t(feat), rays_p),
          jsand.apply_sandwich(jparams, jnp.asarray(feat), rays_j))
    close(sandwich.apply_sandwich(p, t(feat), rays_p, clamp=True),
          jsand.apply_sandwich(jparams, jnp.asarray(feat), rays_j, clamp=True))
    own = sandwich.init_sandwich(torch.Generator().manual_seed(0), device="cpu")
    assert own.w1.shape == (12, 6) and float(own.w1.detach().abs().max()) <= 12 ** -0.5


def test_blur_feature_matches():
    rng = np.random.default_rng(6)
    img = rng.uniform(size=(H, W, 3)).astype(np.float32)
    close(blce.blur_feature(t(img)), jblce.blur_feature(jnp.asarray(img)))


def _scene(n=300, seed=0):
    rng = np.random.default_rng(seed)
    means = rng.normal(size=(n, 3)).astype(np.float32)
    means[:, 2] += 6.0
    means[:5, 2] = -1.0  # behind the camera: culled
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    scales = np.exp(rng.uniform(-3.5, -0.5, size=(n, 3))).astype(np.float32)
    viewmat = np.eye(4, dtype=np.float32)
    viewmat[:3, 3] = [0.1, -0.2, 0.3]
    Kn = np.array([[60.0, 0, W / 2], [0, 60.0, H / 2], [0, 0, 1]], np.float32)
    return means, quats, scales, viewmat, Kn


def test_projection_matches():
    args = _scene()
    js = jproj.project(*map(jnp.asarray, args), W, H)
    ps = projection.project(*map(t, args), W, H)
    close(ps.means2d, js.means2d, atol=1e-4, rtol=1e-5)  # pixel units
    close(ps.conics, js.conics, atol=1e-5, rtol=1e-4)
    close(ps.depths, js.depths)
    np.testing.assert_array_equal(ps.radii.numpy(), np.asarray(js.radii))
    assert ps.radii.dtype == torch.int32
    cov_j = jproj.quat_scale_to_cov3d(jnp.asarray(args[1]), jnp.asarray(args[2]))
    close(projection.quat_scale_to_cov3d(t(args[1]), t(args[2])), cov_j)


@pytest.mark.parametrize("tpg,K", [(36, 128), (9, 64), (4, 64)])
def test_binning_bit_identical(tpg, K):
    js = jproj.project(*map(jnp.asarray, _scene(n=400, seed=7)), W, H)
    ps = projection.ProjectedSplats(*(t(x) for x in js))
    jb = jtiles.bin_gaussians(js, W, H, tiles_per_gauss=tpg, max_per_tile=K)
    pb = tiles.bin_gaussians(ps, W, H, tiles_per_gauss=tpg, max_per_tile=K)
    np.testing.assert_array_equal(pb.gauss_ids.numpy(), np.asarray(jb.gauss_ids))
    np.testing.assert_array_equal(pb.counts.numpy(), np.asarray(jb.counts))
    assert int(pb.max_count) == int(jb.max_count)
    assert (pb.n_tiles_x, pb.n_tiles_y) == (jb.n_tiles_x, jb.n_tiles_y)
    assert pb.gauss_ids.dtype == torch.int32 and pb.counts.dtype == torch.int32
    assert tiles.suggest_tiles_per_gauss(ps.radii) == \
        jtiles.suggest_tiles_per_gauss(js.radii)


def test_entry_point_without_device_needs_a_card():
    """Without ``device=`` an entry point runs on the card; where none is
    present it raises rather than running on the CPU."""
    pts = np.random.default_rng(8).normal(size=(8, 3)).astype(np.float32)
    cols = np.full((8, 3), 0.5, np.float32)
    if torch.cuda.is_available():
        st = G.create_state(pts, cols, np.zeros(8, np.float32), 8)
        assert st.xyz.is_cuda
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            G.create_state(pts, cols, np.zeros(8, np.float32), 8)
        with pytest.raises(RuntimeError, match="cuda"):
            sandwich.init_sandwich()


def _rotations(rng, n):
    """Random rotations, and ones whose trace is negative with each of the
    three diagonal terms the largest (every branch of rotmat_to_quat)."""
    q = rng.normal(size=(n, 4)).astype(np.float32)
    R = np.asarray(jse3.quat_to_rotmat(jnp.asarray(q)))
    flips = [np.diag(d).astype(np.float32) for d in ((1, -1, -1), (-1, 1, -1), (-1, -1, 1))]
    return np.concatenate([R, np.stack(flips), np.stack([f @ R[0] for f in flips])])


def test_se3_camera_math_matches():
    """rotmat_to_quat, quat_multiply, world_to_view, projection_matrix,
    fov2focal and focal2fov (``se3.py:54-92,137-180``): rtol 1e-6."""
    rng = np.random.default_rng(7)
    tol = dict(rtol=1e-6, atol=1e-7)
    R = _rotations(rng, 32)
    np.testing.assert_allclose(se3.rotmat_to_quat(t(R)).numpy(),
                               np.asarray(jse3.rotmat_to_quat(jnp.asarray(R))), **tol)
    a, b = (rng.normal(size=(16, 4)).astype(np.float32) for _ in range(2))
    np.testing.assert_allclose(se3.quat_multiply(t(a), t(b)).numpy(),
                               np.asarray(jse3.quat_multiply(jnp.asarray(a), jnp.asarray(b))),
                               **tol)
    tv = rng.normal(size=3).astype(np.float32)
    np.testing.assert_allclose(se3.world_to_view(t(R[0]), t(tv)).numpy(),
                               np.asarray(jse3.world_to_view(R[0], tv)), **tol)
    np.testing.assert_allclose(se3.projection_matrix(0.01, 100.0, 0.9, 0.6).numpy(),
                               np.asarray(jse3.projection_matrix(0.01, 100.0, 0.9, 0.6)),
                               **tol)
    fov = rng.uniform(0.3, 1.5, size=8).astype(np.float32)
    np.testing.assert_allclose(se3.fov2focal(t(fov), 512).numpy(),
                               np.asarray(jse3.fov2focal(jnp.asarray(fov), 512)), **tol)
    np.testing.assert_allclose(se3.focal2fov(t(fov * 400), 288).numpy(),
                               np.asarray(jse3.focal2fov(jnp.asarray(fov * 400), 288)), **tol)
    assert abs(se3.focal2fov(se3.fov2focal(0.7, 512), 512) - 0.7) < 1e-12
