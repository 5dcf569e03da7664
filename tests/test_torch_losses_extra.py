"""The port's auxiliary loss library (``mobgs_tpu_torch/train/losses_extra.py``)
vs the JAX package's, every public function.

Inputs are made from a seed with numpy and fed to both. Values at rtol 1e-5
(atol 1e-6, the warps' 1e-5);
the gradient with respect to the first argument, of the output's sum against
a seeded cotangent, within 1e-4 of its largest magnitude (rtol 1e-4).
``ball_query``'s indices are equal; the disparity buckets are bit-equal and
disparities exactly on a bucket edge fall on the same side as in JAX for
both ``searchsorted`` sides. ``torch.median`` is the JAX package's
``_torch_median``.

One divergence is held here: the KNN constraint's distances at a zero
distance (a point paired with itself past the dropped first hit). JAX
differentiates ``jnp.linalg.norm`` there to NaN; torch's norm has
subgradient 0, the reference's own (torch) behaviour. So the gradient is
compared where JAX's is finite and must be finite everywhere.
"""

import zlib

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mobgs_tpu.train import losses_extra as J

from mobgs_tpu_torch.train import losses_extra as L

H, W = 24, 32


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def t(x):
    return torch.as_tensor(np.array(x))


def f32(x):
    return np.asarray(x, np.float32)


def rot(rng, n):
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    w, x, y, z = q.T
    return f32(np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        np.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
        np.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1)], -2))


def cams(rng):
    """Two cameras a small motion apart, intrinsics and their inverse."""
    w2c1 = np.eye(4, dtype=np.float32)
    w2c2 = np.eye(4, dtype=np.float32)
    a = 0.05
    w2c2[:3, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]]
    w2c2[:3, 3] = [0.1, -0.05, 0.02]
    K = f32([[30.0, 0, W / 2], [0, 30.0, H / 2], [0, 0, 1]])
    return w2c1, w2c2, K, f32(np.linalg.inv(K))


def _mask(rng, shape):
    return f32(rng.uniform(size=shape) > 0.3)


# name → (kwargs for both, numpy args made from rng); arg 0 is differentiated
def cases():
    return {
        "quaternion_distance": lambda g: ((f32(g.normal(size=(20, 4))),
                                           f32(g.normal(size=(20, 4)))), {}),
        "quaternion_slerp": lambda g: ((f32(g.normal(size=4)), f32(g.normal(size=4)),
                                        f32(np.linspace(0.05, 0.95, 7))), {}),
        "trbfunction": lambda g: ((f32(g.normal(size=50)),), {}),
        "compute_tv_loss": lambda g: ((f32(g.uniform(size=(2, H, W, 3))),), {}),
        "trimmed_mse_loss": lambda g: ((f32(g.normal(size=(200, 3))),
                                        f32(g.normal(size=(200, 3)))), {}),
        "trimmed_l1_loss": lambda g: ((f32(g.normal(size=(200, 3))),
                                       f32(g.normal(size=(200, 3)))), dict(quantile=0.7)),
        "masked_mse_loss": lambda g: ((f32(g.normal(size=(200, 3))), f32(g.normal(size=(200, 3))),
                                       _mask(g, (200, 1))), dict(quantile=0.9)),
        "masked_l1_loss": lambda g: ((f32(g.normal(size=(200, 3))), f32(g.normal(size=(200, 3))),
                                      _mask(g, (200, 1))), dict(normalize=False)),
        "masked_huber_loss": lambda g: ((f32(g.normal(size=(200, 3))),
                                         f32(g.normal(size=(200, 3))), 0.5,
                                         _mask(g, (200, 1))), {}),
        "compute_gradient_loss": lambda g: ((f32(g.normal(size=(2, H, W))),
                                             f32(g.normal(size=(2, H, W))),
                                             _mask(g, (2, H, W))), {}),
        "get_weights_for_procrustes": lambda g: ((f32(g.normal(size=(5, 12, 3))),
                                                  _mask(g, (5, 12))), {}),
        "compute_z_acc_loss": lambda g: ((f32(g.normal(size=(30, 3, 4, 3))),
                                          np.stack([np.eye(4, dtype=np.float32)] * 4)
                                          + f32(np.pad(g.normal(size=(4, 3, 1)) * 0.3,
                                                       ((0, 0), (0, 1), (3, 0))))), {}),
        "compute_accel_loss": lambda g: ((f32(g.normal(size=(10, 8, 3))),), {}),
        "compute_se3_smoothness_loss": lambda g: ((f32(g.normal(size=(10, 8, 6))),
                                                   f32(g.normal(size=(10, 8, 3)))), {}),
        "l2_loss": lambda g: ((f32(g.normal(size=(2, 3, H, W))), f32(g.normal(size=(2, 3, H, W))),
                               _mask(g, (2, 1, H, W))), {}),
        "entropy_loss_logit": lambda g: ((f32(g.uniform(0.01, 0.99, size=(H, W))),), {}),
        "sparsity_loss_boost": lambda g: ((f32(g.uniform(size=(H, W))),), {}),
        "motion_consistency_loss": lambda g: ((f32(g.normal(size=(60, 3))),
                                               f32(g.normal(size=(60, 3))),
                                               f32(g.uniform(size=60))), {}),
        "sgt_smoothness": lambda g: ((f32(g.normal(size=(40, 1))), f32(g.normal(size=(40, 1))),
                                      0.3, 0.35, 0.25), {}),
        "compute_cluster_cohesion_loss": lambda g: ((f32(g.normal(size=(80, 3))),
                                                     g.integers(0, 7, size=80).astype(np.int32),
                                                     f32(g.normal(size=(6, 3)))), {}),
        "path_distance_loss_separate": lambda g: ((f32(g.normal(size=(3, 4))),
                                                   f32(g.normal(size=(15, 4)))),
                                                  dict(num_samples=40)),
        "path_distance_loss_rotation": lambda g: ((rot(g, 3), rot(g, 15)), {}),
        "path_distance_loss_translation": lambda g: ((f32(g.normal(size=(3, 3))),
                                                      f32(g.normal(size=(15, 3)))), {}),
        "loss_depth_smoothness": lambda g: ((f32(g.uniform(1, 3, size=(2, 1, H, W))),
                                             f32(g.uniform(size=(2, 3, H, W)))), {}),
        "loss_depth_grad": lambda g: ((f32(g.uniform(1, 3, size=(2, 1, H, W))),
                                       f32(g.uniform(size=(2, 3, H, W)))), {}),
        "margin_l2_loss": lambda g: ((f32(g.normal(size=(H, W))), f32(g.normal(size=(H, W))),
                                      0.5), {}),
        "margin_l1_loss": lambda g: ((f32(g.normal(size=(H, W))), f32(g.normal(size=(H, W))),
                                      0.5), {}),
        "kl_loss": lambda g: ((f32(g.normal(size=(6, 10))), f32(g.normal(size=(6, 10)))), {}),
        "patchify": lambda g: ((f32(g.normal(size=(2, 1, H + 3, W + 1))), 8), {}),
        "patch_norm_mse_loss": lambda g: ((f32(g.normal(size=(2, 1, H, W))),
                                           f32(g.normal(size=(2, 1, H, W))), 8, 0.2), {}),
        "patch_norm_mse_loss_global": lambda g: ((f32(g.normal(size=(2, 1, H, W))),
                                                  f32(g.normal(size=(2, 1, H, W))), 8, 0.2), {}),
        "patch_norm_l1_loss": lambda g: ((f32(g.normal(size=(2, 1, H, W))),
                                          f32(g.normal(size=(2, 1, H, W))), 4, 0.2), {}),
        "patch_norm_l1_loss_global": lambda g: ((f32(g.normal(size=(2, 1, H, W))),
                                                 f32(g.normal(size=(2, 1, H, W))), 4, 0.2), {}),
        "inverse_warp_grid_rt1_rt2": lambda g: ((f32(g.uniform(1, 4, size=(H, W))), *cams(g)),
                                                {}),
        "direct_warp_rt1_rt2": lambda g: ((f32(g.uniform(size=(3, H, W))),
                                           f32(g.uniform(0.5, 8, size=(H, W))), *cams(g)), {}),
        "occ_rt1_rt2": lambda g: ((f32(g.uniform(0.5, 8, size=(H, W))), *cams(g)), {}),
        "warp_pc2flow": lambda g: ((f32(g.uniform(size=(3, H, W))),
                                    f32(np.concatenate([g.uniform(-1, 1, (2, H, W)),
                                                        g.uniform(2, 4, (1, H, W))])),
                                    cams(g)[1], cams(g)[2]), {}),
    }


CASES = cases()
# their sample coordinates go through three 3x3 products: an ulp there moves a
# bilinear weight by ~1e-6 of a pixel step
WARPS = ("direct_warp_rt1_rt2", "occ_rt1_rt2", "warp_pc2flow", "inverse_warp_grid_rt1_rt2")


def _tensors(args):
    return [t(a) if isinstance(a, np.ndarray) else a for a in args]


@pytest.mark.parametrize("name", sorted(CASES))
def test_matches_jax(name):
    args, kw = CASES[name](np.random.default_rng(zlib.crc32(name.encode())))
    arrays = [i for i, a in enumerate(args) if isinstance(a, np.ndarray)]
    assert arrays[0] == 0

    def jcall(*arrs):
        full = list(args)
        for i, a in zip(arrays, arrs):
            full[i] = a
        return getattr(J, name)(*full, **kw)

    jin = [jnp.asarray(args[i]) for i in arrays]
    shape = jax.eval_shape(jcall, *jin)
    first = shape[0] if isinstance(shape, tuple) else shape
    cot = np.random.default_rng(1).normal(size=first.shape).astype(np.float32)

    def jloss(*arrs):
        out = jcall(*arrs)
        return jnp.sum((out[0] if isinstance(out, tuple) else out) * cot), out

    # one compile: the value and the first argument's gradient together
    (_, want), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(*jin)
    pargs = _tensors(args)
    pargs[0] = pargs[0].requires_grad_(True)
    got = getattr(L, name)(*pargs, **kw)
    wants = want if isinstance(want, tuple) else (want,)
    gots = got if isinstance(got, tuple) else (got,)
    atol = 1e-5 if name in WARPS else 1e-6
    for a, b in zip(gots, wants):
        assert tuple(a.shape) == tuple(np.shape(b)), name
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=1e-5, atol=atol,
                                   err_msg=name)
    jg = np.asarray(jg)
    if not gots[0].requires_grad:
        assert not jg.any(), name
        return
    (pg,) = torch.autograd.grad(torch.sum(gots[0] * t(cot)), pargs[0])
    assert np.isfinite(jg).all() and np.abs(jg).max() > 0, name
    np.testing.assert_allclose(pg.numpy(), jg, rtol=1e-4, atol=1e-4 * np.abs(jg).max(),
                               err_msg=name)


def test_torch_median_is_jax_torch_median():
    rng = np.random.default_rng(2)
    for shape, axis in (((6, 8, 3), -2), ((5, 7), -1), ((4, 1), 0)):
        x = f32(rng.normal(size=shape))
        x[0, 0] = x[-1, -1]  # a tie
        for keep in (False, True):
            np.testing.assert_array_equal(
                torch.median(t(x), dim=axis, keepdim=keep).values.numpy(),
                np.asarray(J._torch_median(jnp.asarray(x), axis, keep)))


@pytest.fixture(scope="module")
def knn_points():
    rng = np.random.default_rng(3)
    xyz = f32(rng.uniform(-1, 1, size=(2, 300, 3)))
    xyz[0, 7] = xyz[0, 3]  # a duplicate point: distance exactly 0
    return xyz


@pytest.mark.parametrize("k,radius", [(8, 0.3), (20, 0.5), (4, 0.2)])
def test_ball_query_indices_equal(knn_points, k, radius, monkeypatch):
    want_d, want_i = J.ball_query(jnp.asarray(knn_points), jnp.asarray(knn_points), k=k,
                                  radius=radius)
    # row blocks of 37 rows: the blocked panel is the same function
    monkeypatch.setattr(L, "BALL_QUERY_PANEL", 37 * 300)
    got_d, got_i = L.ball_query(t(knn_points), t(knn_points), k=k, radius=radius)
    assert got_i.dtype == torch.int32
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), rtol=1e-5, atol=1e-6)
    assert (got_i.numpy() == -1).any() and (got_i.numpy() != -1).all(axis=-1).any()


def test_knn_constraint_loss_matches_jax(knn_points):
    canno = knn_points[0] + f32(np.random.default_rng(4).normal(size=(300, 3)) * 0.01)
    want, jg = jax.value_and_grad(lambda x: J.knn_constraint_loss(
        x, jnp.asarray(canno), radius=0.3, neighborhood_size=10))(jnp.asarray(knn_points))
    x = t(knn_points).requires_grad_(True)
    got = L.knn_constraint_loss(x, t(canno), radius=0.3, neighborhood_size=10)
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    (pg,) = torch.autograd.grad(got, x)
    jg = np.asarray(jg)
    assert torch.isfinite(pg).all()
    finite = np.isfinite(jg).all(axis=-1)
    assert finite.sum() > 20 and not finite.all()  # the self-pairs JAX cannot differentiate
    np.testing.assert_allclose(pg.numpy()[finite], jg[finite], rtol=1e-4,
                               atol=1e-4 * np.abs(jg[finite]).max())


@pytest.mark.parametrize("n", [64, 128])
def test_disparity_bucket_edges_both_sides(n):
    """Buckets bit-equal with JAX's; depths whose disparity lies exactly on
    an edge land as in JAX, in the upper bucket for ``side="right"``
    (direct warp) and the lower for ``side="left"`` (occlusion). JAX runs
    op by op here: inside a jitted warp XLA's fusion rounds some edges
    differently (2 of 128 moved by a unit in the last place), and a
    disparity on such an edge changes bucket."""
    edges = np.asarray(J._disp_buckets(n))
    np.testing.assert_array_equal(L._disp_buckets(n).numpy(), edges)
    depth = (np.float32(1.0) / edges).astype(np.float32)
    on_edge = (np.float32(1.0) / depth) == edges
    assert on_edge.sum() >= n // 2
    depth = depth[on_edge]
    d = np.resize(depth, H * W).reshape(H, W).astype(np.float32)
    w2c1, w2c2, K, K_inv = cams(np.random.default_rng(0))
    for right in (True, False):
        vol, grid = L._disparity_volume(t(d), n, right, t(w2c1), t(w2c2), t(K), t(K_inv),
                                        "zeros")
        idx = np.clip(np.asarray(jnp.searchsorted(jnp.asarray(edges), 1.0 / jnp.asarray(d),
                                                  side="right" if right else "left")), 0, n - 1)
        np.testing.assert_array_equal(vol.argmax(0).numpy(), idx)
    lo = L._disparity_volume(t(d), n, False, t(w2c1), t(w2c2), t(K), t(K_inv), "zeros")[0]
    hi = L._disparity_volume(t(d), n, True, t(w2c1), t(w2c2), t(K), t(K_inv), "zeros")[0]
    assert (lo.argmax(0) != hi.argmax(0)).any()  # the side decides
    img = f32(np.random.default_rng(5).uniform(size=(3, H, W)))
    jfw, jocc = J.direct_warp_rt1_rt2(jnp.asarray(img), jnp.asarray(d), w2c1, w2c2, K, K_inv,
                                      no_bucket=n)
    fw, occ = L.direct_warp_rt1_rt2(t(img), t(d), t(w2c1), t(w2c2), t(K), t(K_inv),
                                    no_bucket=n)
    np.testing.assert_allclose(fw.numpy(), np.asarray(jfw), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(occ.numpy(), np.asarray(jocc), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        L.occ_rt1_rt2(t(d), t(w2c1), t(w2c2), t(K), t(K_inv), no_bucket=n).numpy(),
        np.asarray(J.occ_rt1_rt2(jnp.asarray(d), w2c1, w2c2, K, K_inv, no_bucket=n)),
        rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("padding_mode", ["zeros", "border"])
def test_grid_sample_and_warp_grids_match_jax(padding_mode):
    """The warps' sampler on a grid with taps past every edge and exactly on
    the 2.0 that marks out-of-range coordinates, and the returned grids."""
    rng = np.random.default_rng(6)
    img = f32(rng.uniform(size=(3, H, W)))
    grid = f32(rng.uniform(-1.3, 1.3, size=(H, W, 2)))
    grid[0, :4] = [[2.0, 0.0], [0.0, 2.0], [1.0, 1.0], [-1.0, -1.0]]
    np.testing.assert_allclose(
        L._grid_sample_ac(t(img), t(grid), padding_mode).numpy(),
        np.asarray(jax.jit(J._grid_sample_ac, static_argnums=2)(
            jnp.asarray(img), jnp.asarray(grid), padding_mode)),
        rtol=1e-5, atol=1e-6)
    w2c1, w2c2, K, K_inv = cams(rng)
    depth = f32(rng.uniform(0.3, 8, size=(H, W)))
    out = L.direct_warp_rt1_rt2(t(img), t(depth), t(w2c1), t(w2c2), t(K), t(K_inv),
                                padding_mode=padding_mode, ret_grid=True, no_bucket=16)
    want = jax.jit(lambda i, dd: J.direct_warp_rt1_rt2(
        i, dd, w2c1, w2c2, K, K_inv, padding_mode=padding_mode, ret_grid=True,
        no_bucket=16))(jnp.asarray(img), jnp.asarray(depth))
    for a, b in zip(out, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-5)
    if padding_mode == "zeros":
        assert (out[2].numpy() == 2.0).any()
    pc2 = f32(np.concatenate([rng.uniform(-1, 1, (2, H, W)), rng.uniform(2, 4, (1, H, W))]))
    a, ga = L.warp_pc2flow(t(img), t(pc2), t(w2c2), t(K), padding_mode, ret_grid=True)
    b, gb = jax.jit(lambda i, p: J.warp_pc2flow(i, p, w2c2, K, padding_mode, ret_grid=True))(
        jnp.asarray(img), jnp.asarray(pc2))
    np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(ga.numpy(), np.asarray(gb), rtol=1e-5, atol=1e-6)


def test_margin_losses_return_masks():
    rng = np.random.default_rng(7)
    a, b = f32(rng.normal(size=(H, W))), f32(rng.normal(size=(H, W)))
    for name in ("margin_l2_loss", "margin_l1_loss"):
        v, m = getattr(L, name)(t(a), t(b), 0.4, return_mask=True)
        jv, jm = getattr(J, name)(jnp.asarray(a), jnp.asarray(b), 0.4, return_mask=True)
        np.testing.assert_array_equal(m.numpy(), np.asarray(jm))
        np.testing.assert_allclose(float(v), float(jv), rtol=1e-5)
