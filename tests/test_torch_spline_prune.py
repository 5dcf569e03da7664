"""The port's spline knot pruning, ``binary_dice_loss`` and ``FineSampler``
vs the JAX package's.

``core/spline.py``'s ``design_row_np`` (bit-equal), ``project_points``,
``compute_prune_error``, ``refit_spline_pruned`` and
``onedown_control_pts`` on splines made from a seed with numpy: the prune
decisions and knot counts equal, control points and errors at rtol 1e-4
(the batched 12x12 solves of two libraries). A spline that holds a NaN
control point among finite ones neither raises nor swaps, as in JAX.
``train/losses.py::binary_dice_loss`` at rtol 1e-6 (saturated logits of ±60
among them), and ``train/loop.py::FineSampler``'s
sample list equal to JAX's for three seeds.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mobgs_tpu.core import spline as jspline
from mobgs_tpu.train import loop as jloop
from mobgs_tpu.train import losses as jlosses

from mobgs_tpu_torch.core import spline
from mobgs_tpu_torch.train import loop, losses

P, K, V = 40, 12, 6
W, H, FOCAL = 64, 48, 50.0
THR = 0.05
TOL = dict(atol=1e-4, rtol=1e-4)


def t(x):
    return torch.as_tensor(np.array(x))


@pytest.fixture(scope="module")
def splines():
    """Half smooth (prunable), half wiggly (kept) splines with live counts
    5..K and zeroed dead columns, as training state holds them; six views
    in front of the points."""
    rng = np.random.default_rng(11)
    times_k = np.linspace(0, 1, K).astype(np.float32)
    smooth = (rng.normal(size=(P // 2, 1, 3))
              + rng.normal(size=(P // 2, 1, 3)) * times_k[None, :, None])
    wiggly = rng.normal(size=(P - P // 2, K, 3)) * 40.0
    control = np.concatenate([smooth, wiggly]).astype(np.float32)
    n_cur = rng.integers(5, K + 1, size=P).astype(np.int32)
    n_cur[:3] = 4  # the 4-knot floor re-solves at 4
    for i in range(P):
        control[i, n_cur[i]:] = 0.0
    w2c = np.tile(np.eye(4, dtype=np.float32)[None], (V, 1, 1))
    w2c[:, 2, 3] = 8.0
    w2c[:, 0, 3] = np.linspace(-0.2, 0.2, V)
    vtimes = np.linspace(0, 1, V).astype(np.float32)
    return control, n_cur, w2c, vtimes


@pytest.mark.parametrize("tq", [0.0, 0.3, 0.5, 0.77, 1.0])
def test_design_row_np_is_jax(tq):
    for n in (4, 7, K):
        np.testing.assert_array_equal(spline.design_row_np(tq, n, K),
                                      jspline.design_row_np(tq, n, K))


def test_project_points_matches_jax(splines):
    _, _, w2c, _ = splines
    pts = np.random.default_rng(1).normal(size=(50, 3)).astype(np.float32)
    Km = np.array([[FOCAL, 0, W / 2], [0, FOCAL, H / 2], [0, 0, 1]], np.float32)
    np.testing.assert_allclose(
        spline.project_points(t(pts), t(w2c[2]), t(Km)).numpy(),
        np.asarray(jspline.project_points(jnp.asarray(pts), jnp.asarray(w2c[2]),
                                          jnp.asarray(Km))), atol=1e-5, rtol=1e-5)


def test_refit_and_prune_error_match_jax(splines):
    control, n_cur, w2c, vtimes = splines
    new_p = spline.refit_spline_pruned(t(control), t(n_cur), K)
    new_j = jspline.refit_spline_pruned(jnp.asarray(control), jnp.asarray(n_cur), K)
    scale = np.abs(np.asarray(new_j)).max()
    np.testing.assert_allclose(new_p.numpy(), np.asarray(new_j), atol=1e-4 * scale,
                               rtol=1e-4)
    n_new = np.maximum(n_cur - 1, 4)
    # both sides on the same refit, so the errors differ by the projection only
    err_p = spline.compute_prune_error(t(control), t(n_cur), t(new_j), t(n_new),
                                       t(w2c), t(vtimes), FOCAL, W, H)
    err_j = jspline.compute_prune_error(jnp.asarray(control), jnp.asarray(n_cur), new_j,
                                        jnp.asarray(n_new), jnp.asarray(w2c),
                                        jnp.asarray(vtimes), FOCAL, W, H)
    assert err_p.shape == (P,)
    np.testing.assert_allclose(err_p.numpy(), np.asarray(err_j), **TOL)


def test_onedown_control_pts_matches_jax(splines):
    control, n_cur, w2c, vtimes = splines
    c_p, n_p, acc_p = spline.onedown_control_pts(t(control), t(n_cur), t(w2c), t(vtimes),
                                                 FOCAL, W, H, THR)
    c_j, n_j, acc_j = jspline.onedown_control_pts(
        jnp.asarray(control), jnp.asarray(n_cur), jnp.asarray(w2c), jnp.asarray(vtimes),
        FOCAL, W, H, THR)
    np.testing.assert_array_equal(n_p.numpy(), np.asarray(n_j))
    assert int(acc_p) == int(acc_j)
    accepted = n_p.numpy() < n_cur
    assert 0 < accepted.sum() < P, "both branches"
    scale = np.abs(np.asarray(c_j)).max()
    np.testing.assert_allclose(c_p.numpy(), np.asarray(c_j), atol=1e-4 * scale, rtol=1e-4)


def test_nan_control_point_keeps_its_knots(splines):
    """``jnp.linalg.solve`` never raises: a spline with a NaN control point
    refits to NaN, its error is NaN, and ``NaN <= thr`` rejects the swap."""
    control, n_cur, w2c, vtimes = splines
    control = control.copy()
    bad = 1  # a smooth spline, which would otherwise be pruned
    control[bad, 2, 1] = np.nan
    new_p = spline.refit_spline_pruned(t(control), t(n_cur), K)
    assert not torch.isfinite(new_p[bad]).all()
    c_p, n_p, acc_p = spline.onedown_control_pts(t(control), t(n_cur), t(w2c), t(vtimes),
                                                 FOCAL, W, H, THR)
    c_j, n_j, acc_j = jspline.onedown_control_pts(
        jnp.asarray(control), jnp.asarray(n_cur), jnp.asarray(w2c), jnp.asarray(vtimes),
        FOCAL, W, H, THR)
    assert int(n_p[bad]) == int(np.asarray(n_j)[bad]) == n_cur[bad]
    np.testing.assert_array_equal(c_p[bad].numpy(), control[bad])
    np.testing.assert_array_equal(n_p.numpy(), np.asarray(n_j))
    assert int(acc_p) == int(acc_j)
    keep = np.arange(P) != bad
    scale = np.abs(np.asarray(c_j)[keep]).max()
    np.testing.assert_allclose(c_p.numpy()[keep], np.asarray(c_j)[keep],
                               atol=1e-4 * scale, rtol=1e-4)


@pytest.mark.parametrize("kw", [dict(), dict(batch_dice=True), dict(log_loss=True),
                                dict(from_logits=False, smooth=1.0),
                                dict(batch_dice=True, log_loss=True, smooth=0.5)])
def test_binary_dice_loss_matches_jax(kw):
    rng = np.random.default_rng(5)
    logits = rng.normal(size=(3, 1, 16, 16)).astype(np.float32) * 4.0
    logits[0, 0, :2] = 60.0   # saturated logits
    logits[1, 0, :2] = -60.0
    if not kw.get("from_logits", True):
        logits = 1.0 / (1.0 + np.exp(-logits))
    truth = (rng.uniform(size=(3, 1, 16, 16)) > 0.5).astype(np.float32)
    pred = t(logits).requires_grad_(True)
    got = losses.binary_dice_loss(pred, t(truth), **kw)
    (g,) = torch.autograd.grad(got, pred)
    want, jg = jax.value_and_grad(
        lambda x: jlosses.binary_dice_loss(x, jnp.asarray(truth), **kw))(jnp.asarray(logits))
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), atol=1e-9, rtol=1e-5)


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_fine_sampler_is_jax(seed):
    got = loop.FineSampler(num_views=5, frame_length=4, seed=seed)
    want = jloop.FineSampler(num_views=5, frame_length=4, seed=seed)
    assert got.sample_list == want.sample_list
    assert list(got) == list(want) and len(got) == len(want)
    assert all(type(i) is int for i in got.sample_list)
