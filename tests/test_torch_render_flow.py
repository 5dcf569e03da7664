"""The train step's batched exposure-flow passes
(``models/render.py::render_flow_passes``) on the CPU's plain compositor:
a view's passes at its own camera in one call give each pass's image,
dynamic alpha, flow columns and projected centres of its own one-pass call
of the same pipeline to the bit, and every leaf's gradient within GRAD_REL
of its largest magnitude (the batched pass sums the passes' gradients in
another order); a flow-on step through it equals the step through one
call a pass (loss rtol 1e-6, gradients as above); the step counts one
batched call and its passes per batch view (``render.flow_calls``,
``render.flow_views``), none with flow off. Imports no JAX."""

import numpy as np
import pytest
import torch

from mobgs_tpu_torch.config import OptimizationParams
from mobgs_tpu_torch.data.cameras import Camera
from mobgs_tpu_torch.models import render as R
from mobgs_tpu_torch.train import step as S
from mobgs_tpu_torch.utils import observability as obs

from test_torch_render_latents import CFG, H, W, _leaves, _state

GRAD_REL = 1e-6
E = 9


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's side runs on one CPU thread: its many small ops gain
    little from more, and beside the suite's other workers a team of
    threads waits on its slowest member at every op."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_flow_passes = R.render_flow_passes


def _per_pass(stat, dyn, sandwich, cam, width, height, mid2d, max_time, shifts,
              config):
    """The passes as one one-pass ``render_flow_passes`` call each, their
    outputs concatenated along the view axis as the batched call gives
    them."""
    outs = [_flow_passes(stat, dyn, sandwich, cam, width, height, mid2d, max_time,
                         shifts[v:v + 1], config) for v in range(shifts.shape[0])]
    return outs[0]._replace(
        image=torch.cat([o.image for o in outs]), d_alpha=torch.cat([o.d_alpha for o in outs]),
        flow=torch.cat([o.flow for o in outs]), means2d=torch.cat([o.means2d for o in outs]),
        tile_max=torch.stack([o.tile_max for o in outs]).amax())


def _rel_errs(ga, gb):
    """Each leaf's largest gradient gap over its largest magnitude, for the
    leaves with a gradient."""
    errs = []
    for a, b in zip(ga, gb):
        if b is None or not b.any():
            assert a is None or not a.any()
            continue
        errs.append(float((a - b).abs().max()) / float(b.abs().max()))
    return errs


@pytest.mark.parametrize("view", [0, 1])
def test_render_flow_passes_equals_render_view_calls(view):
    """The E-1 = 8 passes of a batch view (time 0.2, and 0.8, where the
    largest shifts clamp the spline's time at 1): images, dynamic alphas,
    flow columns, projected centres and the peak occupancy to the bit, and
    the gradients of a weighted sum of the three maps within GRAD_REL."""
    ts, batch = _state(E)
    leaves = _leaves(ts)
    for p in leaves:
        p.requires_grad_(True)
    cam = Camera(w2c=batch.w2c[view], K=batch.K[view], time=batch.time[view])
    mid2d = R.project_combined(ts.stat, ts.dyn, cam, W, H, 1.0, None, CFG).detach()
    half = E // 2
    shifts = torch.tensor([(e - half) / half for e in range(E) if e != half])
    rng = np.random.default_rng(7)
    wts = [torch.as_tensor(rng.uniform(size=s).astype(np.float32))
           for s in ((E - 1, H, W, 3), (E - 1, H, W), (E - 1, H, W, 2))]

    bat = R.render_flow_passes(ts.stat, ts.dyn, ts.sandwich, cam, W, H, mid2d, 1.0,
                               shifts, CFG)
    one = _per_pass(ts.stat, ts.dyn, ts.sandwich, cam, W, H, mid2d, 1.0, shifts, CFG)
    assert bat.image.shape == (E - 1, H, W, 3) and bat.flow.shape == (E - 1, H, W, 2)
    assert float(bat.d_alpha.detach().std()) > 0.01
    assert float(bat.flow.detach().abs().max()) > 0.1
    for name in ("image", "d_alpha", "flow", "means2d"):
        assert torch.equal(getattr(bat, name), getattr(one, name)), name
    assert torch.equal((mid2d - bat.means2d).detach(), (mid2d - one.means2d).detach())
    assert int(bat.tile_max) == int(one.tile_max)

    def loss(o):
        return sum((x * w).sum() for x, w in zip((o.image, o.d_alpha, o.flow), wts))

    g_bat = torch.autograd.grad(loss(bat), leaves, allow_unused=True)
    g_one = torch.autograd.grad(loss(one), leaves, allow_unused=True)
    errs = _rel_errs(g_bat, g_one)
    assert len(errs) >= 12
    assert max(errs) <= GRAD_REL


def test_flow_step_equals_per_pass_route(monkeypatch):
    """A flow-on step at B=2, E=9 through the batched passes against the
    same step with one call a pass: the loss and flow term within rtol
    1e-6, each leaf's gradient within GRAD_REL of its largest magnitude,
    the peak occupancy equal; then ``make_train_step``'s loss, likewise."""
    opt = OptimizationParams(iterations=100, lambda_flow_loss=1e-2)
    res = {}
    for route in ("batched", "per_pass"):
        if route == "per_pass":
            monkeypatch.setattr(R, "render_flow_passes", _per_pass)
        ts, batch = _state(E)
        leaves = _leaves(ts)
        for p in leaves:
            p.requires_grad_(True)
        off = torch.zeros((2, ts.stat.capacity + ts.dyn.capacity, 2), requires_grad=True)
        total, aux = S.make_forward(opt, W, H, 1.0, E, CFG)(ts.stat, ts.dyn, ts.sandwich,
                                                            ts.blce, off, batch)
        grads = torch.autograd.grad(total, leaves + [off], allow_unused=True)
        ts, batch = _state(E)
        _, m = S.make_train_step(opt, W, H, 1.0, E, CFG)(ts, batch)
        res[route] = (float(total.detach()), float(aux["flow"].detach()), grads,
                      int(aux["tile_max"]), float(m.loss))
    a, b = res["batched"], res["per_pass"]
    assert a[1] > 0
    np.testing.assert_allclose(a[0], b[0], rtol=1e-6)
    np.testing.assert_allclose(a[1], b[1], rtol=1e-6)
    errs = _rel_errs(a[2], b[2])
    assert len(errs) >= 13
    assert max(errs) <= GRAD_REL
    assert a[3] == b[3]
    np.testing.assert_allclose(a[4], b[4], rtol=1e-6)


@pytest.mark.parametrize("case", ["flow", "flow_off"])
def test_step_counts_its_batched_flow_passes(case):
    """One step at B=2, E=9 with flow on: two batched calls of eight passes
    each; none with flow off."""
    ts, batch = _state(E)
    opt = OptimizationParams(iterations=100,
                             lambda_flow_loss=0.0 if case == "flow_off" else 1e-2)
    step = S.make_train_step(opt, W, H, 1.0, E, CFG)
    obs.tracing(spans=False, counters=True)
    obs.reset()
    try:
        ts, m = step(ts, batch)
        counters = obs.report()["counters"]
    finally:
        obs.tracing(False)
        obs.reset()
    assert bool(torch.isfinite(m.loss)) and ts.step == 1
    want = (2, 16) if case == "flow" else (0, 0)
    assert (counters.get("render.flow_calls", 0),
            counters.get("render.flow_views", 0)) == want
    assert (counters["render.latent_calls"], counters["render.latent_views"]) == (2, 16)
