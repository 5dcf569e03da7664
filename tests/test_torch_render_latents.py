"""The train step's batched latent renders (``models/render.py::render_latents``)
on the CPU's plain compositor: V cameras in one pass give each view's image
of its own one-view call of the same pipeline (``render_view``) to the bit,
and every leaf's gradient within GRAD_REL of its largest magnitude (the
batched pass sums the views' gradients in another order); the step counts one batched call and its views
per batch view (``render.latent_calls``, ``render.latent_views``), none
before ``start_warp``. Imports no JAX."""

import numpy as np
import pytest
import torch

from mobgs_tpu_torch.config import OptimizationParams
from mobgs_tpu_torch.core import se3
from mobgs_tpu_torch.data.cameras import Camera
from mobgs_tpu_torch.models import blce as B
from mobgs_tpu_torch.models import gaussians as G
from mobgs_tpu_torch.models import render as R
from mobgs_tpu_torch.models.sandwich import init_sandwich
from mobgs_tpu_torch.ops.rasterize import RasterConfig
from mobgs_tpu_torch.train import step as S
from mobgs_tpu_torch.utils import observability as obs

W, H = 48, 32
KMAT = np.array([[50.0, 0, W / 2], [0, 50.0, H / 2], [0, 0, 1]], np.float32)
CFG = RasterConfig(max_per_tile=256, backend="plain")
GRAD_REL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's side runs on one CPU thread: its many small ops gain
    little from more, and beside the suite's other workers a team of
    threads waits on its slowest member at every op."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _state(num_warp):
    rng = np.random.default_rng(0)
    pts = rng.normal(size=(260, 3)).astype(np.float32)
    pts[:, 2] = pts[:, 2] * 0.5 + 6.0
    cols = rng.uniform(size=(260, 3)).astype(np.float32)
    tt = np.linspace(0, 1, 6).astype(np.float32)
    traj = pts[:60, None] + rng.normal(size=(60, 1, 3)).astype(np.float32) \
        * 0.3 * tt[None, :, None]
    stat = G.create_state(pts[60:], cols[60:], np.zeros(200, np.float32), 256,
                          generator=torch.Generator().manual_seed(0), device="cpu")
    dyn = G.create_state(pts[:60], cols[:60], np.linspace(0, 1, 60, dtype=np.float32), 64,
                         trajectory=torch.as_tensor(traj),
                         traj_times=torch.as_tensor(tt), device="cpu")
    with torch.no_grad():  # features_t and omega away from zero, so time moves them
        dyn.features_t.copy_(torch.as_tensor(rng.normal(size=(64, 3)).astype(np.float32)))
        dyn.omega.copy_(torch.as_tensor(0.3 * rng.normal(size=(64, 4)).astype(np.float32)))
    sw = init_sandwich(torch.Generator().manual_seed(1), device="cpu")
    blce = B.init_blce(torch.Generator().manual_seed(2), num_views=6,
                       num_warp=num_warp, device="cpu")
    to = lambda x: torch.as_tensor(np.asarray(x, np.float32))  # noqa: E731
    batch = S.Batch(view_idx=torch.tensor([1, 4]), w2c=to(np.tile(np.eye(4), (2, 1, 1))),
                    K=to(np.stack([KMAT] * 2)), time=to([0.2, 0.8]),
                    image=to(rng.uniform(size=(2, H, W, 3))),
                    depth=to(rng.uniform(4, 8, size=(2, H, W))), blur_feat=to([0.3, 0.5]))
    return S.init_train_state(stat, dyn, sw, blce), batch


def _leaves(ts):
    return [*G.split_diff(ts.stat)[0], *G.split_diff(ts.dyn)[0],
            *S.sandwich_leaves(ts.sandwich), *ts.blce.params.leaves()]


@pytest.mark.parametrize("case", ["blce", "no_exposure_delta", "no_blce"])
def test_render_latents_equals_render_view_calls(case):
    """Images to the bit and gradients within GRAD_REL: BLCE's poses and
    exposure shifts; the same poses with no shift (``delta_exposure`` None,
    before ``start_warp_dynamic``); the view's own camera for every latent
    with zero shifts (``use_blce`` off)."""
    E = 5
    ts, batch = _state(E)
    leaves = _leaves(ts)
    for p in leaves:
        p.requires_grad_(True)
    w2c, K, time = batch.w2c[1], batch.K[1], batch.time[1]
    if case == "no_blce":
        lat_w2c = w2c.expand(E, 4, 4)
        expo = torch.zeros(E)
    else:
        lat_c2w, expo = B.latent_poses(ts.blce, se3.view_to_world(w2c), batch.blur_feat[1],
                                       batch.view_idx[1], E)
        lat_w2c = se3.view_to_world(lat_c2w)
    views = [0, 1, 3, 4]
    cams = torch.stack([lat_w2c[e] for e in views])
    shifts = None if case == "no_exposure_delta" else torch.stack([expo[e] for e in views])
    weight = torch.as_tensor(np.random.default_rng(5).uniform(
        size=(len(views), H, W, 3)).astype(np.float32))

    bat = R.render_latents(ts.stat, ts.dyn, ts.sandwich, cams, K, time, W, H, 1.0,
                           shifts, config=CFG)
    one = [R.render_view(ts.stat, ts.dyn, ts.sandwich, Camera(w2c=cams[v], K=K, time=time),
                         W, H, torch.zeros(3), 1.0, None if shifts is None else shifts[v],
                         want_depth=False, want_alpha=False, config=CFG)
           for v in range(len(views))]
    assert bat.image.shape == (len(views), H, W, 3)
    assert float(bat.image.detach().std()) > 0.01
    for v, o in enumerate(one):
        assert torch.equal(bat.image[v], o.image), v
    assert int(bat.tile_max) == max(int(o.tile_max) for o in one)

    g_bat = torch.autograd.grad((bat.image * weight).sum(), leaves, allow_unused=True,
                                retain_graph=True)
    g_one = torch.autograd.grad(sum((o.image * weight[v]).sum() for v, o in enumerate(one)),
                                leaves, allow_unused=True)
    n_checked = 0
    for a, b in zip(g_bat, g_one):
        if b is None or not b.any():
            assert a is None or not a.any()
            continue
        n_checked += 1
        err = float((a - b).abs().max()) / float(b.abs().max())
        assert err <= GRAD_REL
    assert n_checked >= 12


@pytest.mark.parametrize("with_latents", [True, False])
def test_step_counts_its_batched_latent_renders(with_latents):
    """One step at B=2, E=9: two batched calls of eight views each; none
    before ``start_warp``."""
    E = 9
    ts, batch = _state(E)
    step = S.make_train_step(OptimizationParams(iterations=100, lambda_flow_loss=0.0),
                             W, H, 1.0, E, CFG, with_latents=with_latents)
    obs.tracing(spans=False, counters=True)
    obs.reset()
    try:
        ts, m = step(ts, batch)
        counters = obs.report()["counters"]
    finally:
        obs.tracing(False)
        obs.reset()
    assert bool(torch.isfinite(m.loss)) and ts.step == 1
    want = (2, 16) if with_latents else (0, 0)
    assert (counters.get("render.latent_calls", 0),
            counters.get("render.latent_views", 0)) == want
