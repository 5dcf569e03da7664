"""The port's host training loop vs the JAX package's, and the modules it
adds: densify (slot allocation, clone/split, pool growth, prune, opacity
reset, the mode-1 helpers, ``control_gaussians`` in modes 1-3),
``grow_state``/``grow_adam``, ``revalidate_capacity``, the full-state
checkpoints across both packages, and resume.

Inputs are made from a seed with numpy and fed to both; the JAX state is
carried across with ``io/from_jax.py``. The JAX loop composites with its
Pallas kernels in interpret mode (``RasterConfig(backend="pallas")``), the
port's with the plain forward and backward on the CPU. The split noise of
both packages is the JAX package's: the port's ``densify.split_noise`` is
replaced by the JAX draws of the key its loop would split at that
iteration (``loop.py:433-435``, ``densify.py:145-147``).

Tolerances, and why:
- densify functions on given inputs: masks, slot maps, drop counts and
  live counts exactly; rows atol/rtol 1e-6 (the same float32 formulas;
  a split child's position is a 3x3 product in another order);
- the loop (flow off, 10 iterations): loss per iteration rtol 1e-5, as the
  step's (``tests/test_torch_train.py``); live counts, capacities and the
  max_per_tile history exactly; the final exposures rtol 1e-3 (medians of
  ratios of composited flow magnitudes) with atol EXPO_ATOL for the
  exposures near zero. Every densify decision is held
  away from its threshold: at each densify round every live slot's mean
  gradient norm is further from the threshold than MARGIN_FACTOR times its
  difference between the two packages (at least 130x in this world), and
  the pruned Gaussians sit at an opacity far below ``opthr``.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mobgs_tpu.config import BlceParams as JBlce
from mobgs_tpu.config import OptimizationParams as JOpt
from mobgs_tpu.data.synthetic import SceneData as JSceneData
from mobgs_tpu.io import checkpoint as jckpt
from mobgs_tpu.models import blce as jB
from mobgs_tpu.models import gaussians as jG
from mobgs_tpu.models import sandwich as jsand
from mobgs_tpu.ops.rasterize import RasterConfig as JRasterConfig
from mobgs_tpu.train import densify as jD
from mobgs_tpu.train import loop as jL
from mobgs_tpu.train import optim as joptim
from mobgs_tpu.train import step as jstep

from mobgs_tpu_torch.config import BlceParams, OptimizationParams
from mobgs_tpu_torch.data.synthetic import SceneData
from mobgs_tpu_torch.io import checkpoint, from_jax
from mobgs_tpu_torch.models import blce as B
from mobgs_tpu_torch.models import gaussians as G
from mobgs_tpu_torch.models.sandwich import init_sandwich
from mobgs_tpu_torch.ops.rasterize import RasterConfig
from mobgs_tpu_torch.train import densify as D
from mobgs_tpu_torch.train import loop as L
from mobgs_tpu_torch.train import optim
from mobgs_tpu_torch.train import step as pstep

W, H, V, E = 48, 32, 6, 2
KMAT = np.array([[50.0, 0, W / 2], [0, 50.0, H / 2], [0, 0, 1]], np.float32)
ROW_TOL = dict(atol=1e-6, rtol=1e-6)
MARGIN_FACTOR = 10.0
# the new exposures are ratios of flow magnitudes whose numerator, the flow
# between the first and the last latent pose, is a difference of nearly
# equal poses at BLCE's tiny initial decoders: ~3e-4 here, with float32
# cancellation of a few 1e-7 in either package
EXPO_ATOL = 1e-6
N_LOOP = 10
# the loop's schedule: boundaries at 4, 6, 8, 10; the static pool densifies
# at 4 and 6 and prunes at 8 and 10; opacity reset at 6. Iteration 10 holds
# the exposure update, the one budget check (a de-escalation) and the one
# growth (the dynamic pool, sized to overflow first there), so the JAX step
# compiles once. Dead slots are binned too here, so the budgets stay above
# the 640 slots: no capacity revalidation
LOOP_OPT = dict(iterations=100, batch_size=2, lambda_flow_loss=0.0,
                densify_from_iter=2, densification_interval=2,
                densify_until_iter=50, desicnt=2, opacity_reset_interval=6,
                densify_grad_threshold=2e-4, percent_dense=0.01)
DYN_CAP = 300
LOOP_KW = dict(iterations=N_LOOP, scene_extent=6.0, seed=3, log_every=1,
               deescalate_every=N_LOOP)
START = dict(tiles_per_gauss=64, max_per_tile=1536)
BASE = dict(tiles_per_gauss=64, max_per_tile=1024)


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


def jcfg(**kw):
    return JRasterConfig(tile_chunk=6, backend="pallas", **kw)


# ---------------------------------------------------------------------------
# a state with random rows, for the function-level tests


def _random_state(rng, M, n_live):
    f = {
        "xyz": rng.normal(size=(M, 3)),
        "control_xyz": rng.normal(size=(M, G.CONTROL_NUM, 3)),
        "control_num": rng.integers(4, G.CONTROL_NUM + 1, size=M),
        "features_dc": rng.normal(size=(M, 6)),
        "features_rest": rng.normal(size=(M, 16, 3)),
        "features_t": rng.normal(size=(M, 3)),
        "scaling": rng.uniform(-3.0, 0.0, size=(M, 3)),
        "rotation": rng.normal(size=(M, 4)),
        "opacity": rng.normal(0.0, 2.0, size=(M, 1)),
        "omega": rng.normal(size=(M, 4)),
        "motion": rng.normal(0.0, 0.3, size=(M, 9)),
        "zeta": rng.normal(size=(M, 1)),
        "trbf_center": rng.uniform(size=(M, 1)),
        "trbf_scale": rng.normal(size=(M, 1)),
    }
    f = {k: v.astype(np.int32 if k == "control_num" else np.float32)
         for k, v in f.items()}
    live = np.zeros(M, bool)
    live[rng.choice(M, n_live, replace=False)] = True
    f["live"] = live
    return f


def _states(fields):
    jst = jG.GaussianState(**{k: jnp.asarray(v) for k, v in fields.items()})
    return jst, from_jax.gaussian_state_from_numpy(fields, device="cpu")


def _moments(rng, M):
    shapes = {f: s.shape for f, s in zip(
        G.DIFF_FIELDS, G.split_diff(_states(_random_state(rng, M, 1))[1])[0])}
    mu = {f: rng.normal(size=s).astype(np.float32) for f, s in shapes.items()}
    nu = {f: rng.uniform(size=s).astype(np.float32) for f, s in shapes.items()}
    fields = {"mu": mu, "nu": nu, "step": np.int32(7)}
    jopt = joptim.AdamState(mu=jG.DiffFields(**{k: jnp.asarray(v) for k, v in mu.items()}),
                            nu=jG.DiffFields(**{k: jnp.asarray(v) for k, v in nu.items()}),
                            step=jnp.int32(7))
    return jopt, from_jax.adam_from_numpy(fields, G.DIFF_FIELDS, "cpu")


def _assert_state_equal(pst, jst, what, tol=None):
    for f in G.GaussianState._fields:
        a, b = getattr(pst, f).detach().numpy(), np.asarray(getattr(jst, f))
        assert a.shape == b.shape, f"{what}.{f}"
        if tol is None or a.dtype in (np.bool_, np.int32):
            np.testing.assert_array_equal(a, b, err_msg=f"{what}.{f}")
        else:
            np.testing.assert_allclose(a, b, **tol, err_msg=f"{what}.{f}")


def _assert_moments_equal(popt, jopt, what):
    assert popt.step == int(jopt.step), what
    for part in ("mu", "nu"):
        for f, a in zip(G.DIFF_FIELDS, getattr(popt, part)):
            np.testing.assert_array_equal(
                a.numpy(), np.asarray(getattr(getattr(jopt, part), f)),
                err_msg=f"{what}.{part}.{f}")


def _jax_noise_for(keys):
    """The port's split_noise, drawing what the JAX package draws: ``keys``
    maps the port's (seed, iteration, pool) key to the JAX key that
    densify_clone_split receives there."""
    def noise(key, child, shape):
        k = keys[tuple(key)]
        for _ in range(child + 1):
            k, sub = jax.random.split(k)
        return t(jax.random.normal(sub, tuple(shape)))
    return noise


# ---------------------------------------------------------------------------
# function level


@pytest.mark.parametrize("n_live,n_want", [(60, 30), (90, 30), (100, 0)])
def test_alloc_and_scatter_rows(n_live, n_want):
    """Slot allocation on a roomy and a nearly full pool (10 free slots for
    30 candidates: 20 dropped and never written), and the masked scatter."""
    rng = np.random.default_rng(10)
    M = 100
    fields = _random_state(rng, M, n_live)
    want = np.zeros(M, bool)
    live_idx = np.nonzero(fields["live"])[0]
    want[rng.choice(live_idx, n_want, replace=False)] = True
    jdest, jok = jD._alloc_slots(jnp.asarray(fields["live"]), jnp.asarray(want))
    pdest, pok = D._alloc_slots(t(fields["live"]), t(want))
    np.testing.assert_array_equal(pok.numpy(), np.asarray(jok))
    np.testing.assert_array_equal(pdest.numpy(), np.asarray(jdest))
    n_free = M - n_live
    assert int(pok.sum()) == min(n_want, n_free)
    jst, pst = _states(fields)
    idx = np.arange(M)
    jnew = jD._scatter_rows(jst, jnp.asarray(idx), jdest, jok)
    pnew = D._scatter_rows(pst, t(idx), pdest, pok)
    assert pnew is pst  # written in place
    _assert_state_equal(pnew, jnew, "scatter")
    assert int(pnew.num_live()) == n_live + min(n_want, n_free)
    jopt, popt = _moments(rng, M)
    _assert_moments_equal(D._zero_moments_at(popt, pdest, pok),
                          jD._zero_moments_at(jopt, jdest, jok), "moments")


def _grad_stats(rng, fields, threshold, margin=1e-2):
    """Stats whose mean gradient norms stay ``margin`` (relative) away from
    ``threshold`` on every slot."""
    M = fields["xyz"].shape[0]
    g = threshold * np.exp(rng.uniform(-1.5, 1.5, size=M))
    g = np.where(np.abs(g / threshold - 1.0) < 2 * margin, threshold * 1.5, g)
    denom = rng.integers(1, 4, size=M).astype(np.float32)
    denom[rng.choice(M, 5, replace=False)] = 0.0  # never seen: nan → 0
    accum = (g * denom).astype(np.float32)
    return accum, denom, rng.uniform(0, 9, size=M).astype(np.float32)


@pytest.mark.parametrize("n_live", [30, 95])
def test_densify_clone_split_matches(n_live, monkeypatch):
    """Clone and split with the same noise: exact masks, slots and drop
    counts (the 95-live pool drops candidates and keeps the parents whose
    children found no slot), rows within ROW_TOL, zeroed moments."""
    rng = np.random.default_rng(11)
    M, thr = 100, 1e-3
    fields = _random_state(rng, M, n_live)
    accum, denom, radii = _grad_stats(rng, fields, thr)
    jst, pst = _states(fields)
    jopt, popt = _moments(rng, M)
    jkey = jax.random.PRNGKey(5)
    monkeypatch.setattr(D, "split_noise", _jax_noise_for({(0, 4, 1): jkey}))
    js, jo, jstats, jdrop = jD.densify_clone_split(
        jst, jD.DensifyStats(jnp.asarray(accum), jnp.asarray(denom),
                             jnp.asarray(radii)),
        jopt, jkey, thr, percent_dense=0.1, scene_extent=1.0)
    ps, po, pstats, pdrop = D.densify_clone_split(
        pst, D.DensifyStats(t(accum), t(denom), t(radii)), popt, (0, 4, 1),
        thr, percent_dense=0.1, scene_extent=1.0)
    assert int(pdrop) == int(jdrop)
    assert (int(pdrop) > 0) == (n_live == 95)
    _assert_state_equal(ps, js, "densified", ROW_TOL)
    _assert_moments_equal(po, jo, "moments")
    assert not any(x.any() for x in pstats)
    assert int(ps.num_live()) != n_live


@pytest.mark.parametrize("what", ["grow_state", "grow_adam", "grow_stats",
                                  "grow_pool", "grow_train_state"])
def test_growth_matches(what, world):
    rng = np.random.default_rng(12)
    M = 100
    fields = _random_state(rng, M, 70)
    jst, pst = _states(fields)
    jopt, popt = _moments(rng, M)
    stats = [rng.uniform(size=M).astype(np.float32) for _ in range(3)]
    jstats, pstats = jD.DensifyStats(*map(jnp.asarray, stats)), D.DensifyStats(*map(t, stats))
    if what == "grow_state":
        _assert_state_equal(G.grow_state(pst, 160), jG.grow_state(jst, 160), what)
        assert G.grow_state(pst, 160) is not pst and pst.capacity == M
    elif what == "grow_adam":
        _assert_moments_equal(optim.grow_adam(popt, M, 160),
                              joptim.grow_adam(jopt, M, 160), what)
    elif what == "grow_stats":
        for a, b in zip(D.grow_stats(pstats, 160), jD.grow_stats(jstats, 160)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    elif what == "grow_pool":
        for dropped, cap in ((0, 400_000), (500, 400_000), (500, 1500), (5, 100)):
            ps, po, pss, pcap = D.grow_pool(pst, popt, pstats, dropped, cap)
            js, jo, jss, jcap = jD.grow_pool(jst, jopt, jstats, dropped, cap)
            assert pcap == jcap, (dropped, cap)
            assert (ps is pst) == (pcap == M)
            _assert_state_equal(ps, js, what)
            _assert_moments_equal(po, jo, what)
            for a, b in zip(pss, jss):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    else:
        jts, pts = world["jts"](), world["pts"]()
        jg = jD.grow_train_state(jts, jts.stat.capacity + 64, jts.dyn.capacity + 32)
        pg = D.grow_train_state(pts, pts.stat.capacity + 64, pts.dyn.capacity + 32)
        flat = checkpoint.flatten_train_state(pg)
        jflat = {k: np.asarray(v) for k, v in jckpt._flatten_with_paths(jg)[0].items()}
        assert flat.keys() == jflat.keys()
        for k in flat:
            np.testing.assert_array_equal(flat[k], jflat[k], err_msg=k)


@pytest.mark.parametrize("what", ["prune_by_opacity", "reset_opacity",
                                  "zero_omega_by_motion", "apply_omega_freeze",
                                  "remove_min_max", "prune_z_below"])
def test_prune_reset_and_mode1_helpers(what):
    rng = np.random.default_rng(13)
    M = 120
    fields = _random_state(rng, M, 90)
    # some Gaussians that pass the ω-freeze mask: moving, mid-sized, opaque
    sel = np.nonzero(fields["live"])[0][:20]
    fields["motion"][sel, :3] = 0.5
    fields["scaling"][sel] = np.log(0.4)
    fields["opacity"][sel] = 2.0
    fields["xyz"][:, 2] = rng.uniform(3.0, 6.0, size=M)
    jst, pst = _states(fields)
    jopt, popt = _moments(rng, M)
    if what == "prune_by_opacity":
        _assert_state_equal(D.prune_by_opacity(pst, 0.3), jD.prune_by_opacity(jst, 0.3), what)
    elif what == "reset_opacity":
        ps, po = D.reset_opacity(pst, popt)
        js, jo = jD.reset_opacity(jst, jopt)
        _assert_state_equal(ps, js, what, ROW_TOL)
        _assert_moments_equal(po, jo, what)
    elif what == "zero_omega_by_motion":
        ps, po, pm = D.zero_omega_by_motion(pst, popt)
        js, jo, jm = jD.zero_omega_by_motion(jst, jopt)
        np.testing.assert_array_equal(pm.numpy(), np.asarray(jm))
        assert 0 < int(pm.sum()) < M
        _assert_state_equal(ps, js, what)
        _assert_moments_equal(po, jo, what)
    elif what == "apply_omega_freeze":
        grads = [rng.normal(size=p.shape).astype(np.float32)
                 for p in G.split_diff(pst)[0]]
        mask = rng.uniform(size=M) > 0.5
        pg = D.apply_omega_freeze(G.DiffFields(*map(t, grads)), t(mask))
        jg = jD.apply_omega_freeze(jG.DiffFields(*map(jnp.asarray, grads)),
                                   jnp.asarray(mask))
        for f in G.DIFF_FIELDS:
            np.testing.assert_array_equal(getattr(pg, f).numpy(),
                                          np.asarray(getattr(jg, f)), err_msg=f)
    elif what == "remove_min_max":
        mx, mn = np.array([1.0, 1.0, 5.5]), np.array([-1.0, -1.2, 3.2])
        _assert_state_equal(D.remove_min_max(pst, mx, mn),
                            jD.remove_min_max(jst, mx, mn), what)
    else:
        _assert_state_equal(D.prune_z_below(pst), jD.prune_z_below(jst), what)


@pytest.mark.parametrize("mode", [1, 2, 3])
def test_control_gaussians_modes(mode, monkeypatch):
    """The controller over iterations that reach every branch of its mode:
    densify rounds until desicnt, prunes after, opacity resets, and for
    mode 1 the iteration-8001 freeze mask, the post-window z prune and the
    end-of-train box prune."""
    rng = np.random.default_rng(14 + mode)
    M, thr = 200, 1e-3
    fields = _random_state(rng, M, 80)
    fields["xyz"][:, 2] = rng.uniform(3.0, 6.0, size=M)
    sel = np.nonzero(fields["live"])[0][:20]
    fields["motion"][sel, :3] = 0.5
    fields["scaling"][sel] = np.log(0.4)
    fields["opacity"][sel] = 2.0
    jst, pst = _states(fields)
    jopt, popt = _moments(rng, M)
    kw = dict(densify_from_iter=0, densification_interval=1000,
              densify_until_iter=9000 if mode == 1 else 7000, desicnt=2,
              opacity_reset_interval=3000, opthr=0.3,
              densify_grad_threshold=thr)
    jcfg_, pcfg = JOpt(**kw), OptimizationParams(**kw)
    # mode 2 on the static pool (its flag counts rounds), modes 1 and 3 on
    # the dynamic one: every threshold is then densify_grad_threshold
    dynamic = mode != 2
    its = ([1000, 2000, 3000, 4000, 8001, 9500, 10_000] if mode == 1
           else [1000, 2000, 3000, 4000, 6000, 8000])
    keys = {(0, it, 0): jax.random.PRNGKey(it) for it in its}
    monkeypatch.setattr(D, "split_noise", _jax_noise_for(keys))
    jflag = pflag = 0
    jmask = pmask = None
    bounds = (np.array([1.5, 1.5, 5.8]), np.array([-1.5, -1.5, 3.1]))
    for it in its:
        accum, denom, radii = _grad_stats(rng, fields, thr)
        js = jD.DensifyStats(jnp.asarray(accum), jnp.asarray(denom), jnp.asarray(radii))
        ps = D.DensifyStats(t(accum), t(denom), t(radii))
        jst, jopt, _, jflag, jmask, jdrop = jD.control_gaussians(
            jst, js, jopt, keys[(0, it, 0)], it, jflag, jcfg_, 10.0, dynamic, mode,
            jmask, *bounds, total_iterations=10_000)
        pst, popt, _, pflag, pmask, pdrop = D.control_gaussians(
            pst, ps, popt, (0, it, 0), it, pflag, pcfg, 10.0, dynamic, mode,
            pmask, *bounds, total_iterations=10_000)
        assert (pflag, pdrop) == (jflag, jdrop), it
        assert (pmask is None) == (jmask is None), it
        if pmask is not None:
            np.testing.assert_array_equal(pmask.numpy(), np.asarray(jmask))
        _assert_state_equal(pst, jst, f"mode {mode} iteration {it}", ROW_TOL)
        _assert_moments_equal(popt, jopt, f"mode {mode} iteration {it}")
    assert pflag == 2


# ---------------------------------------------------------------------------
# the loop


@pytest.fixture(scope="module")
def world():
    return make_world()


def make_world():
    """A 48x32 scene of 6 views: 200 static seeds in 400 slots (20 of them
    nearly transparent, for the prune) and 60 dynamic in DYN_CAP, made with
    the port's constructors on the CPU and carried to the JAX package as
    arrays (its own constructors compile for seconds)."""
    rng = np.random.default_rng(0)
    n_stat, n_dyn = 200, 60
    pts = rng.normal(size=(n_stat + n_dyn, 3)).astype(np.float32)
    pts[:, :2] *= 0.9
    pts[:, 2] = pts[:, 2] * 0.5 + 6.0
    cols = rng.uniform(size=(n_stat + n_dyn, 3)).astype(np.float32)
    times = np.linspace(0, 1, V).astype(np.float32)
    vel = rng.normal(size=(n_dyn, 3)).astype(np.float32) * 0.3
    traj = pts[n_stat:, None] + vel[:, None] * times[None, :, None]
    gen = torch.Generator().manual_seed(0)
    stat = G.create_state(pts[:n_stat], cols[:n_stat], np.zeros(n_stat, np.float32),
                          400, generator=gen, device="cpu")
    with torch.no_grad():
        stat.opacity[:20] = float(np.log(0.002 / 0.998))
    dyn = G.create_state(pts[n_stat:], np.full((n_dyn, 3), 0.5, np.float32),
                         np.zeros(n_dyn, np.float32), DYN_CAP, trajectory=t(traj),
                         traj_times=t(times), device="cpu")
    ts = pstep.init_train_state(stat, dyn, init_sandwich(gen, device="cpu"),
                                B.init_blce(gen, num_views=V, num_warp=E, device="cpu"))
    flat = checkpoint.flatten_train_state(ts)
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
    return dict(jts=lambda: _jax_train_state(flat),
                pts=lambda: checkpoint.unflatten_train_state(flat, device="cpu"),
                jdata=JSceneData(**arrays), pdata=SceneData(**arrays))


def _jax_train_state(flat):
    """The JAX package's TrainState of a ``checkpoint.flatten_train_state``
    dict (the paths are its pytree paths)."""
    def tup(cls, prefix):
        return cls(**{f: jnp.asarray(flat[f"{prefix}/{f}"]) for f in cls._fields})

    def adam(name, cls):
        return joptim.AdamState(mu=tup(cls, f"{name}/mu"), nu=tup(cls, f"{name}/nu"),
                                step=jnp.asarray(flat[f"{name}/step"]))

    return jstep.TrainState(
        stat=tup(jG.GaussianState, "stat"), dyn=tup(jG.GaussianState, "dyn"),
        sandwich=tup(jsand.SandwichParams, "sandwich"),
        blce=jB.BLCEState(params=tup(jB.BLCEParams, "blce/params"),
                          exposure_expo=jnp.asarray(flat["blce/exposure_expo"])),
        stat_opt=adam("stat_opt", jG.DiffFields), dyn_opt=adam("dyn_opt", jG.DiffFields),
        sandwich_opt=adam("sandwich_opt", jsand.SandwichParams),
        blce_opt=adam("blce_opt", jB.BLCEParams),
        stat_stats=tup(jD.DensifyStats, "stat_stats"),
        dyn_stats=tup(jD.DensifyStats, "dyn_stats"), step=jnp.asarray(flat["step"]))


def _recording_controller(real, out):
    """``control_gaussians`` that first records, at each densify round, the
    pool's mean gradient norms, its live mask and its threshold."""
    def controller(state, stats, opt_state, key, iteration, flag, opt_cfg,
                   scene_extent, is_dynamic, **kw):
        if (opt_cfg.densify_from_iter < iteration < opt_cfg.densify_until_iter
                and iteration % opt_cfg.densification_interval == 0
                and (is_dynamic or flag < opt_cfg.desicnt)):
            accum, denom = (x.numpy() if isinstance(x, torch.Tensor)
                            else np.asarray(x) for x in stats[:2])
            g = np.nan_to_num(accum / np.maximum(denom, 1e-12))
            thr = opt_cfg.densify_grad_threshold * (0.5 if is_dynamic else 1.0)
            out[(iteration, is_dynamic)] = (g, np.asarray(state.live), thr)
        return real(state, stats, opt_state, key, iteration, flag, opt_cfg,
                    scene_extent, is_dynamic, **kw)
    return controller


def _jax_split_keys(seed, opt, iterations):
    """The keys the JAX loop hands densify at each boundary, under the
    port's (seed, iteration, pool) key (mode 2: ``loop.py:421-435``)."""
    rng, keys = jax.random.PRNGKey(seed), {}
    for it in range(1, iterations + 1):
        if (opt.densify_from_iter < it < opt.densify_until_iter
                and it % opt.densification_interval == 0):
            rng, k1, k2 = jax.random.split(rng, 3)
            keys[(seed, it, L.DYN_POOL)], keys[(seed, it, L.STAT_POOL)] = k1, k2
    return keys


@pytest.fixture(scope="module")
def loop_runs(world):
    return run_both_loops(world)


def run_both_loops(world):
    """Both loops on the same world, 10 iterations, flow off, starting at
    budgets above the base config; each package's densify rounds record
    their mean gradient norms."""
    jopt, popt = JOpt(**LOOP_OPT), OptimizationParams(**LOOP_OPT)
    blce_kw = dict(num_warp=E, start_warp_exposure=5)
    grads = {"jax": {}, "port": {}}
    mp = pytest.MonkeyPatch()
    for side, mod in (("jax", jD), ("port", D)):
        mp.setattr(mod, "control_gaussians",
                   _recording_controller(mod.control_gaussians, grads[side]))
    mp.setattr(D, "split_noise", _jax_noise_for(
        _jax_split_keys(LOOP_KW["seed"], jopt, N_LOOP)))
    try:
        jts, jhist = jL.train(world["jts"](), world["jdata"], jopt, JBlce(**blce_kw),
                              raster_cfg=jcfg(**START), base_raster_cfg=jcfg(**BASE),
                              **LOOP_KW)
        pts, phist = L.train(world["pts"](), world["pdata"], popt,
                             BlceParams(**blce_kw),
                             raster_cfg=RasterConfig(**START),
                             base_raster_cfg=RasterConfig(**BASE),
                             device="cpu", **LOOP_KW)
    finally:
        mp.undo()
    return dict(jts=jts, jhist=jhist, pts=pts, phist=phist, grads=grads)


def test_loop_history_matches(loop_runs):
    jh, ph = loop_runs["jhist"], loop_runs["phist"]
    assert len(ph) == len(jh) == N_LOOP
    # the JAX package's keys, and the budget the JAX entries lack
    assert set(ph[0]) == set(jh[0]) | {"tiles_per_gauss"}
    for a, b in zip(ph, jh):
        assert a["iter"] == b["iter"]
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=1e-5,
                                   err_msg=f"iter {a['iter']}")
        for k in ("n_stat", "n_dyn", "max_per_tile", "densify_dropped_stat",
                  "densify_dropped_dyn", "tile_max"):
            assert a[k] == b[k], (a["iter"], k, a[k], b[k])
    # every densify decision sits well away from its threshold: each live
    # slot's mean gradient norm is further from it than MARGIN_FACTOR times
    # that slot's difference between the packages
    jg, pg = loop_runs["grads"]["jax"], loop_runs["grads"]["port"]
    assert jg.keys() == pg.keys() and len(jg) >= 4
    for key in jg:
        (a, live, thr), (b, _, _) = jg[key], pg[key]
        m = live & (a > 0)
        ratio = np.abs(a - thr)[m] / np.maximum(np.abs(a - b)[m], 1e-30)
        assert ratio.min() > MARGIN_FACTOR, (key, float(ratio.min()))


def test_loop_events_and_final_state(loop_runs):
    """Clone/split, prune, reset, exposure update, one growth and a
    de-escalation all happened, in both packages alike."""
    jts, pts, ph = loop_runs["jts"], loop_runs["pts"], loop_runs["phist"]
    assert (pts.stat.capacity, pts.dyn.capacity) == (jts.stat.capacity, jts.dyn.capacity)
    # one growth: the dynamic pool, at iteration 10
    assert (pts.stat.capacity, pts.dyn.capacity) == (400, 1024)
    dropped = [h["densify_dropped_dyn"] + h["densify_dropped_stat"] for h in ph]
    assert dropped[-2] == 0 < dropped[-1], dropped
    n_stat = [h["n_stat"] for h in ph]
    assert n_stat[2] < n_stat[3] < n_stat[5]  # densified at 4 and 6
    assert n_stat[7] < n_stat[6]  # the near-transparent seeds pruned at 8
    mpt = [h["max_per_tile"] for h in ph]
    assert mpt[0] == START["max_per_tile"] and mpt[-1] == BASE["max_per_tile"], mpt
    # the tile span the radii suggest stays under the start's 64
    assert all(h["tiles_per_gauss"] == START["tiles_per_gauss"] for h in ph)
    assert pts.step == int(jts.step) == N_LOOP
    np.testing.assert_array_equal(pts.stat.live.numpy(), np.asarray(jts.stat.live))
    np.testing.assert_array_equal(pts.dyn.live.numpy(), np.asarray(jts.dyn.live))
    # the reset at 6 clamped every opacity to <= 0.01; 4 Adam steps since
    assert float(torch.sigmoid(pts.stat.opacity.detach()).max()) < 0.02
    pe, je = pts.blce.exposure_expo.numpy(), np.asarray(jts.blce.exposure_expo)
    assert not np.allclose(pe, 0.4)  # an exposure update wrote
    np.testing.assert_allclose(pe, je, rtol=1e-3, atol=EXPO_ATOL)


def _pile_up(jts, n=200, seed=3):
    """A pile-up of ``n`` low-opacity splats in one tile of the static pool
    (``tests/test_train_step.py:388-419``): a 64-entry truncation of it is
    visibly lossy."""
    rng = np.random.default_rng(seed)
    st = jts.stat
    pile = (np.array([0.0, 0.0, 5.0], np.float32)
            + 1e-3 * rng.normal(size=(n, 3)).astype(np.float32))
    st = st._replace(xyz=st.xyz.at[:n].set(pile),
                     scaling=st.scaling.at[:n].set(float(np.log(0.05))),
                     opacity=st.opacity.at[:n].set(float(np.log(0.01 / 0.99))),
                     live=st.live.at[:n].set(True))
    return jts._replace(stat=st)


@pytest.mark.parametrize("case", ["pile_up_k64", "seed_scene_k256"])
def test_revalidate_capacity_matches(case, world):
    """The measured capacity validation on the current state: the pile-up
    escalates from 64; on the seed scene 256 is validated lossless."""
    jts, k = world["jts"](), 256
    if case == "pile_up_k64":
        jts, k = _pile_up(jts), 64
    pts = from_jax.train_state_from_numpy(to_numpy(jts), device="cpu")
    want = jL.revalidate_capacity(jts, world["jdata"], jcfg(max_per_tile=k), 1.0)
    got = L.revalidate_capacity(pts, world["pdata"], RasterConfig(max_per_tile=k), 1.0)
    assert got == want
    assert (got > k) == (case == "pile_up_k64")


# ---------------------------------------------------------------------------
# checkpoints and resume


def test_checkpoint_port_to_jax_and_back(loop_runs, world, tmp_path):
    """The port's trained (grown) state through a port checkpoint into the
    JAX loader, and the JAX state through a JAX checkpoint into the port's:
    equal leaves, keys and dtypes."""
    pts, jts = loop_runs["pts"], loop_runs["jts"]
    p_path, j_path = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    checkpoint.save_train_state(p_path, pts)
    jckpt.save_train_state(j_path, jts)
    tmpl = world["jts"]()
    tmpl = jD.grow_train_state(tmpl, jckpt.peek_shape(p_path, "stat/xyz")[0],
                               jckpt.peek_shape(p_path, "dyn/xyz")[0])
    j_loaded = jckpt.load_train_state(p_path, tmpl)
    want = checkpoint.flatten_train_state(pts)
    got = {k: np.asarray(v) for k, v in jckpt._flatten_with_paths(j_loaded)[0].items()}
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)

    ptmpl = world["pts"]()
    ptmpl = D.grow_train_state(ptmpl, checkpoint.peek_shape(j_path, "stat/xyz")[0],
                               checkpoint.peek_shape(j_path, "dyn/xyz")[0])
    p_loaded = checkpoint.load_train_state(j_path, ptmpl)
    assert p_loaded.step == int(jts.step)
    jflat = {k: np.asarray(v) for k, v in jckpt._flatten_with_paths(jts)[0].items()}
    for k, v in checkpoint.flatten_train_state(p_loaded).items():
        np.testing.assert_array_equal(v, jflat[k], err_msg=k)
    assert checkpoint.peek_shape(j_path, "nope/nothing") is None


def test_checkpoint_skips_jax_deform_leaves(world, tmp_path):
    """A JAX state carrying its deformation net: the port loads the rest
    and skips ``deform/*``; the JAX loader, given the port's file, keeps its
    template's net."""
    from mobgs_tpu.config import ModelHiddenParams
    from mobgs_tpu.models.deformation import init_deformation
    small = ModelHiddenParams(net_width=8, kplanes_config={
        "grid_dimensions": 2, "input_coordinate_dim": 4,
        "output_coordinate_dim": 4, "resolution": [4, 4, 4, 2]}, multires=[1])
    # the net's structure and shapes, filled with a ramp (tracing only)
    deform = jax.tree.map(
        lambda x: jnp.arange(np.prod(x.shape), dtype=x.dtype).reshape(x.shape),
        jax.eval_shape(lambda k: init_deformation(k, small), jax.random.PRNGKey(4)))
    jts = world["jts"]()._replace(deform=deform)
    path = str(tmp_path / "with_deform.npz")
    jckpt.save_train_state(path, jts)
    assert any(k.startswith("deform/") for k in np.load(path).files)
    pts = checkpoint.load_train_state(path, world["pts"]())
    np.testing.assert_array_equal(pts.stat.xyz.detach().numpy(), np.asarray(jts.stat.xyz))
    p_path = str(tmp_path / "port.npz")
    checkpoint.save_train_state(p_path, pts)
    back = jckpt.load_train_state(p_path, jts)
    for a, b in zip(jax.tree.leaves(back.deform), jax.tree.leaves(deform)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_resume_matches_uninterrupted_run(world, tmp_path):
    """A port run checkpointed at iteration 3 and resumed gives the
    uninterrupted run's history (densify and its split noise inside)."""
    opt = OptimizationParams(**{**LOOP_OPT, "desicnt": 6,
                                "densify_grad_threshold": 1e-5})
    blce = BlceParams(num_warp=E, start_warp_exposure=100)
    kw = dict(raster_cfg=RasterConfig(max_per_tile=256), scene_extent=6.0,
              seed=1, log_every=1, device="cpu")
    _, hist_a = L.train(world["pts"](), world["pdata"], opt, blce, 6, **kw)
    ts_b, hist_b1 = L.train(world["pts"](), world["pdata"], opt, blce, 3, **kw)
    path = str(tmp_path / "state.npz")
    checkpoint.save_train_state(path, ts_b)
    tmpl = D.grow_train_state(world["pts"](), checkpoint.peek_shape(path, "stat/xyz")[0],
                              checkpoint.peek_shape(path, "dyn/xyz")[0])
    ts_c = checkpoint.load_train_state(path, tmpl)
    assert ts_c.step == 3
    _, hist_b2 = L.train(ts_c, world["pdata"], opt, blce, 6,
                         start_iter=ts_c.step + 1, **kw)
    assert [h["iter"] for h in hist_b2] == [4, 5, 6]
    got, want = hist_b1 + hist_b2, hist_a
    assert max(h["n_stat"] for h in want) > 200  # densify ran
    for a, b in zip(got, want, strict=True):
        assert (a["iter"], a["n_stat"], a["n_dyn"]) == (b["iter"], b["n_stat"], b["n_dyn"])
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=1e-5)


# ---------------------------------------------------------------------------
# the port's loop alone


def test_capacity_escalation_on_pile_up(world):
    """The pile-up of :func:`_pile_up` at max_per_tile=64 (as
    ``tests/test_train_step.py:388-419``): the drift check escalates."""
    ts = from_jax.train_state_from_numpy(to_numpy(_pile_up(world["jts"]())),
                                         device="cpu")
    opt = OptimizationParams(**{**LOOP_OPT, "densification_interval": 2,
                                "densify_from_iter": 1})
    ts, hist = L.train(ts, world["pdata"], opt,
                       BlceParams(num_warp=E, start_warp_exposure=100), 4,
                       raster_cfg=RasterConfig(max_per_tile=64), scene_extent=6.0,
                       log_every=1, device="cpu")
    caps = [h["max_per_tile"] for h in hist]
    assert caps[0] == 64 and caps[-1] > 64, caps
    assert hist[0]["tile_max"] > 64
    assert np.isfinite([h["loss"] for h in hist]).all()


def test_nan_loss_fail_stop(world):
    ts = world["pts"]()
    with torch.no_grad():
        ts.sandwich.w1.fill_(float("nan"))
    with pytest.raises(FloatingPointError, match="iteration 2"):
        L.train(ts, world["pdata"], OptimizationParams(**LOOP_OPT),
                BlceParams(num_warp=E), 3, raster_cfg=RasterConfig(max_per_tile=256),
                log_every=2, device="cpu")


def test_train_runs_on_the_card_unless_told(world):
    """The default device is the card: without one resolve_device raises,
    with one the CPU state is refused."""
    with pytest.raises((RuntimeError, ValueError), match="cuda"):
        L.train(world["pts"](), world["pdata"], OptimizationParams(**LOOP_OPT),
                BlceParams(num_warp=E), 1)
