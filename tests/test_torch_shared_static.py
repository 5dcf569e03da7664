"""The port's camera-shared static pool (``ops/tiles.py::bin_static`` /
``merge_dyn_bins``, ``ops/rasterize.py::make_shared_static`` and
``rasterize(shared=)``, ``models/render.py::make_shared_view`` and
``train/step.py``'s ``shared_static``) against the JAX package's and
against the port's own unshared path, the three cases of
``tests/test_shared_static.py``.

Inputs are made from a seed with numpy and fed to both packages. The JAX
side composites with its Pallas kernels in interpret mode
(``backend="pallas"``), whose semantics the port's plain compositor keeps.

Tolerances, and why:
- the bins: bit-equal (ids within each tile's count, counts, ``max_count``):
  the keys come from the same float operations and both row sorts are
  stable;
- ``rasterize(shared=)`` against the unshared port: images, alphas and
  means2d bit-equal, since the composite's inputs are the same bits; the
  gradient within 1e-6 of its largest magnitude (autograd adds the static
  rows' projection gradients of several passes in another order); against
  JAX at the forward atol 2e-5 of ``tests/test_pallas_raster.py`` and the
  gradient at the atol 2e-2 / rtol 2e-3 of ``tests/test_shared_static.py``:
  each Gaussian's gradient there is a sum of cancelling pixel terms of
  ~1e3, so float32 reassociation leaves ~1e-3 absolute (measured 3.0e-3 on
  an entry of 1.2e3);
- the flow-on step with ``shared_static=True`` against JAX's: the
  tolerances of ``tests/test_torch_flow.py`` (loss rtol 1e-5, flow term
  rtol 1e-4, each gradient leaf at STEP_TOL of its largest magnitude);
  against the port's unshared step: loss rtol 1e-6 and each leaf within
  1e-5 of its largest magnitude.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mobgs_tpu.ops import projection as jprojection
from mobgs_tpu.ops import tiles as jtiles
from mobgs_tpu.ops.rasterize import RasterConfig as JRasterConfig
from mobgs_tpu.ops.rasterize import make_shared_static as j_make_shared_static
from mobgs_tpu.ops.rasterize import rasterize as jrasterize
from mobgs_tpu.train import loop as jL
from mobgs_tpu.train import step as jstep

from mobgs_tpu_torch.models import gaussians as G
from mobgs_tpu_torch.ops import cuda_raster, projection, tiles
from mobgs_tpu_torch.ops.rasterize import RasterConfig, make_shared_static, rasterize
from mobgs_tpu_torch.train import loop, step

from test_torch_flow import (E, H as FH, JCFG as FJCFG, CFG as FCFG, STEP_TOL,
                             W as FW, _jax_state, _port_state, rel_close, to_numpy,
                             world)

W, H = 128, 64
KMAT = np.array([[120.0, 0, W / 2], [0, 120.0, H / 2], [0, 0, 1]], np.float32)
CFG = RasterConfig(max_per_tile=64, tiles_per_gauss=9)
JCFG = JRasterConfig(max_per_tile=64, tiles_per_gauss=9, tile_chunk=8, backend="pallas")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's side runs on one CPU thread (as in test_torch_loop.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_cloud(n, seed=0):
    """``tests/test_multiscene_shard.py::make_cloud``'s draws, as numpy."""
    rng = np.random.default_rng(seed)
    means = rng.normal(size=(n, 3)).astype(np.float32)
    means[:, 2] += 7.0
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    scales = np.exp(rng.uniform(-3.5, -2, (n, 3))).astype(np.float32)
    opac = rng.uniform(0.3, 0.9, n).astype(np.float32)
    colors = rng.uniform(size=(n, 3)).astype(np.float32)
    return means, quats, scales, opac, colors


def _project_both(means, quats, scales):
    j = jprojection.project(jnp.asarray(means), jnp.asarray(quats), jnp.asarray(scales),
                            jnp.eye(4), jnp.asarray(KMAT), W, H, eps2d=CFG.eps2d,
                            near=CFG.near, sigma_cut=CFG.sigma_cut)
    p = projection.project(torch.as_tensor(means), torch.as_tensor(quats),
                           torch.as_tensor(scales), torch.eye(4), torch.as_tensor(KMAT),
                           W, H, eps2d=CFG.eps2d, near=CFG.near, sigma_cut=CFG.sigma_cut)
    return j, p


def _live_ids(bins):
    ids, counts = np.asarray(bins.gauss_ids), np.asarray(bins.counts)
    live = np.arange(ids.shape[1])[None, :] < counts[:, None]
    return np.where(live, ids, -1)


def _piled_clouds(ties: bool):
    """768 static and 256 dynamic splats, the dynamic ones piled in front
    of the static cloud so single tiles overflow and dynamic records
    displace static ones past the cap. With ``ties`` a quarter of the
    dynamic splats sit at the very place (and depth) of a static one, so
    their sort keys are equal."""
    ms, qs, ss, *_ = make_cloud(768, seed=0)
    md, qd, sd, *_ = make_cloud(256, seed=1)
    md = md * np.float32([0.2, 0.2, 0.05]) + np.float32([0.0, 0.0, 5.0])
    if ties:
        ms[:64] = md[:64]
        qs[:64], ss[:64] = qd[:64], sd[:64]
    return (ms, qs, ss), (md, qd, sd)


@pytest.mark.parametrize("ties", [False, True], ids=["piled", "forced_ties"])
def test_merge_dyn_bins_bit_exact(ties):
    (ms, qs, ss), (md, qd, sd) = _piled_clouds(ties)
    (js, ps), (jd, pd) = _project_both(ms, qs, ss), _project_both(md, qd, sd)
    if ties:
        # equal depths and tiles, so equal keys across the two pools
        np.testing.assert_array_equal(ps.depths[:64].numpy(), pd.depths[:64].numpy())
    kw = dict(tiles_per_gauss=CFG.tiles_per_gauss, max_per_tile=CFG.max_per_tile)
    j_got = jtiles.merge_dyn_bins(jtiles.bin_static(js, W, H, **kw), jd, 768, W, H, **kw)
    p_static = tiles.bin_static(ps, W, H, **kw)
    p_got = tiles.merge_dyn_bins(p_static, pd, 768, W, H, **kw)
    p_all = projection.ProjectedSplats(*(torch.cat([a, b]) for a, b in zip(ps, pd)))
    p_ref = tiles.bin_gaussians(p_all, W, H, **kw)

    assert int(p_ref.max_count) > CFG.max_per_tile, "no tile overflowed"
    for ref in (j_got, p_ref):
        assert int(p_got.max_count) == int(ref.max_count)
        np.testing.assert_array_equal(p_got.counts.numpy(), np.asarray(ref.counts))
        np.testing.assert_array_equal(_live_ids(p_got), _live_ids(ref))
    np.testing.assert_array_equal(p_static.keys.numpy(),
                                  np.asarray(jtiles.bin_static(js, W, H, **kw).keys))
    assert p_got.gauss_ids.dtype == torch.int32 and p_got.counts.dtype == torch.int32
    if ties:
        # a tile where a static and a dynamic record share a key: the static
        # one comes first, as in the stable combined sort
        ks, _, st, cn, _, _ = tiles._expand_sort(pd, W, H, CFG.tiles_per_gauss)
        keys_cat = torch.cat([p_static.keys, tiles._key_panel(
            ks, st, cn, p_static.ids.shape[0], CFG.max_per_tile)], 1)
        live = keys_cat < tiles.INT32_MAX
        dup = [r for r in range(keys_cat.shape[0])
               if len(set(keys_cat[r][live[r]].tolist())) < int(live[r].sum())]
        assert dup, "no tie between the pools"


def _shared_inputs():
    Ms = 768
    ms, qs, ss, os_, cs = make_cloud(Ms, seed=2)
    md, qd, sd, od, cd = make_cloud(192, seed=3)
    cat = [np.concatenate(p) for p in ((ms, md), (qs, qd), (ss, sd), (os_, od), (cs, cd))]
    dyn_mask = np.concatenate([np.zeros(Ms), np.ones(192)]).astype(np.float32)
    return Ms, cat, dyn_mask


def _port_raster(Ms, cat, dyn_mask, use_shared):
    means = torch.as_tensor(cat[0]).requires_grad_(True)
    quats, scales, opac, colors = (torch.as_tensor(x) for x in cat[1:])
    shared = (make_shared_static(means[:Ms], quats[:Ms], scales[:Ms], torch.eye(4),
                                 torch.as_tensor(KMAT), W, H, CFG) if use_shared else None)
    out = rasterize(means, quats, scales, opac, colors, torch.eye(4),
                    torch.as_tensor(KMAT), W, H, background=torch.zeros(3),
                    alpha_masks=torch.as_tensor(dyn_mask)[None], config=CFG,
                    shared=shared)
    loss = (torch.sum(out.images[0] ** 2) + torch.sum(out.alphas ** 2)
            + torch.sum(out.depths ** 2) + torch.sum(out.sub_alphas ** 2))
    (g,) = torch.autograd.grad(loss, means)
    return float(loss.detach()), out, g


def test_rasterize_shared_matches_images_and_grads():
    Ms, cat, dyn_mask = _shared_inputs()
    before = dict(cuda_raster.launches)
    l0, o0, g0 = _port_raster(Ms, cat, dyn_mask, False)
    l1, o1, g1 = _port_raster(Ms, cat, dyn_mask, True)
    assert cuda_raster.launches == before  # CPU tensors: the plain route
    for f in ("images", "alphas", "depths", "sub_alphas", "means2d", "radii"):
        assert torch.equal(getattr(o1, f), getattr(o0, f)), f
    assert int(o1.tile_max) == int(o0.tile_max)
    assert l1 == l0
    rel_close(g1, g0.numpy(), 1e-6, "shared vs unshared gradient")

    jcat = [jnp.asarray(x) for x in cat]

    def jrun(m):
        shared = j_make_shared_static(m[:Ms], jcat[1][:Ms], jcat[2][:Ms], jnp.eye(4),
                                      jnp.asarray(KMAT), W, H, JCFG)
        out = jrasterize(m, *jcat[1:], jnp.eye(4), jnp.asarray(KMAT), W, H,
                         background=jnp.zeros(3), alpha_masks=jnp.asarray(dyn_mask)[None],
                         config=JCFG, shared=shared)
        loss = (jnp.sum(out.images[0] ** 2) + jnp.sum(out.alphas ** 2)
                + jnp.sum(out.depths ** 2) + jnp.sum(out.sub_alphas ** 2))
        return loss, out

    (jl, jo), jg = jax.jit(jax.value_and_grad(jrun, has_aux=True))(jcat[0])
    for f in ("images", "alphas", "depths", "sub_alphas"):
        np.testing.assert_allclose(getattr(o1, f).detach().numpy(), np.asarray(getattr(jo, f)),
                                   atol=2e-5, err_msg=f)
    np.testing.assert_allclose(o1.means2d.detach().numpy(), np.asarray(jo.means2d), atol=2e-5)
    np.testing.assert_allclose(l1, float(jl), rtol=1e-5)
    np.testing.assert_allclose(g1.numpy(), np.asarray(jg), atol=2e-2, rtol=2e-3)
    assert float(o1.sub_alphas.detach().max()) > 0.5 and float(g1.abs().max()) > 0


# ---------------------------------------------------------------------------
# the flow-on step (the world of tests/test_torch_flow.py)


def _port_step_grads(world, pts, pb, shared_static):
    fwd = step.make_forward(world["popt"], FW, FH, 1.0, E, FCFG,
                            shared_static=shared_static)
    off = torch.zeros((2, pts.stat.capacity + pts.dyn.capacity, 2), requires_grad=True)
    groups = (G.split_diff(pts.stat)[0], G.split_diff(pts.dyn)[0],
              step.sandwich_leaves(pts.sandwich), pts.blce.params.leaves(), (off,))
    leaves = [p for grp in groups for p in grp]
    with torch.enable_grad():
        for p in leaves:
            p.requires_grad_(True)
        total, aux = fwd(pts.stat, pts.dyn, pts.sandwich, pts.blce, off, pb)
        grads = torch.autograd.grad(total, leaves, allow_unused=True)
    return float(total.detach()), aux, [
        torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]


@pytest.fixture(scope="module")
def shared_step(world):
    ids = np.array([1, 4])
    pb = loop.make_batch(world["pdata"], ids, device="cpu")
    jfn = jstep.make_train_step(world["jopt"], FW, FH, 1.0, E, FJCFG, scan_passes=True,
                                scan_views=True, shared_static=True)
    j_new, j_metrics = jfn(_jax_state(world), jL.make_batch(world["jdata"], ids))
    before = dict(cuda_raster.launches)
    runs = {mode: _port_step_grads(world, _port_state(world), pb, mode)
            for mode in (True, False)}
    p_new, p_metrics = step.make_train_step(world["popt"], FW, FH, 1.0, E, FCFG,
                                            shared_static=True)(_port_state(world), pb)
    assert cuda_raster.launches == before  # CPU tensors: the plain route
    return dict(j_new=to_numpy(j_new), j_metrics=j_metrics, runs=runs, p_new=p_new,
                p_metrics=p_metrics)


def test_shared_static_step_matches_jax(shared_step):
    jm, pm = shared_step["j_metrics"], shared_step["p_metrics"]
    for f in ("loss", "photo", "depth_l1", "mask"):
        np.testing.assert_allclose(float(getattr(pm, f)), float(getattr(jm, f)),
                                   rtol=1e-5, err_msg=f)
    np.testing.assert_allclose(float(pm.flow), float(jm.flow), rtol=1e-4)
    assert float(pm.flow) > 0 and int(pm.tile_max) == int(jm.tile_max)
    # the raw gradients against the JAX step's first Adam moment from zero,
    # m = (1 - beta1)·g, BLCE's global-norm clip applied before Adam
    grads = shared_step["runs"][True][2]
    i = 0
    for group in ("stat", "dyn", "sandwich", "blce"):
        mu = shared_step["j_new"][f"{group}_opt"]["mu"]
        pg = grads[i:i + len(mu)]
        i += len(mu)
        scale = 1.0
        if group == "blce":
            gnorm = float(torch.sqrt(sum(torch.sum(g * g) for g in pg) + 1e-20))
            scale = min(1.0, 1.0 / gnorm)
        for name, a in zip(list(mu), pg):
            b = np.asarray(mu[name]) / np.float32(0.1)
            if not np.abs(b).max():
                assert not a.any(), f"{group}.{name}: the reference has no gradient"
                continue
            rel_close(a * scale, b, STEP_TOL[group], f"{group}.{name}")
    js = shared_step["j_new"]["stat_stats"]
    rel_close(shared_step["p_new"].stat_stats.xyz_grad_accum, js["xyz_grad_accum"],
              STEP_TOL["offsets"], "stat_stats.xyz_grad_accum")


def test_shared_static_step_matches_unshared(shared_step):
    (l1, a1, g1), (l0, a0, g0) = (shared_step["runs"][m] for m in (True, False))
    np.testing.assert_allclose(l1, l0, rtol=1e-6)
    for key in ("photo", "depth_l1", "mask", "flow"):
        np.testing.assert_allclose(float(a1[key].detach()), float(a0[key].detach()), rtol=1e-6,
                                   err_msg=key)
    assert torch.equal(a1["radii"], a0["radii"]) and int(a1["tile_max"]) == int(a0["tile_max"])
    for j, (a, b) in enumerate(zip(g1, g0)):
        rel_close(a, b.numpy(), 1e-5, f"leaf {j}")
