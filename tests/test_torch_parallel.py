"""The port's scale-out layer (``mobgs_tpu_torch/parallel/``) against the
JAX package's (``mobgs_tpu/parallel/mesh.py``) and against the port's own
one-process run; the tile-range compositor (``tile0``) against the Pallas
path under ``shard_map``; the subpackage exports and ``camera_from_rt``.

The four-rank checks run in one spawn of ``parallel/dryrun.py`` (four
``gloo`` processes on the CPU, data 2 x gauss 2, tile sharding on; each
rank on one torch thread), module-scoped, whose files the tests read.

Tolerances, and why:
- the dry run against the one-process run from the same state and batch:
  loss rtol 1e-5 (the loss is a mean over data ranks of means over their
  views, where one process takes one mean; the gathers are exact); the
  parameters and Adam moments after each step within STEP_REL of each
  leaf's largest magnitude (chip_smoke.py's values), parameters only where
  |mu| > 1e-3·max|mu| of the leaf (with eps=1e-15 an Adam step is ±lr
  wherever a gradient is tiny but nonzero, and two summation orders can
  round such a gradient to opposite signs); live counts and the
  checkpoint round trip exact;
- the first step against the JAX step (Pallas in interpret mode): loss
  rtol 1e-5, the first Adam moment (0.1·gradient) within atol 3e-4 of the
  leaf's largest magnitude and rtol 2e-3, the compositor's gradient
  tolerances (``tests/test_pallas_raster.py``);
- the tile-range compositor: the ranges' forward concatenated equals one
  range bit for bit (per-tile arithmetic is independent of the other
  tiles); their backward summed within 1e-6 of each column's largest
  magnitude of the one range's (the same terms added in another order:
  chunk by chunk over all tiles, or range by range); against the Pallas
  path under shard_map forward atol 2e-5 / rtol 1e-4 and gradients atol
  3e-4 / rtol 2e-3;
- the scale-out renders against JAX's unsharded ``rasterize``: atol 1e-4
  (``test_multiscene_shard.py``'s);
- ``camera_from_rt``: atol 1e-6.
"""

import importlib
import socket

import numpy as np
import jax
import jax.numpy as jnp
import pytest
from jax.sharding import PartitionSpec as JP
import torch
import torch.distributed as dist

import __graft_entry__ as graft
from mobgs_tpu.config import OptimizationParams as JOpt
from mobgs_tpu.data import cameras as jcameras
from mobgs_tpu.io import checkpoint as jckpt
from mobgs_tpu.ops.rasterize import RasterConfig as JRasterConfig
from mobgs_tpu.ops.rasterize import rasterize as jrasterize
from mobgs_tpu.parallel import mesh as JMx
from mobgs_tpu.train import step as jstep

import mobgs_tpu_torch
from mobgs_tpu_torch.data import cameras
from mobgs_tpu_torch.io import checkpoint as ckpt
from mobgs_tpu_torch.ops import cuda_raster
from mobgs_tpu_torch.ops.rasterize import RasterConfig, rasterize
from mobgs_tpu_torch.parallel import dryrun as DR
from mobgs_tpu_torch.parallel import mesh as Mx
from mobgs_tpu_torch.train.step import make_train_step

STEP_REL = {"stat": 1e-4, "dyn": 1e-4, "sandwich": 1e-4, "blce": 1e-3}
GROUP = {"stat": "stat", "stat_opt": "stat", "dyn": "dyn", "dyn_opt": "dyn",
         "sandwich": "sandwich", "sandwich_opt": "sandwich", "blce": "blce",
         "blce_opt": "blce"}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's side runs on one CPU thread: its many small ops gain
    little from more, and beside the suite's other workers a team of
    threads waits on its slowest member at every op."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def dry(tmp_path_factory):
    """The four-rank dry run's directory: its states before and after each
    step, its renders and its summary."""
    out = tmp_path_factory.mktemp("dryrun")
    summary = DR.dryrun(4, "cpu", str(out))
    return out, summary


@pytest.fixture(scope="module")
def one_process():
    """The same run in one process, without a mesh: (losses, the whole
    state before and after each step as checkpoint dicts, live count)."""
    ts = DR.build_tiny(2, "cpu")
    batch = DR.make_batch(2, "cpu")
    opt, rcfg = DR.train_settings(2)
    step = make_train_step(opt, DR.W, DR.H, max_time=5.0, num_warp=DR.NUM_WARP,
                           raster_cfg=rcfg)
    def snapshot(ts):  # the step updates in place; CPU numpy views alias
        return {k: np.array(v) for k, v in ckpt.flatten_train_state(ts).items()}

    states, losses = [snapshot(ts)], []
    for k in range(DR.STEPS_BEFORE + 1):
        if k == DR.STEPS_BEFORE:
            ts, _ = DR.densify_round(ts)
            n_live = int(ts.dyn.num_live())
        ts, m = step(ts, batch)
        losses.append(float(m.loss))
        states.append(snapshot(ts))
    return losses, states, n_live


def _jax_state(num_views):
    """The JAX dry run's TrainState (``__graft_entry__._build_tiny`` at the
    port dry run's capacities) as shapes only: nothing is computed."""
    return jax.eval_shape(lambda: jstep.init_train_state(*graft._build_tiny(
        num_views=num_views, cap_s=256, cap_d=64)[:4]))


@pytest.fixture
def one_rank_group():
    """A one-rank ``gloo`` group on a free local port, destroyed after."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=0,
                            world_size=1)
    yield
    dist.destroy_process_group()


class _StubMesh:
    """The two calls the tile-shard rules make of a mesh, for rank ``r`` of
    a gauss axis of ``n``."""

    def __init__(self, n, r):
        self.n, self.r = n, r

    def size(self, dim):
        return self.n if dim == 1 else 2

    def get_local_rank(self, axis):
        return self.r


def _rel(a, b):
    return float(np.abs(a - b).max()) / max(float(np.abs(b).max()), 1e-30)


# ---------------------------------------------------------------------------
# the mesh and the spec trees


def test_make_mesh_axes_and_errors(one_rank_group):
    mesh = Mx.make_mesh(1, 1)
    assert mesh.mesh_dim_names == ("data", "gauss") and tuple(mesh.shape) == (1, 1)
    assert mesh.device_type == "cpu"
    for bad in ((0, 1), (1, 0), (-1, 2)):
        with pytest.raises(ValueError, match="mesh axes must be positive"):
            Mx.make_mesh(*bad)
    with pytest.raises(ValueError, match="needs 4 ranks for a data=2 x gauss=2"):
        Mx.make_mesh(2, 2)
    with pytest.raises(ValueError, match="needs 8"):
        JMx.make_mesh(2, 4, devices=jax.devices()[:4])


def _port_leaves(node):
    if isinstance(node, dict):
        return [y for v in node.values() for y in _port_leaves(v)]
    if isinstance(node, tuple) and node and not isinstance(node[0], (tuple, dict)) \
            and not hasattr(node, "_fields"):
        return [node]  # a placement pair
    if isinstance(node, (tuple, list)):
        return [y for v in node for y in _port_leaves(v)]
    return [] if node is None else [node]


def test_shard_train_state_specs_pick_the_jax_leaves(one_rank_group):
    """The same leaves sharded on ``gauss`` as the JAX rule, field by
    field, on the dry run's state; with as many views as dynamic slots
    (a BLCE [V, ...] leaf with V == capacity) BLCE stays replicated."""
    cap_d = 64
    jts = _jax_state(cap_d)
    jspecs = JMx.shard_train_state_specs(jts, JMx.make_mesh(1, 2, jax.devices()[:2]))
    ts = DR.build_tiny(2, "cpu")
    from mobgs_tpu_torch.models import blce as B
    ts = ts._replace(blce=B.init_blce(torch.Generator().manual_seed(2), num_views=cap_d,
                                      num_warp=DR.NUM_WARP, device="cpu"))
    assert ts.blce.params.view_embed.shape[0] == ts.dyn.capacity
    specs = Mx.shard_train_state_specs(ts, Mx.make_mesh(1, 1))
    gauss = Mx.gauss_sharding(None)
    assert set(jts._fields) <= set(ts._fields)
    for f in jts._fields:
        jl = jax.tree.leaves(getattr(jspecs, f))
        want = (sum(1 for x in jl if x.spec == JP("gauss")), len(jl))
        pl = _port_leaves(getattr(specs, f))
        got = (sum(1 for x in pl if x == gauss), len(pl))
        assert got == want, (f, got, want)
    assert all(s == Mx.replicated(None) for s in _port_leaves(specs.blce))
    bs = Mx.shard_batch_specs(DR.make_batch(2, "cpu"), None)
    assert all(s == Mx.data_sharding(None) for s in bs) and len(bs) == 7


@pytest.mark.parametrize("n_tiles,axis_n,on", [(32, 4, True), (30, 4, True), (32, 1, True),
                                               (32, 4, False)])
def test_tile_shard_rules_match_jax(n_tiles, axis_n, on):
    """``tile_shard_info`` and ``constrain_tile_axis`` decide as JAX's for a
    divisible tile count, an indivisible one, a one-rank axis and sharding
    off; each rank's slice is its contiguous range, and the ranks' slices
    make the whole."""
    jmesh = JMx.make_mesh(8 // axis_n, axis_n)
    x = torch.arange(n_tiles * 3).reshape(n_tiles, 3)
    try:
        if on:
            JMx.enable_tile_sharding(jmesh, "gauss")
        jinfo = JMx.tile_shard_info(n_tiles)
        slices = []
        for r in range(axis_n):
            if on:
                Mx.enable_tile_sharding(_StubMesh(axis_n, r), "gauss")
            info = Mx.tile_shard_info(n_tiles)
            assert (info is None) == (jinfo is None)
            if info is not None:
                assert info[1:] == jinfo[1:] == ("gauss", axis_n)
            slices.append(Mx.constrain_tile_axis(x, 0))
            Mx.disable_tile_sharding()
    finally:
        JMx.disable_tile_sharding()
        Mx.disable_tile_sharding()
    if on and n_tiles % axis_n == 0:
        per = n_tiles // axis_n
        for r, s in enumerate(slices):
            assert torch.equal(s, x[r * per:(r + 1) * per])
    else:
        assert all(s is x for s in slices)


# ---------------------------------------------------------------------------
# the plain compositor with tile0


def _scene64(seed=5, n=400):
    """A 64x64 view's cloud (16 tiles) and subset mask, as numpy."""
    means, quats, scales, opac, colors = DR.scale_out_cloud(n, seed)
    return means, quats, scales, opac, colors, (np.arange(n) % 2).astype(np.float32)


def _ranged_plain(S):
    """``cuda_raster.composite_plain`` as S tile ranges, each with its
    ``tile0``, concatenated: what a gauss rank of S composites, without
    the collectives."""
    real = cuda_raster.composite_plain

    def plain(ids, counts, rec, col, ntx, sub=False, tile0=0, tpv=None):
        per = ids.shape[0] // S
        outs = [real(ids[r * per:(r + 1) * per], counts[r * per:(r + 1) * per], rec, col,
                     ntx, sub, tile0 + r * per, tpv) for r in range(S)]
        return (torch.cat([o[0] for o in outs]),
                torch.cat([o[1] for o in outs]) if sub else None)
    return plain


def test_plain_compositor_ranges_compose_the_one_range():
    W = H = 64
    means, quats, scales, opac, colors, sub = _scene64()
    from mobgs_tpu_torch.ops import projection, tiles
    K = torch.tensor([[80.0, 0, W / 2], [0, 80.0, H / 2], [0, 0, 1]])
    spl = projection.project(*map(torch.as_tensor, (means, quats, scales)), torch.eye(4), K,
                             W, H)
    bins = tiles.bin_gaussians(spl, W, H, max_per_tile=128)
    rng = np.random.default_rng(1)
    for has_sub in (False, True):
        o = torch.as_tensor(opac)
        rec = cuda_raster.pack_records(spl, o, o * torch.as_tensor(sub) if has_sub else None)
        col = torch.cat([torch.as_tensor(colors), spl.depths[:, None],
                         torch.ones(len(o), 1)], 1)
        ids, cnt, ntx = bins.gauss_ids, bins.counts, bins.n_tiles_x
        full = cuda_raster.composite_tiles_plain(ids, cnt, rec, col, ntx, has_sub)
        g = torch.as_tensor(rng.normal(size=full[0].shape).astype(np.float32))
        g2 = torch.as_tensor(rng.normal(size=(16, 256)).astype(np.float32)) if has_sub else None
        whole = cuda_raster.composite_bwd_plain(ids, cnt, rec, col, *full, g, g2, ntx, has_sub)
        for S in (2, 4):
            per = 16 // S
            outs, grads = [], []
            for r in range(S):
                rows = slice(r * per, (r + 1) * per)
                out = cuda_raster.composite_tiles_plain(ids[rows], cnt[rows], rec, col, ntx,
                                                        has_sub, tile0=r * per)
                outs.append(out)
                grads.append(cuda_raster.composite_bwd_plain(
                    ids[rows], cnt[rows], rec, col, *out, g[rows],
                    g2[rows] if has_sub else None, ntx, has_sub, tile0=r * per))
            assert torch.equal(torch.cat([x[0] for x in outs]), full[0])
            if has_sub:
                assert torch.equal(torch.cat([x[1] for x in outs]), full[1])
            for j in range(7 if has_sub else 6):
                assert _rel(sum(x[0][:, j] for x in grads).numpy(),
                            whole[0][:, j].numpy()) <= 1e-6, (S, j)
            assert _rel(sum(x[1] for x in grads).numpy(), whole[1].numpy()) <= 1e-6


def test_plain_compositor_ranges_match_pallas_under_shard_map(monkeypatch):
    """The port's rasterize with its composite in 4 tile ranges (tile0)
    against the Pallas path tile-sharded 4 ways on a 2 x 4 device mesh
    (``test_multiscene_shard.py:76``), with the fused subset alpha: images,
    subset alpha, depth and the gradients of the means and opacities."""
    W = H = 64
    means, quats, scales, opac, colors, sub = _scene64()
    Kn = np.array([[80.0, 0, W / 2], [0, 80.0, H / 2], [0, 0, 1]], np.float32)
    jcfg = JRasterConfig(tile_chunk=8, max_per_tile=128, backend="pallas")

    def jloss(m, o):
        out = jrasterize(m, jnp.asarray(quats), jnp.asarray(scales), o, jnp.asarray(colors),
                         jnp.eye(4), jnp.asarray(Kn), W, H, background=jnp.zeros(3),
                         alpha_masks=jnp.asarray(sub)[None], config=jcfg)
        return (jnp.sum(out.images[0] ** 2) + jnp.sum(out.sub_alphas[0] ** 2),
                (out.images[0], out.alphas[0], out.sub_alphas[0], out.depths[0]))

    JMx.enable_tile_sharding(JMx.make_mesh(2, 4), axis="gauss")
    try:
        assert JMx.tile_shard_info(16)[2] == 4
        (_, j_outs), j_grads = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1),
                                                          has_aux=True))(
            jnp.asarray(means), jnp.asarray(opac))
    finally:
        JMx.disable_tile_sharding()

    monkeypatch.setattr(cuda_raster, "composite_plain", _ranged_plain(4))
    m, o = (torch.as_tensor(x).requires_grad_(True) for x in (means, opac))
    out = rasterize(m, torch.as_tensor(quats), torch.as_tensor(scales), o,
                    torch.as_tensor(colors), torch.eye(4), torch.as_tensor(Kn), W, H,
                    background=torch.zeros(3), alpha_masks=torch.as_tensor(sub)[None],
                    config=RasterConfig(max_per_tile=128, backend="plain"))
    loss = torch.sum(out.images[0] ** 2) + torch.sum(out.sub_alphas[0] ** 2)
    p_grads = torch.autograd.grad(loss, (m, o))
    p_outs = [x.detach().numpy() for x in (out.images[0], out.alphas[0], out.sub_alphas[0],
                                            out.depths[0])]
    j_outs = [np.asarray(x) for x in j_outs]
    for a, b in zip(p_outs[:3], j_outs[:3]):
        np.testing.assert_allclose(a, b, atol=2e-5, rtol=1e-4)
    seen = j_outs[1] > 1e-3  # depth is divided by alpha
    np.testing.assert_allclose(p_outs[3][seen], j_outs[3][seen], atol=2e-5, rtol=1e-4)
    for a, b in zip(p_grads, j_grads):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=3e-4, rtol=2e-3)


# ---------------------------------------------------------------------------
# four gloo ranks: the dry run


def test_dryrun_summary(dry):
    _, s = dry
    assert s["mesh"] == {"data": 2, "gauss": 2} and s["backend"] == "gloo"
    assert s["checkpoint_roundtrip"] == "bit-equal"
    # rank 0's range in the launches of one view (the mid render) and of
    # two (the E-1 = 2 latent renders, the E-1 = 2 flow passes)
    assert s["tile_ranges"] == {"tiles": 12, "per_view_per_rank": 6,
                                "this_rank": {"1": [0, 6], "2": [0, 12]},
                                "composites": s["tile_ranges"]["composites"]}
    assert s["tile_ranges"]["composites"] > 0 and s["densify_dropped"] >= 0


def test_dryrun_matches_one_process(dry, one_process):
    """Each step's loss, and the state after each step, of the sharded run
    against the same run in one process; the densify's live count."""
    out, s = dry
    losses, states, n_live = one_process
    np.testing.assert_allclose(s["losses"], losses, rtol=1e-5)
    assert s["dyn_live"] == n_live
    for k, want in enumerate(states):
        with np.load(out / f"train_state_{k}.npz") as got:
            assert set(got.files) == set(want)
            for key, b in want.items():
                a = got[key]
                top = key.split("/")[0]
                if b.dtype.kind in "bi" or top.endswith("stats") or top == "step":
                    if top.endswith("stats"):
                        assert _rel(a, b) <= 1e-4 if np.abs(b).max() else not a.any(), key
                    else:
                        assert np.array_equal(a, b), key
                    continue
                if k == 0:
                    assert np.array_equal(a, b), key
                    continue
                tol = STEP_REL[GROUP[top]]
                if "_opt/" in key or not b.size:
                    if b.size and np.abs(b).max():
                        assert _rel(a, b) <= tol, (k, key, _rel(a, b))
                    continue
                # parameters: where the step moved them by a gradient of size
                mu_key = key.replace(f"{top}/", f"{top}_opt/mu/", 1).replace("/params/", "/")
                mu = want.get(mu_key)
                mask = (np.abs(mu) > 1e-3 * np.abs(mu).max()) if mu is not None \
                    and mu.shape == b.shape and np.abs(mu).max() else np.ones(b.shape, bool)
                assert _rel(a[mask], b[mask]) <= tol, (k, key, _rel(a[mask], b[mask]))


def test_dryrun_first_step_matches_jax(dry):
    """The sharded run's first step against the JAX step (Pallas in
    interpret mode) from the same state (the dry run's written before the
    first step, loaded into the JAX package) and batch."""
    out, s = dry
    template = jax.tree.map(lambda x: np.zeros(x.shape, x.dtype), _jax_state(DR.NUM_VIEWS))
    jts = jckpt.load_train_state(str(out / "train_state_0.npz"), template)
    b = DR.make_batch(2, "cpu")
    jbatch = jstep.Batch(*(jnp.asarray(x.numpy()) for x in b))
    step = jstep.make_train_step(JOpt(iterations=10, batch_size=2, lambda_flow_loss=1e-2),
                                 DR.W, DR.H, max_time=5.0, num_warp=DR.NUM_WARP,
                                 raster_cfg=JRasterConfig(tile_chunk=4, max_per_tile=128,
                                                          backend="pallas"))
    jts1, m = step(jts, jbatch)
    np.testing.assert_allclose(s["losses"][0], float(m.loss), rtol=1e-5)
    want = {k: np.asarray(v) for k, v in jckpt._flatten_with_paths(jts1)[0].items()}
    with np.load(out / "train_state_1.npz") as got:
        for key, b in want.items():
            if "_opt/mu/" not in key or not np.abs(b).max():
                continue
            np.testing.assert_allclose(got[key], b, rtol=2e-3,
                                       atol=3e-4 * float(np.abs(b).max()), err_msg=key)


def test_scale_out_renders_match_jax(dry):
    """The gauss-sharded 256x128 render of 1024 Gaussians over 2 gauss ranks
    (each data rank) and the two-scene data-parallel batch, against the
    JAX package's unsharded ``rasterize`` of the same clouds."""
    out, _ = dry

    def jrender(spec, seed):
        w, h, n, f, chunk, cap = spec
        K = jnp.asarray([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1]])
        render = jax.jit(lambda *c: jrasterize(
            *c, jnp.eye(4), K, w, h, background=jnp.zeros(3),
            config=JRasterConfig(tile_chunk=chunk, max_per_tile=cap)).images[0])
        return np.asarray(render(*map(jnp.asarray, DR.scale_out_cloud(n, seed))))

    ref = jrender(DR.HIGHRES, 0)
    for rank, d in ((0, 0), (2, 1)):
        with np.load(out / f"renders_rank{rank}.npz") as r:
            np.testing.assert_allclose(r["highres"], ref, atol=1e-4)
            np.testing.assert_allclose(r[f"scene_{d}"], jrender(DR.MULTISCENE, d), atol=1e-4)


# ---------------------------------------------------------------------------
# the subpackage exports and camera_from_rt


@pytest.mark.parametrize("sub", ["core", "data", "eval", "io", "models", "ops", "parallel",
                                 "train", "utils"])
def test_subpackages_export_the_jax_names(sub):
    """Every module name a JAX subpackage's ``__init__`` imports resolves on
    the port's (``raster_jax`` has no counterpart by design), and importing
    builds or loads no kernel library."""
    jpkg = importlib.import_module(f"mobgs_tpu.{sub}")
    pkg = importlib.import_module(f"mobgs_tpu_torch.{sub}")
    line = next(x for x in open(jpkg.__file__).read().splitlines()
                if x.startswith(f"from mobgs_tpu.{sub} import "))
    names = [n.strip() for n in line.split(" import ")[1].split("#")[0].split(",")]
    assert names and all(hasattr(jpkg, n) for n in names)
    for n in names:
        if n == "raster_jax":
            continue
        assert getattr(pkg, n).__name__ == f"mobgs_tpu_torch.{sub}.{n}"
    assert not cuda_raster._libs
    assert mobgs_tpu_torch.__version__ == "0.1.0"


def test_camera_from_rt_matches_jax():
    rng = np.random.default_rng(4)
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    R, t = q.astype(np.float32), rng.normal(size=3).astype(np.float32)
    K = np.array([[100.0, 0, 32], [0, 90.0, 24], [0, 0, 1]], np.float32)
    jc = jcameras.camera_from_rt(R, t, K, 0.25)
    pc = cameras.camera_from_rt(R, t, K, 0.25, device="cpu")
    for a, b in zip(pc, jc):
        assert a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)
