"""The port's fields vs the JAX package's: the dense grid
(``models/grid.py``), the HexPlane query and plane regularizers
(``models/hexplane.py``), the deformation field (``models/deformation.py``)
and PoseNet (``models/posenet.py``).

The JAX parameters are carried across as numpy arrays
(``io/from_jax.py``) and perturbed from their init first, so that no plane
or head is trivially constant. Forward at rtol 1e-5; gradients within 1e-4
of each leaf's largest magnitude (rtol 1e-4). A ``deformation.pth`` written
by the JAX package and loaded by the port queries equal to the JAX
parameters, which holds the reference's mirrored aabb normalisation.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mobgs_tpu.config import ModelHiddenParams as JHidden
from mobgs_tpu.io import torch_ckpt as jTC
from mobgs_tpu.models import deformation as jDF
from mobgs_tpu.models import grid as jDG
from mobgs_tpu.models import hexplane as jHP
from mobgs_tpu.models import posenet as jPN

from mobgs_tpu_torch.config import ModelHiddenParams
from mobgs_tpu_torch.io import from_jax
from mobgs_tpu_torch.io import torch_ckpt as pTC
from mobgs_tpu_torch.models import deformation as DF
from mobgs_tpu_torch.models import grid as DG
from mobgs_tpu_torch.models import hexplane as HP
from mobgs_tpu_torch.models import posenet as PN

FWD = dict(rtol=1e-5, atol=1e-6)
HIDDEN = dict(net_width=32, defor_depth=2, bounds=1.6, timebase_pe=4,
              timenet_width=16, timenet_output=8,
              kplanes_config={"grid_dimensions": 2, "input_coordinate_dim": 4,
                              "output_coordinate_dim": 6, "resolution": [8, 10, 12, 5]},
              multires=[1, 2])
N = 300


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def t(x):
    return torch.as_tensor(np.array(x))


def to_numpy(x):
    if hasattr(x, "_fields"):
        return {f: to_numpy(getattr(x, f)) for f in x._fields}
    if isinstance(x, (tuple, list)):
        return [to_numpy(v) for v in x]
    return np.asarray(x)


def leaves(x):
    """The tensors of a nested tuple / NamedTuple, in jax.tree.leaves order."""
    if isinstance(x, tuple):
        return [y for v in x for y in leaves(v)]
    return [x] if isinstance(x, torch.Tensor) else []


def grads_close(port, jax_, names=None):
    assert len(port) == len(jax_)
    for i, (a, b) in enumerate(zip(port, jax_)):
        b = np.asarray(b)
        name = names[i] if names else str(i)
        assert a is not None, name
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-4,
                                   atol=1e-4 * max(np.abs(b).max(), 1e-30), err_msg=name)


def perturb(tree, seed):
    """Every float leaf of a JAX pytree plus seeded noise at 10 % of its
    spread (the aabb stays)."""
    rng = np.random.default_rng(seed)
    flat, treedef = jax.tree.flatten(tree)
    out = []
    for x in flat:
        if isinstance(x, jax.Array) and x.dtype == jnp.float32 and x.ndim >= 1 \
                and x.shape != (2, 3):
            x = np.asarray(x)
            x = jnp.asarray(x + rng.normal(size=x.shape).astype(np.float32)
                            * np.float32(0.1 * (x.std() + 0.1)))
        out.append(x)
    return jax.tree.unflatten(treedef, out)


def points(seed, bounds=1.6):
    rng = np.random.default_rng(seed)
    xyz = rng.uniform(-1.2 * bounds, 1.2 * bounds, (N, 3)).astype(np.float32)
    xyz[:4] = [[bounds] * 3, [-bounds] * 3, [bounds, 0, -bounds], [0, 0, 0]]  # the faces
    return xyz


# ---------------------------------------------------------------------------
# the dense grid
# ---------------------------------------------------------------------------

def test_dense_grid_query_scale_isub_match_jax():
    rng = np.random.default_rng(0)
    g = rng.normal(size=(4, 5, 6, 7)).astype(np.float32)
    lo, hi = np.array([-1.0, -2.0, 0.0], np.float32), np.array([1.0, 2.0, 3.0], np.float32)
    xyz = (rng.uniform(-0.2, 1.2, size=(N, 3)) * (hi - lo) + lo).astype(np.float32)
    xyz[:3] = [hi, lo, [hi[0], lo[1], 1.5]]  # upper faces: the whole weight on the far tap
    xyz[3] = [0.0, 0.0, 1.0]                  # an integer lattice coordinate
    jp = jDG.DenseGridParams(jnp.asarray(g), jnp.asarray(lo), jnp.asarray(hi))
    pp = from_jax.dense_grid_from_numpy(to_numpy(jp), device="cpu")

    gw = rng.normal(size=(N, 4)).astype(np.float32)
    jv, jg = jax.jit(jax.value_and_grad(
        lambda grid, x: jnp.sum(jDG.query(jp._replace(grid=grid), x) * gw),
        argnums=(0, 1)))(jp.grid, jnp.asarray(xyz))
    grid_t, xyz_t = pp.grid.clone().requires_grad_(True), t(xyz).requires_grad_(True)
    out = DG.query(pp._replace(grid=grid_t), xyz_t)
    np.testing.assert_allclose(out.detach().numpy(),
                               np.asarray(jDG.query(jp, jnp.asarray(xyz))), **FWD)
    grads_close(torch.autograd.grad(torch.sum(out * t(gw)), (grid_t, xyz_t)), jg,
                ["grid", "xyz"])

    for size in ((8, 3, 9), (5, 6, 7)):
        want = jax.jit(lambda p: jDG.scale_volume_grid(p, size).grid)(jp)
        np.testing.assert_allclose(DG.scale_volume_grid(pp, size).grid.numpy(),
                                   np.asarray(want), **FWD)
    np.testing.assert_array_equal(DG.isub(pp, 0.25).grid.numpy(),
                                  np.asarray(jDG.isub(jp, 0.25).grid))
    pi = DG.set_aabb(DG.init_dense_grid(3, (4, 5, 6), fill=0.5, device="cpu"), hi, lo)
    ji = jDG.set_aabb(jDG.init_dense_grid(3, (4, 5, 6), fill=0.5), hi, lo)
    for a, b in zip(pi, ji):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


# ---------------------------------------------------------------------------
# HexPlane and the deformation field
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def deform():
    jd = perturb(jax.jit(lambda k: jDF.init_deformation(k, JHidden(**HIDDEN)))(
        jax.random.PRNGKey(3)), 4)
    return jd, from_jax.deformation_from_numpy(to_numpy(jd), device="cpu")


def test_hexplane_query_and_regularizers_match_jax(deform):
    jd, pd = deform
    jg, pg = jd.grid, pd.grid
    xyz = points(5)
    tt = np.random.default_rng(6).uniform(-0.1, 1.1, (N, 1)).astype(np.float32)
    gw = np.random.default_rng(7).normal(size=(N, HP.feat_dim(pg))).astype(np.float32)

    def jloss(grids, x):
        f = jHP.query(jg._replace(grids=grids), x, jnp.asarray(tt))
        return jnp.sum(f * gw), f

    (_, jf), jgr = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True))(
        jg.grids, jnp.asarray(xyz))
    grids = tuple(tuple(p.clone().requires_grad_(True) for p in s) for s in pg.grids)
    xyz_t = t(xyz).requires_grad_(True)
    f = HP.query(pg._replace(grids=grids), xyz_t, t(tt))
    np.testing.assert_allclose(f.detach().numpy(), np.asarray(jf), **FWD)
    pgr = torch.autograd.grad(torch.sum(f * t(gw)), [*leaves(grids), xyz_t])
    grads_close(pgr, [*jax.tree.leaves(jgr[0]), jgr[1]])

    names = ("plane_regulation", "time_regulation", "l1_time_regulation")
    jregs = jax.jit(lambda g: [jax.value_and_grad(
        lambda g_, n=n: getattr(jHP, n)(jg._replace(grids=g_)))(g) for n in names])(jg.grids)
    for name, (jv, jgrad) in zip(names, jregs):
        grids = tuple(tuple(p.clone().requires_grad_(True) for p in s) for s in pg.grids)
        v = getattr(HP, name)(pg._replace(grids=grids))
        np.testing.assert_allclose(float(v.detach()), float(jv), rtol=1e-5)
        pg_ = torch.autograd.grad(v, leaves(grids), allow_unused=True)
        jg_ = jax.tree.leaves(jgrad)
        # each regularizer reads only its three planes a scale
        used = [i for i, g in enumerate(pg_) if g is not None]
        assert len(used) == 6 and all(not np.asarray(jg_[i]).any()
                                      for i in range(12) if i not in used)
        grads_close([pg_[i] for i in used], [jg_[i] for i in used], [name] * 6)


@pytest.mark.parametrize("per_point_t", [False, True])
def test_apply_deformation_matches_jax(deform, per_point_t):
    jd, pd = deform
    rng = np.random.default_rng(8)
    xyz = points(9)
    scales = rng.normal(size=(N, 3)).astype(np.float32) - 3.0
    rots = rng.normal(size=(N, 4)).astype(np.float32)
    tv = rng.uniform(0, 1, N).astype(np.float32) if per_point_t else np.float32(0.37)
    gws = [rng.normal(size=(N, c)).astype(np.float32) for c in (3, 3, 4)]

    def jloss(params, x, s, r):
        outs = jDF.apply_deformation(params, x, s, r, jnp.asarray(tv))
        return sum(jnp.sum(o * g) for o, g in zip(outs, gws)), outs

    (_, jouts), jgr = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1, 2, 3), has_aux=True))(
        jd, jnp.asarray(xyz), jnp.asarray(scales), jnp.asarray(rots))
    p_leaves = [x.clone().requires_grad_(True) for x in leaves(pd)]
    params = _rebuild(pd, iter(p_leaves))
    ins = [t(a).requires_grad_(True) for a in (xyz, scales, rots)]
    outs = DF.apply_deformation(params, *ins, t(tv))
    for o, jo in zip(outs, jouts):
        np.testing.assert_allclose(o.detach().numpy(), np.asarray(jo), rtol=1e-5, atol=1e-5)
    loss = sum(torch.sum(o * t(g)) for o, g in zip(outs, gws))
    pgr = torch.autograd.grad(loss, [*p_leaves, *ins], allow_unused=True)
    want = [*jax.tree.leaves(jgr[0]), *jgr[1:]]
    # the aabb and the timenet take no gradient on either side
    live = [i for i, w in enumerate(want) if np.abs(np.asarray(w)).max() > 0]
    assert all(pgr[i] is None or float(pgr[i].abs().max()) == 0
               for i in range(len(want)) if i not in live)
    grads_close([pgr[i] for i in live], [want[i] for i in live])

    jr = jDF.regulation_loss(jd, 0.01, 1e-4, 2e-4)
    np.testing.assert_allclose(float(DF.regulation_loss(pd, 0.01, 1e-4, 2e-4)), float(jr),
                               rtol=1e-5)


def _rebuild(template, it):
    """``template`` with its tensors replaced, in order, from ``it``."""
    if isinstance(template, tuple):
        vals = [_rebuild(v, it) for v in template]
        return type(template)(*vals) if hasattr(template, "_fields") else tuple(vals)
    return next(it) if isinstance(template, torch.Tensor) else template


def test_poc_fre_matches_jax():
    x = np.random.default_rng(10).normal(size=(7, 3)).astype(np.float32)
    poc = 2.0 ** np.arange(4, dtype=np.float32)
    for port, ref in ((DF.poc_fre, jDF.poc_fre), (PN.poc_fre, jPN.poc_fre)):
        np.testing.assert_allclose(port(t(x), t(poc)).numpy(),
                                   np.asarray(ref(jnp.asarray(x), jnp.asarray(poc))), **FWD)


def test_deformation_pth_from_jax_queries_equal(deform, tmp_path):
    """The JAX package writes ``deformation.pth``, the port loads it and
    samples the planes as JAX does; without the mirrored normalisation the
    samples would differ."""
    jd, _ = deform
    jTC.save_deformation_pth(str(tmp_path), jd, JHidden(**HIDDEN), num_points=5)
    pd = pTC.load_deformation_pth(str(tmp_path / "deformation.pth"),
                                  ModelHiddenParams(**HIDDEN), device="cpu")
    xyz = points(11)
    tt = np.random.default_rng(12).uniform(0, 1, (N, 1)).astype(np.float32)
    want = np.asarray(jax.jit(jHP.query)(jd.grid, jnp.asarray(xyz), jnp.asarray(tt)))
    got = HP.query(pd.grid, t(xyz), t(tt)).numpy()
    np.testing.assert_allclose(got, want, **FWD)
    unmirrored = HP.query(pd.grid._replace(aabb=pd.grid.aabb.flip(0)), t(xyz), t(tt))
    assert np.abs(unmirrored.numpy() - want).max() > 1e-2
    np.testing.assert_allclose(
        DF.apply_deformation(pd, t(xyz), t(xyz), t(np.ones((N, 4), np.float32)), 0.5)[0].numpy(),
        np.asarray(jax.jit(jDF.apply_deformation)(jd, jnp.asarray(xyz), jnp.asarray(xyz),
                                                  jnp.ones((N, 4)), 0.5)[0]),
        rtol=1e-5, atol=1e-5)


def test_init_laws_give_jax_shapes():
    cfg = HIDDEN["kplanes_config"]
    jh = jax.eval_shape(lambda k: jHP.init_hexplane(k, 1.6, cfg, [1, 2]), jax.random.PRNGKey(0))
    ph = HP.init_hexplane(torch.Generator().manual_seed(0), 1.6, cfg, [1, 2], device="cpu")
    assert [tuple(a.shape) for a in leaves(ph)] == [x.shape for x in jax.tree.leaves(jh)]
    for i, planes in enumerate(ph.grids):
        for ci, p in enumerate(planes):
            if ci in HP.TIME_PLANE_IDS:
                assert bool((p == 1).all())
            else:
                assert 0.1 <= float(p.min()) and float(p.max()) <= 0.5
    jp = jax.eval_shape(lambda k: jPN.init_posenet(k, 5, 8, 10, 4.0), jax.random.PRNGKey(0))
    pp = PN.init_posenet(torch.Generator().manual_seed(0), 5, 8, 10, 4.0, device="cpu")
    jl = [x for x in jax.tree.leaves(jp) if x.shape != ()]
    assert [tuple(a.shape) for a in leaves(pp)] == [x.shape for x in jl]
    assert bool((pp.timenet_out_w == 1e-6).all()) and bool((pp.instance_scale == 1).all())
    np.testing.assert_allclose(float(pp.focal_bias), np.log(500.0), rtol=1e-7)
    assert (pp.max_time, pp.H, pp.W) == (4.0, 8, 10)


# ---------------------------------------------------------------------------
# PoseNet
# ---------------------------------------------------------------------------

def test_posenet_matches_jax():
    Hh, Ww, V = 6, 8, 5
    jp = perturb(jPN.init_posenet(jax.random.PRNGKey(1), V, Hh, Ww, 4.0), 13)
    jp = jp._replace(instance_scale=jnp.linspace(0.5, 1.5, V)[:, None])
    pp = from_jax.posenet_from_numpy(to_numpy(jp), device="cpu")
    # truncation toward zero and the clip: -0.1 → 0, 0.999·4 → 3, 1.3·4 → 4
    times = np.array([-0.1, 0.0, 0.26, 0.5, 0.999, 1.3], np.float32)
    depth = np.random.default_rng(14).uniform(1, 3, (len(times), Hh * Ww)).astype(np.float32)
    gws = [np.random.default_rng(15 + i).normal(size=s).astype(np.float32)
           for i, s in enumerate([(6, 3, 3), (6, 3), (6, 1, Hh, Ww)])]
    dif = ("timenet0", "timenet1", "timenet_out_w", "instance_scale")

    def jloss(parts, tm):
        outs = jPN.posenet_forward(jp._replace(**dict(zip(dif, parts))), tm, jnp.asarray(depth))
        return sum(jnp.sum(o * g) for o, g in zip(outs, gws)), outs

    (_, jouts), jgr = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True))(
        tuple(getattr(jp, f) for f in dif), jnp.asarray(times))
    parts = [_rebuild(getattr(pp, f), iter([x.clone().requires_grad_(True)
                                            for x in leaves((getattr(pp, f),))]))
             for f in dif]
    tm = t(times).requires_grad_(True)
    outs = PN.posenet_forward(pp._replace(**dict(zip(dif, parts))), tm, t(depth))
    for o, jo in zip(outs, jouts):
        np.testing.assert_allclose(o.detach().numpy(), np.asarray(jo), rtol=1e-5, atol=1e-6)
    loss = sum(torch.sum(o * t(g)) for o, g in zip(outs, gws))
    pgr = torch.autograd.grad(loss, [*leaves(tuple(parts)), tm])
    grads_close(pgr, [*jax.tree.leaves(jgr[0]), jgr[1]])
    R, tr = PN.posenet_forward(pp, t(times))
    np.testing.assert_allclose(R.numpy(), np.asarray(jouts[0]), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(PN.euler2mat(t(np.asarray(jouts[1]))).numpy(),
                               np.asarray(jPN.euler2mat(jouts[1])), rtol=1e-5, atol=1e-6)
