"""The port's checkpoint IO vs the JAX package's, both directions: the
reference-schema PLY (``io/ply.py``) and its native codec
(``io/native.py``), the decoder's ``.pt``, ``blce.pth`` and
``deformation.pth`` (``io/torch_ckpt.py``), and the full-state npz
carrying the deformation net (``io/checkpoint.py``).

The states and weights are the JAX package's, made from seeds (a numpy
generator for the Gaussian rows, ``jax.random`` for BLCE and the
deformation net) and carried across as numpy arrays. Every comparison is
exact: the files hold float32 copies of the same arrays.
"""

import filecmp
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mobgs_tpu.config import ModelHiddenParams as JHidden
from mobgs_tpu.io import checkpoint as jckpt
from mobgs_tpu.io import ply as jply
from mobgs_tpu.io import torch_ckpt as jTC
from mobgs_tpu.models import blce as jB
from mobgs_tpu.models import gaussians as jG
from mobgs_tpu.models import sandwich as jsand
from mobgs_tpu.models.deformation import init_deformation as j_init_deformation
from mobgs_tpu.train import step as jstep

from mobgs_tpu_torch.config import ModelHiddenParams
from mobgs_tpu_torch.io import checkpoint as pckpt
from mobgs_tpu_torch.io import from_jax, native
from mobgs_tpu_torch.io import ply as pply
from mobgs_tpu_torch.io import torch_ckpt as pTC
from mobgs_tpu_torch.models import gaussians as G
from mobgs_tpu_torch.models import hexplane as HP
from mobgs_tpu_torch.models.deformation import init_deformation

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HIDDEN = dict(net_width=16, timenet_width=8, timenet_output=8, multires=[1, 2],
              kplanes_config={"grid_dimensions": 2, "input_coordinate_dim": 4,
                              "output_coordinate_dim": 4, "resolution": [8, 8, 8, 4]})
V = 5


def to_numpy(x):
    """A JAX pytree of NamedTuples and tuples as dicts and lists of numpy
    arrays."""
    if hasattr(x, "_fields"):
        return {f: to_numpy(getattr(x, f)) for f in x._fields}
    if isinstance(x, (tuple, list)):
        return [to_numpy(v) for v in x]
    return None if x is None else np.asarray(x)


def _rows(seed, M=90, n_live=70):
    rng = np.random.default_rng(seed)
    f = {"xyz": rng.normal(size=(M, 3)),
         "control_xyz": rng.normal(size=(M, G.CONTROL_NUM, 3)),
         "control_num": rng.integers(4, G.CONTROL_NUM + 1, size=M),
         "features_dc": rng.normal(size=(M, 6)),
         "features_rest": rng.normal(size=(M, 16, 3)),
         "features_t": rng.normal(size=(M, 3)),
         "scaling": rng.uniform(-3.0, 0.0, size=(M, 3)),
         "rotation": rng.normal(size=(M, 4)),
         "opacity": rng.normal(size=(M, 1)),
         "omega": rng.normal(size=(M, 4)),
         "motion": rng.normal(size=(M, 9)),
         "zeta": rng.normal(size=(M, 1)),
         "trbf_center": rng.uniform(size=(M, 1)),
         "trbf_scale": rng.normal(size=(M, 1))}
    f = {k: v.astype(np.int32 if k == "control_num" else np.float32) for k, v in f.items()}
    live = np.zeros(M, bool)
    live[rng.choice(M, n_live, replace=False)] = True
    f["live"] = live
    return f


def _states(seed):
    f = _rows(seed)
    return (jG.GaussianState(**{k: jnp.asarray(v) for k, v in f.items()}),
            from_jax.gaussian_state_from_numpy(f, device="cpu"))


def _assert_state_equal(p, j):
    for f in jG.GaussianState._fields:
        a = getattr(p, f).detach().numpy()
        b = np.asarray(getattr(j, f))
        assert a.shape == b.shape and a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)


def _jax_deform(seed=3):
    d = j_init_deformation(jax.random.PRNGKey(seed), JHidden(**HIDDEN))
    return d._replace(grid=d.grid._replace(aabb=jnp.asarray(
        [[1.0, 2.0, 3.0], [-1.0, -2.0, -3.0]], jnp.float32)))


def test_native_library_builds_outside_the_source_tree():
    assert native.load_library() is not None, "g++ build of native/mobgs_io.cpp"
    assert native.library_path().parent == native.BUILD_DIR
    assert native.BUILD_DIR.parts[-2:] == ("build", "native")


def test_native_codec_equals_the_python_codec(tmp_path, monkeypatch):
    jst, pst = _states(0)
    cols = pply.state_to_columns(pst)
    pply.write_ply(str(tmp_path / "native.ply"), cols)
    got_native = pply.read_ply(str(tmp_path / "native.ply"))
    monkeypatch.setattr(native, "ply_write", lambda *a: False)
    monkeypatch.setattr(native, "ply_read", lambda *a: None)
    pply.write_ply(str(tmp_path / "python.ply"), cols)
    assert filecmp.cmp(tmp_path / "native.ply", tmp_path / "python.ply", shallow=False)
    got_python = pply.read_ply(str(tmp_path / "native.ply"))
    assert list(got_native) == list(got_python) == pply.attribute_names()
    for k in cols:
        np.testing.assert_array_equal(got_native[k], got_python[k], err_msg=k)
        np.testing.assert_array_equal(got_native[k], cols[k], err_msg=k)


def test_ply_bytes_and_columns_match_both_ways(tmp_path):
    jst, pst = _states(1)
    pcols, jcols = pply.state_to_columns(pst), jply.state_to_columns(jst)
    assert list(pcols) == list(jcols) == jply.attribute_names() == pply.attribute_names()
    for k in jcols:
        np.testing.assert_array_equal(pcols[k], jcols[k], err_msg=k)
    pply.write_ply(str(tmp_path / "port.ply"), pcols)
    jply.write_ply(str(tmp_path / "jax.ply"), jcols)
    assert filecmp.cmp(tmp_path / "port.ply", tmp_path / "jax.ply", shallow=False)
    for a, b in ((jply.read_ply(str(tmp_path / "port.ply")), pcols),
                 (pply.read_ply(str(tmp_path / "jax.ply")), jcols)):
        for k in b:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("capacity", [None, 120])
def test_load_gaussians_and_sandwich_pt_both_ways(tmp_path, capacity):
    jst, pst = _states(2)
    jsw = jsand.init_sandwich(jax.random.PRNGKey(5))
    psw = from_jax.sandwich_from_numpy(to_numpy(jsw), device="cpu")
    pply.save_gaussians(str(tmp_path / "port.ply"), pst, psw)
    jply.save_gaussians(str(tmp_path / "jax.ply"), jst, jsw)
    for f in ("port.pt", "jax.pt"):
        assert os.path.exists(tmp_path / f)
    # the port's files through the JAX loaders, and the reverse
    _assert_state_equal(pply.load_gaussians(str(tmp_path / "jax.ply"), capacity, device="cpu"),
                        jply.load_gaussians(str(tmp_path / "port.ply"), capacity))
    live = np.asarray(jst.live)
    back = pply.load_gaussians(str(tmp_path / "jax.ply"), capacity, device="cpu")
    n = int(live.sum())
    np.testing.assert_array_equal(back.xyz.detach().numpy()[:n], np.asarray(jst.xyz)[live])
    assert back.capacity == (capacity or n) and int(back.num_live()) == n
    if capacity:
        assert float(back.opacity.detach()[n:].max()) == -10.0
        assert int(back.control_num[n:].min()) == 4
    for w in ("w1", "w2"):
        a = pply.load_sandwich_pt(str(tmp_path / "jax.pt"), device="cpu")
        b = jply.load_sandwich_pt(str(tmp_path / "port.pt"))
        np.testing.assert_array_equal(getattr(a, w).detach().numpy(), np.asarray(getattr(b, w)))
        np.testing.assert_array_equal(np.asarray(getattr(b, w)), np.asarray(getattr(jsw, w)))
    sd_p = torch.load(tmp_path / "port.pt", weights_only=True)
    sd_j = torch.load(tmp_path / "jax.pt", weights_only=True)
    assert {k: (v.shape, v.dtype) for k, v in sd_p.items()} == \
        {k: (v.shape, v.dtype) for k, v in sd_j.items()}


def test_blce_pth_both_ways(tmp_path):
    jstate = jB.init_blce(jax.random.PRNGKey(4), num_views=V, num_warp=5)
    jstate = jstate._replace(exposure_expo=jnp.linspace(0.2, 0.6, V))
    pstate = from_jax.blce_from_numpy(to_numpy(jstate), device="cpu")
    (tmp_path / "p").mkdir()
    (tmp_path / "j").mkdir()
    pTC.save_blce_pth(str(tmp_path / "p"), pstate)
    jTC.save_blce_pth(str(tmp_path / "j"), jstate)
    sd_p = torch.load(tmp_path / "p" / "blce.pth", weights_only=True)
    sd_j = torch.load(tmp_path / "j" / "blce.pth", weights_only=True)
    assert list(sd_p) == list(sd_j)
    for k in sd_j:
        assert (sd_p[k].shape, sd_p[k].dtype) == (sd_j[k].shape, sd_j[k].dtype), k
        assert torch.equal(sd_p[k], sd_j[k]), k
    # each tensor owns its storage (a view would save the stacked parameter)
    assert all(v.untyped_storage().nbytes() == v.numel() * v.element_size()
               for v in sd_p.values())
    jb = jTC.load_blce_pth(str(tmp_path / "p" / "blce.pth"))
    pb = pTC.load_blce_pth(str(tmp_path / "j" / "blce.pth"), device="cpu")
    for f, leaf in zip(jB.BLCEParams._fields, pb.params.leaves()):
        np.testing.assert_array_equal(leaf.detach().numpy(), np.asarray(getattr(jstate.params, f)))
        np.testing.assert_array_equal(np.asarray(getattr(jb.params, f)),
                                      np.asarray(getattr(jstate.params, f)))
    np.testing.assert_array_equal(pb.exposure_expo.numpy(), np.asarray(jstate.exposure_expo))


def test_deformation_pth_both_ways(tmp_path):
    jd = _jax_deform()
    pd = from_jax.deformation_from_numpy(to_numpy(jd), device="cpu")
    hidden, jhidden = ModelHiddenParams(**HIDDEN), JHidden(**HIDDEN)
    (tmp_path / "p").mkdir()
    (tmp_path / "j").mkdir()
    pTC.save_deformation_pth(str(tmp_path / "p"), pd, hidden, num_points=17)
    jTC.save_deformation_pth(str(tmp_path / "j"), jd, jhidden, num_points=17)
    for name in ("deformation.pth", "deformation_table.pth", "deformation_accum.pth"):
        a = torch.load(tmp_path / "p" / name, weights_only=True)
        b = torch.load(tmp_path / "j" / name, weights_only=True)
        if isinstance(b, dict):
            assert list(a) == list(b), name
            for k in b:
                assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k
        else:
            assert a.dtype == b.dtype and torch.equal(a, b), name
    jback = jTC.load_deformation_pth(str(tmp_path / "p" / "deformation.pth"), jhidden)
    pback = pTC.load_deformation_pth(str(tmp_path / "j" / "deformation.pth"), hidden,
                                     device="cpu")
    for a, b, c in zip(jax.tree.leaves(jd), jax.tree.leaves(jback), jax.tree.leaves(pback)):
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a))
        np.testing.assert_array_equal(c.numpy(), np.asarray(a))


def test_deformation_init_shapes_and_laws():
    """The port's own init (its generator's numbers, not JAX's): the JAX
    package's shapes, time planes at 1, spatial planes in [0.1, 0.5),
    linears within ±1/sqrt(fan_in), and set_aabb."""
    hidden = ModelHiddenParams(**HIDDEN)
    pd = init_deformation(torch.Generator().manual_seed(0), hidden, device="cpu")
    jd = _jax_deform()
    for a, b in zip(jax.tree.leaves(pd), jax.tree.leaves(jd)):
        assert tuple(a.shape) == b.shape and a.dtype == torch.float32
    for scale in pd.grid.grids:
        for i, plane in enumerate(scale):
            if i in HP.TIME_PLANE_IDS:
                assert torch.all(plane == 1.0)
            else:
                assert 0.1 <= float(plane.min()) and float(plane.max()) < 0.5
    w = pd.feature_out.ws[0]
    assert float(w.abs().max()) <= 1 / np.sqrt(w.shape[0])
    assert HP.feat_dim(pd.grid) == 4 * len(HIDDEN["multires"])
    g = HP.set_aabb(pd.grid, np.array([1, 2, 3.0]), np.array([-1, -2, -3.0]))
    np.testing.assert_array_equal(g.aabb.numpy(), [[1, 2, 3], [-1, -2, -3]])


def _jax_train_state(seed):
    jst, _ = _states(seed)
    jdy, _ = _states(seed + 1)
    return jstep.init_train_state(
        jst, jdy, jsand.init_sandwich(jax.random.PRNGKey(seed)),
        jB.init_blce(jax.random.PRNGKey(seed + 1), num_views=V, num_warp=3),
        deform=_jax_deform(seed))


def test_train_state_npz_with_deform_both_ways(tmp_path):
    """A JAX npz with ``deform/*`` loads into the port (a template that
    carries a net), and the port's npz loads into the JAX package; the
    deformation leaves arrive bit-equal both ways."""
    jts = _jax_train_state(10)
    other = _jax_train_state(20)  # templates whose every value differs
    p_tmpl = from_jax.train_state_from_numpy(to_numpy(other), device="cpu")
    jckpt.save_train_state(str(tmp_path / "jax.npz"), jts)
    pts = pckpt.load_train_state(str(tmp_path / "jax.npz"), p_tmpl)
    jflat = {k: np.asarray(v) for k, v in jckpt._flatten_with_paths(jts)[0].items()}
    pflat = pckpt.flatten_train_state(pts)
    assert pflat.keys() == jflat.keys()
    assert sum(k.startswith("deform/") for k in pflat) == len(jax.tree.leaves(jts.deform))
    for k in jflat:
        assert pflat[k].dtype == jflat[k].dtype, k
        np.testing.assert_array_equal(pflat[k], jflat[k], err_msg=k)

    pckpt.save_train_state(str(tmp_path / "port.npz"), pts)
    with np.load(tmp_path / "port.npz") as z:
        assert sorted(z.files) == sorted(jflat)
    back = jckpt.load_train_state(str(tmp_path / "port.npz"), other)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jts)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
