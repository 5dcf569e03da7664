"""The port's DyBluRF stereo loader (``data/stereo.py``), scene helpers
(``data/scene.py``), warm stage (``train/warm.py``) and the train CLI's
``-s`` start, against the JAX package's, on the CPU.

Inputs: the fabricated stereo scene of ``tests/test_data_loaders.py``
(V = 4 at the loader's fixed 512x288: random frames, depths uniform in
[2, 5], 20 % motion-mask pixels, 16 random TAPIR tracks per (query,
target) pair), read by both loaders.

Tolerances, and why: the loaders read the same files with the same numpy,
so every array is bit-equal, but the blur features, an FFT ratio (JAX's and
torch's FFTs round differently), at rtol 1e-6; the point maps and warps at
atol 1e-5 (float32 3x3 products summed in other orders); the error masks
agree on all but 1e-4 of the pixels: a mask is the threshold
``acc > mean(acc)`` and a pixel on the cut-off can flip between two float32
implementations. On this fixture one pixel of 589,824 flips (its
accumulated error and the frame mean one ulp apart), and one flip changes
every ``rng.choice`` after it, so ``warm_init``'s clouds are compared with
the port's masks held to the JAX package's (atol 1e-5 on the points, colours
and times exactly); the train CLI's start likewise.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mobgs_tpu.ops.rasterize as jrasterize
from mobgs_tpu.cli import train as jcli
from mobgs_tpu.data import scene as jscene
from mobgs_tpu.data import stereo as jstereo
from mobgs_tpu.models import gaussians as jG
from mobgs_tpu.train import loop as jloop
from mobgs_tpu.train import warm as jwarm

from mobgs_tpu_torch.cli import train as pcli
from mobgs_tpu_torch.data import scene as pscene
from mobgs_tpu_torch.data import stereo as pstereo
from mobgs_tpu_torch.models import gaussians as pG
from mobgs_tpu_torch.train import loop as ploop
from mobgs_tpu_torch.train import warm as pwarm

from test_data_loaders import make_stereo_fixture

V = 4
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA_FIELDS = ("w2c", "K", "time", "images", "depths", "blur_feats", "masks", "width",
               "height", "max_time", "test_w2c", "test_images", "test_K", "test_time",
               "points_xyz", "points_rgb", "extent")
SCENE_FIELDS = ("tracklet", "track_visibles", "normals", "test_K", "test_time",
                "fwd_flow", "bwd_flow", "fwd_flow_mask", "bwd_flow_mask")
CLOUD_FIELDS = ("stat_points", "stat_colors", "stat_times", "dyn_points", "dyn_colors",
                "dyn_times", "dyn_trajectory")
# a seesaw overlay with a narrow deformation net and few seeds
OVERLAY = f"""_base_ = {os.path.join(ROOT, 'configs', 'stereo', 'seesaw.py')!r}
ModelHiddenParams = dict(
    kplanes_config={{'grid_dimensions': 2, 'input_coordinate_dim': 4,
                    'output_coordinate_dim': 4, 'resolution': [8, 8, 8, 4]}},
    multires=[1], net_width=16, timenet_width=8, timenet_output=8,
)
OptimizationParams = dict(stat_npts=150, dyn_npts=50)
"""


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's side runs on one CPU thread (as in test_torch_loop.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("stereo") / "scene")
    make_stereo_fixture(root, V=V)
    return root


@pytest.fixture(scope="module")
def scenes(scene_dir):
    return jstereo.load_stereo_scene(scene_dir), pstereo.load_stereo_scene(scene_dir)


def _same(a, b, field):
    if a is None or b is None:
        assert a is None and b is None, field
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, field
        if field == "blur_feats":
            np.testing.assert_allclose(b, a, rtol=1e-6, atol=0)
        else:
            np.testing.assert_array_equal(b, a, err_msg=field)
    else:
        assert a == b and type(a) is type(b), field


@pytest.mark.parametrize("field", DATA_FIELDS)
def test_stereo_scene_data_matches(scenes, field):
    j, p = scenes
    _same(getattr(j.data, field), getattr(p.data, field), field)


@pytest.mark.parametrize("field", SCENE_FIELDS)
def test_stereo_scene_fields_match(scenes, field):
    j, p = scenes
    _same(getattr(j, field), getattr(p, field), field)


def test_tapir_and_llff_helpers_match(scene_dir):
    rng = np.random.default_rng(3)
    occ, dist = rng.normal(size=(2, 5, 64)).astype(np.float32) * 3
    for a, b in zip(jstereo.parse_tapir_track_info(occ, dist),
                    pstereo.parse_tapir_track_info(occ, dist)):
        np.testing.assert_array_equal(b, a)
    tracks = os.path.join(scene_dir, "bootstapir")
    np.testing.assert_array_equal(
        pstereo.load_target_tracks(tracks, 1, [0, 2, 3], dim=1, scale=2.0),
        jstereo.load_target_tracks(tracks, 1, [0, 2, 3], dim=1, scale=2.0))
    arr = np.load(os.path.join(scene_dir, "poses_bounds.npy"))
    (jc, jf), (pc, pf) = jstereo._llff_to_c2w(arr), pstereo._llff_to_c2w(arr)
    np.testing.assert_array_equal(pc, jc)
    assert pf == jf
    depth = rng.uniform(1, 3, (24, 32)).astype(np.float32)
    K = np.array([[30.0, 0, 16], [0, 30.0, 12], [0, 0, 1]], np.float32)
    np.testing.assert_array_equal(pstereo.normals_from_depth(depth, K),
                                  jstereo.normals_from_depth(depth, K))


@pytest.mark.parametrize("marker", ["poses_bounds.npy", "transforms_train.json", "dataset.json",
                                    "train_meta.json", "sparse", None])
def test_sniff_dataset_type_matches(tmp_path, marker):
    if marker == "sparse":
        (tmp_path / marker).mkdir()
    elif marker:
        (tmp_path / marker).write_text("")
    if marker is None:
        for mod in (jstereo, pstereo):
            with pytest.raises(ValueError):
                mod.sniff_dataset_type(str(tmp_path))
    else:
        assert (pstereo.sniff_dataset_type(str(tmp_path))
                == jstereo.sniff_dataset_type(str(tmp_path)))


@pytest.mark.parametrize("dirs", [None, [], ["iteration_10", "iteration_200", "iteration_best"],
                                  ["iteration_best"], ["iteration_7", "other"]])
def test_find_latest_iteration_matches(tmp_path, dirs):
    if dirs is not None:
        for d in dirs:
            (tmp_path / "point_cloud" / d).mkdir(parents=True)
        (tmp_path / "point_cloud").mkdir(exist_ok=True)
    assert (pscene.find_latest_iteration(str(tmp_path))
            == jscene.find_latest_iteration(str(tmp_path)))
    assert pscene.checkpoint_dir("out", 30) == jscene.checkpoint_dir("out", 30)


def test_add_points_matches():
    rng = np.random.default_rng(0)
    pts, cols, nrm = rng.normal(size=(3, 50, 3)).astype(np.float32)
    a = jscene.add_points(pts, cols, nrm, [-1, -2, -3], [1, 2, 3], n_add=40,
                          rng=np.random.default_rng(5))
    b = pscene.add_points(pts, cols, nrm, [-1, -2, -3], [1, 2, 3], n_add=40,
                          rng=np.random.default_rng(5))
    for x, y in zip(a, b):
        np.testing.assert_array_equal(y, x)


def test_load_scene_stereo(scene_dir, scenes):
    for kind in (None, "stereo", "nvidia"):
        d = pscene.load_scene(scene_dir, kind=kind)
        for f in DATA_FIELDS:
            _same(getattr(scenes[1].data, f), getattr(d, f), f)


@pytest.mark.parametrize("layout", ["images_2", "cam00", "blender", "dycheck", "dynerf",
                                    "colmap", "panoptic"])
def test_load_scene_unported_kinds_raise(tmp_path, layout):
    """Every kind reaches its loader in both packages (no kind raises
    NotImplementedError any more): on an empty layout of each kind the
    port's ``load_scene`` fails as the JAX package's does, with the same
    exception type."""
    kind = None
    if layout in ("images_2", "cam00"):
        (tmp_path / "poses_bounds.npy").write_text("")
        (tmp_path / layout).mkdir()
    else:
        kind = layout
    with pytest.raises(Exception) as want:
        jscene.load_scene(str(tmp_path), kind=kind)
    with pytest.raises(Exception) as got:
        pscene.load_scene(str(tmp_path), kind=kind)
    assert not isinstance(got.value, NotImplementedError), got.value
    assert type(got.value) is type(want.value), (got.value, want.value)


# ---- the warm stage

def _t(x):
    return torch.as_tensor(np.asarray(x))


def test_unproject_depth_matches(scenes):
    d = scenes[0].data
    for v in range(V):
        a = np.asarray(jwarm.unproject_depth(*(jnp.asarray(x) for x in
                                               (d.depths[v], d.w2c[v], d.K[v]))))
        b = pwarm.unproject_depth(_t(d.depths[v]), _t(d.w2c[v]), _t(d.K[v])).numpy()
        np.testing.assert_allclose(b, a, atol=1e-5, rtol=0)


def test_inverse_warp_matches(scenes):
    """One reference view at a time and all at once (the port's batch)."""
    d = scenes[0].data
    tgt = 2
    batch, binb = pwarm.inverse_warp(_t(d.images), _t(d.depths[tgt]), _t(d.w2c[tgt]),
                                     _t(d.w2c), _t(d.K[tgt]))
    for ref in range(V):
        a, ainb = jwarm.inverse_warp(*(jnp.asarray(x) for x in (
            d.images[ref], d.depths[tgt], d.w2c[tgt], d.w2c[ref], d.K[tgt])))
        b, inb = pwarm.inverse_warp(_t(d.images[ref]), _t(d.depths[tgt]), _t(d.w2c[tgt]),
                                    _t(d.w2c[ref]), _t(d.K[tgt]))
        np.testing.assert_array_equal(batch[ref].numpy(), b.numpy())
        np.testing.assert_array_equal(binb[ref].numpy(), inb.numpy())
        # a pixel on the image border may fall in or out of bounds
        assert (inb.numpy() != np.asarray(ainb)).mean() <= 1e-4
        same = inb.numpy() == np.asarray(ainb)
        np.testing.assert_allclose(b.numpy()[same], np.asarray(a)[same], atol=1e-5, rtol=0)


@pytest.fixture(scope="module")
def masks(scenes):
    d = scenes[0].data
    jm = np.asarray(jwarm.photometric_error_masks(*(jnp.asarray(x) for x in
                                                    (d.images, d.depths, d.w2c, d.K))))
    pm = pwarm.photometric_error_masks(*(_t(x) for x in (d.images, d.depths, d.w2c, d.K)))
    return jm, pm.numpy()


def test_photometric_error_masks_match(masks):
    jm, pm = masks
    assert pm.shape == jm.shape and pm.dtype == jm.dtype
    assert set(np.unique(pm)) <= {0.0, 1.0}
    assert (pm != jm).mean() <= 1e-4, int((pm != jm).sum())


def _warm_args(scene):
    d = scene.data
    return (d.images, d.depths, d.w2c, d.K, d.time, (d.masks > 0.5).astype(np.float32),
            scene.tracklet)


def test_warm_init_matches(scenes, masks, monkeypatch):
    """The clouds, with the port's masks held to the JAX package's."""
    monkeypatch.setattr(pwarm, "photometric_error_masks",
                        lambda *a: torch.as_tensor(masks[0].copy()))
    a = jwarm.warm_init(*_warm_args(scenes[0]), 500, 120, seed=3)
    b = pwarm.warm_init(*_warm_args(scenes[1]), 500, 120, seed=3, device="cpu")
    for f in CLOUD_FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert x.shape == y.shape and x.dtype == y.dtype, f
        if f in ("stat_points", "dyn_points", "dyn_trajectory"):
            np.testing.assert_allclose(y, x, atol=1e-5, rtol=0, err_msg=f)
        else:
            np.testing.assert_array_equal(y, x, err_msg=f)
    assert b.stat_points.shape == (500, 3) and b.dyn_trajectory.shape == (120, V, 3)


def test_seed_from_depths_matches(scenes):
    a = jwarm.seed_from_depths(scenes[0].data, 333, np.random.default_rng(9))
    b = pwarm.seed_from_depths(scenes[1].data, 333, np.random.default_rng(9), device="cpu")
    np.testing.assert_allclose(b[0], a[0], atol=1e-5, rtol=0)
    np.testing.assert_array_equal(b[1], a[1])


# ---- the train CLI's start with -s

def _pallas_raster_config(*args, **kw):
    kw.setdefault("backend", "pallas")
    return _JRASTER_CONFIG(*args, **kw)


_JRASTER_CONFIG = jrasterize.RasterConfig


@pytest.fixture(scope="module")
def cli_starts(scene_dir, scenes, masks, tmp_path_factory):
    """Both train CLIs on ``-s <fixture>``; each package's loop is replaced
    by one that records what it is handed and returns at once, and its
    ``create_state`` records the seed clouds and trajectories."""
    tmp = tmp_path_factory.mktemp("cli_s")
    overlay = tmp / "small.py"
    overlay.write_text(OVERLAY)
    seen = {"jax": {"seeds": []}, "port": {"seeds": []}}

    def recorder(tag):
        def train(ts, data, opt_cfg, blce_cfg, iterations, **kw):
            seen[tag].update(ts=ts, data=data, kw=kw)
            return ts, []
        return train

    def seeds(tag, real):
        def create_state(points, colors, times, capacity, trajectory=None,
                         traj_times=None, **kw):
            seen[tag]["seeds"].append(
                [None if x is None else np.asarray(x) for x in
                 (points, colors, times, trajectory, traj_times)] + [capacity])
            return real(points, colors, times, capacity, trajectory=trajectory,
                        traj_times=traj_times, **kw)
        return create_state

    args = ["-s", scene_dir, "--configs", str(overlay), "--iterations", "1", "--quiet"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jrasterize, "RasterConfig", _pallas_raster_config)
        mp.setattr(jloop, "train", recorder("jax"))
        mp.setattr(jG, "create_state", seeds("jax", jG.create_state))
        jcli.main(args + ["-m", str(tmp / "jax")])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ploop, "train", recorder("port"))
        mp.setattr(pG, "create_state", seeds("port", pG.create_state))
        mp.setattr(pwarm, "photometric_error_masks", lambda *a: torch.as_tensor(masks[0].copy()))
        pcli.main(args + ["-m", str(tmp / "port")], device="cpu")
    return seen


def test_train_cli_start_seeds_match(cli_starts):
    """The seed clouds and the dynamic trajectories handed to
    ``create_state`` (static, then dynamic), and the states' positions."""
    j, p = cli_starts["jax"], cli_starts["port"]
    assert len(j["seeds"]) == len(p["seeds"]) == 2
    for pool, a, b in zip(("stat", "dyn"), j["seeds"], p["seeds"]):
        names = ("points", "colors", "times", "trajectory", "traj_times", "capacity")
        for name, x, y in zip(names, a, b):
            if x is None or y is None:
                assert x is None and y is None, f"{pool} {name}"
            elif name in ("points", "trajectory"):
                np.testing.assert_allclose(y, x, atol=1e-5, rtol=0, err_msg=f"{pool} {name}")
            else:
                np.testing.assert_array_equal(y, x, err_msg=f"{pool} {name}")
    assert p["seeds"][0][0].shape == (150, 3) and p["seeds"][1][3].shape == (50, V, 3)
    for pool in ("stat", "dyn"):
        js, ps = getattr(j["ts"], pool), getattr(p["ts"], pool)
        assert ps.capacity == js.capacity and int(ps.num_live()) == int(js.num_live()), pool
        np.testing.assert_allclose(ps.xyz.detach().numpy(), np.asarray(js.xyz), atol=1e-5,
                                   rtol=0, err_msg=pool)


def test_train_cli_start_scene_and_budgets_match(cli_starts):
    j, p = cli_starts["jax"], cli_starts["port"]
    for f in ("w2c", "images", "time", "test_w2c"):
        np.testing.assert_array_equal(getattr(p["data"], f), getattr(j["data"], f))
    np.testing.assert_allclose(p["kw"]["scene_extent"], j["kw"]["scene_extent"], rtol=1e-6)
    for cfg in ("raster_cfg", "base_raster_cfg"):
        jc, pc = j["kw"][cfg], p["kw"][cfg]
        assert (pc.tiles_per_gauss, pc.max_per_tile) == (jc.tiles_per_gauss, jc.max_per_tile)
