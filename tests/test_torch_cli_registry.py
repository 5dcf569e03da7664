"""The train CLI's registry branch (``-s`` on a scene that is not a DyBluRF
stereo one: ``data/scene.py::load_scene``, seeds from the SfM cloud or the
depth priors, 10 % of them dynamic) in both packages, on the CPU.

Inputs: the PanopticSports fixture of ``tests/test_train_cli_registry.py``
(3 frames x 2 cameras at 32x24, 50 SfM points, so several views share one
timestamp) and the dycheck iPhone fixture of ``tests/test_iphone_loader.py``
at 12 frames of 64x48, seeded from its depths, with the defaults of
``Config`` but flow off (as ``tests/test_torch_cli.py``; the flow-on step is
held in ``tests/test_torch_flow.py``), E=3 latent exposures, 240 + 60 depth
seeds and a narrow deformation net. Twelve frames, because a scene with
fewer distinct times than the spline's 12 knots makes the dynamic pool's
initial spline fit singular in both packages (the last test). The JAX CLI composites with its Pallas kernels in
interpret mode (its ``RasterConfig`` name given a ``backend="pallas"``
default, as in ``tests/test_torch_cli.py``); the port with the plain
forward and backward.

1. The JAX CLI trains 2 iterations on each scene.
2. Both CLIs resume from that run's ``train_state.npz`` to iteration 4,
   with an eval at 4.
3. A DyNeRF and an Nvidia monocular directory hold ``poses_bounds.npy``,
   which both CLIs send to the stereo loader (the JAX CLI's routing, kept):
   both raise the same exception type.

4. That singular fit: on the 3-frame iPhone fixture's times JAX's solve
   returns non-finite control points (its loop then stops on a non-finite
   loss at iteration 4), and the port's ``torch.linalg.solve`` raises.

Tolerances, and why: the history's loss rtol 1e-5 and the live counts and
budgets exactly, and the eval PSNR atol 1e-3 dB, as in
``tests/test_torch_cli.py``; each package's loaders read the other's
checkpoint files (the parameters bit-equal to what was written).
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch

import mobgs_tpu.ops.rasterize as jrasterize
from mobgs_tpu.cli import train as jcli
from mobgs_tpu.io import checkpoint as jckpt
from mobgs_tpu.io import ply as jply
from mobgs_tpu.io import torch_ckpt as jTC

from mobgs_tpu_torch.cli import train as pcli
from mobgs_tpu_torch.io import checkpoint as pckpt
from mobgs_tpu_torch.io import ply as pply
from mobgs_tpu_torch.io import torch_ckpt as pTC

from test_data_loaders import make_nvidia_mono_fixture
from test_iphone_loader import make_iphone_fixture
from test_panoptic_loader import _write_fixture as write_panoptic_fixture
from test_torch_loaders import write_dynerf

OVERLAY = """ModelHiddenParams = dict(
    kplanes_config={'grid_dimensions': 2, 'input_coordinate_dim': 4,
                    'output_coordinate_dim': 4, 'resolution': [8, 8, 8, 4]},
    multires=[1], net_width=16, timenet_width=8, timenet_output=8,
)
OptimizationParams = dict(stat_npts=240, dyn_npts=60, lambda_flow_loss=0.0)
"""
COMMON = ["--num_warp", "3", "--quiet"]
START_ITERS, END_ITERS = 2, 4
SCENES = {"panoptic": lambda root: write_panoptic_fixture(root, n_frames=3, n_cams=2),
          "iphone": lambda root: make_iphone_fixture(root, V=12)}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's side runs on one CPU thread (as in test_torch_loop.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pallas_raster_config(*args, **kw):
    kw.setdefault("backend", "pallas")
    return _JRASTER_CONFIG(*args, **kw)


_JRASTER_CONFIG = jrasterize.RasterConfig


@pytest.fixture(scope="module", params=list(SCENES))
def runs(request, tmp_path_factory):
    tmp = tmp_path_factory.mktemp(request.param)
    scene = str(tmp / "scene")
    os.makedirs(scene)
    SCENES[request.param](scene)
    overlay = tmp / "small.py"
    overlay.write_text(OVERLAY)
    args = ["-s", scene, "--configs", str(overlay), *COMMON]
    jstart, jres, pres = (str(tmp / d) for d in ("jstart", "jres", "pres"))
    out = {"dirs": dict(jstart=jstart, jres=jres, pres=pres)}
    ckpt = os.path.join(jstart, "point_cloud", f"iteration_{START_ITERS}", "train_state.npz")
    resume = ["--iterations", str(END_ITERS), "--test_iterations", str(END_ITERS),
              "--start_checkpoint", ckpt]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jrasterize, "RasterConfig", _pallas_raster_config)
        out["jstart_ts"], _ = jcli.main(args + ["--iterations", str(START_ITERS),
                                                "--test_iterations", "100", "-m", jstart])
        shutil.copytree(jstart, jres)
        shutil.copytree(jstart, pres)
        out["jres_ts"], out["jres_hist"] = jcli.main(args + resume + ["-m", jres])
    out["pres_ts"], out["pres_hist"] = pcli.main(args + resume + ["-m", pres], device="cpu")
    return out


def _load_json(d, name):
    with open(os.path.join(d, name)) as f:
        return json.load(f)


def test_registry_resume_history_matches(runs):
    d = runs["dirs"]
    jh, ph = _load_json(d["jres"], "history.json"), _load_json(d["pres"], "history.json")
    assert [h["iter"] for h in jh] == [h["iter"] for h in ph] == [START_ITERS, END_ITERS]
    assert ph[0] == jh[0]
    for a, b in zip(ph, jh):
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=1e-5, err_msg=f"iter {a['iter']}")
        for k in ("n_stat", "n_dyn", "max_per_tile", "tile_max"):
            assert a[k] == b[k], (a["iter"], k)
        assert np.isfinite(a["loss"])
    je, pe = _load_json(d["jres"], "eval_curve.json"), _load_json(d["pres"], "eval_curve.json")
    assert [e["iter"] for e in je] == [e["iter"] for e in pe] == [END_ITERS]
    for k in ("test_psnr", "test_psnr_raw"):
        np.testing.assert_allclose(pe[0][k], je[0][k], atol=1e-3, err_msg=k)


def test_registry_checkpoints_cross_load(runs):
    """The port's resumed checkpoint read by the JAX package's loaders, and
    the JAX one by the port's, each equal to the state its run returned."""
    d = runs["dirs"]
    for side, reader in (("pres", "jax"), ("jres", "port")):
        ck = os.path.join(d[side], "point_cloud", f"iteration_{END_ITERS}")
        ts = runs[f"{side}_ts"]
        z = {}
        with np.load(os.path.join(ck, "train_state.npz")) as f:
            z = {k: f[k] for k in f.files}
        if reader == "jax":
            loaded = jckpt.load_train_state(os.path.join(ck, "train_state.npz"),
                                            runs["jres_ts"])
            got = {k: np.asarray(v) for k, v in jckpt._flatten_with_paths(loaded)[0].items()}
            want = pckpt.flatten_train_state(ts)
            st = jply.load_gaussians(os.path.join(ck, "point_cloud_static.ply"))
            b = jTC.load_blce_pth(os.path.join(ck, "blce.pth"))
            blce = np.asarray(b.exposure_expo)
        else:
            tmpl = runs["pres_ts"]
            loaded = pckpt.load_train_state(os.path.join(ck, "train_state.npz"), tmpl)
            got = pckpt.flatten_train_state(loaded)
            want = {k: np.asarray(v)
                    for k, v in jckpt._flatten_with_paths(ts)[0].items()}
            st = pply.load_gaussians(os.path.join(ck, "point_cloud_static.ply"), device="cpu")
            blce = pTC.load_blce_pth(os.path.join(ck, "blce.pth"),
                                     device="cpu").exposure_expo.numpy()
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"{side} {k}")
        live = z["stat/live"]
        xyz = st.xyz.detach().numpy() if isinstance(st.xyz, torch.Tensor) else np.asarray(st.xyz)
        np.testing.assert_array_equal(xyz, z["stat/xyz"][live])
        np.testing.assert_array_equal(blce, z["blce/exposure_expo"])


@pytest.mark.parametrize("layout", ["dynerf", "nvidia_mono"])
def test_poses_bounds_layouts_route_to_the_stereo_loader(tmp_path, layout):
    root = str(tmp_path / "scene")
    os.makedirs(root)
    (write_dynerf if layout == "dynerf" else make_nvidia_mono_fixture)(root)
    args = ["-s", root, "--iterations", "1", "--num_warp", "3", "--quiet"]
    with pytest.raises(Exception) as want:
        jcli.main(args + ["-m", str(tmp_path / "j")])
    with pytest.raises(Exception) as got:
        pcli.main(args + ["-m", str(tmp_path / "p")], device="cpu")
    assert type(got.value) is type(want.value), (got.value, want.value)


def test_spline_fit_with_fewer_times_than_knots():
    """A reference-side condition kept as it is: the ridge (1e-8) is below
    float32's resolution of the normal matrix, so with 3 distinct times and
    12 knots the fit is singular; JAX's solve gives non-finite control
    points, the port's raises."""
    import jax.numpy as jnp
    from mobgs_tpu.core import spline as jspline
    from mobgs_tpu_torch.core import spline as pspline
    from mobgs_tpu_torch.models.gaussians import CONTROL_NUM

    times = np.array([0.0, 0.5, 1.0], np.float32)
    traj = np.ones((4, 3, 3), np.float32)
    got = np.asarray(jspline.fit_spline_shared(jnp.asarray(traj), jnp.asarray(times),
                                               CONTROL_NUM, CONTROL_NUM))
    assert not np.isfinite(got).all()
    with pytest.raises(torch.linalg.LinAlgError):
        pspline.fit_spline_shared(torch.as_tensor(traj), torch.as_tensor(times),
                                  CONTROL_NUM, CONTROL_NUM)
    # at 12 distinct times both fit the constant trajectory
    times = np.linspace(0, 1, CONTROL_NUM).astype(np.float32)
    traj = np.ones((4, CONTROL_NUM, 3), np.float32)
    a = np.asarray(jspline.fit_spline_shared(jnp.asarray(traj), jnp.asarray(times),
                                             CONTROL_NUM, CONTROL_NUM))
    b = pspline.fit_spline_shared(torch.as_tensor(traj), torch.as_tensor(times),
                                  CONTROL_NUM, CONTROL_NUM).numpy()
    assert np.isfinite(b).all()
    np.testing.assert_allclose(b, a, atol=1e-4)


def test_eval_alignment_needs_equal_splits():
    """The train CLI's eval pairs test view i with train view i
    (``eval/align.py``): where the test split has another length than the
    train split, both packages raise ValueError (JAX's ``vmap`` over both)."""
    import jax
    import jax.numpy as jnp
    from mobgs_tpu.eval.align import align_test_poses as jalign
    from mobgs_tpu.models import blce as jB
    from mobgs_tpu_torch.eval.align import align_test_poses as palign
    from mobgs_tpu_torch.models import blce as pB

    train = np.tile(np.eye(4, dtype=np.float32), (4, 1, 1))
    test = np.tile(np.eye(4, dtype=np.float32), (3, 1, 1))
    bf = np.full(4, 0.3, np.float32)
    with pytest.raises(ValueError):
        jalign(jB.init_blce(jax.random.PRNGKey(0), num_views=4, num_warp=3),
               jnp.asarray(train), jnp.asarray(test), jnp.asarray(bf), num_warp=3)
    with pytest.raises(ValueError, match="pairs test view i"):
        palign(pB.init_blce(torch.Generator().manual_seed(0), num_views=4, num_warp=3,
                            device="cpu"), torch.as_tensor(train), torch.as_tensor(test),
               torch.as_tensor(bf), num_warp=3)
