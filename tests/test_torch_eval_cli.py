"""The port's eval half end to end against the JAX package's, on the CPU:
``cli/eval_cli.py`` (test-pose alignment, TTO, refined renders, solved
poses, ATE / RPE) and ``cli/metrics_cli.py`` (PSNR, SSIM, LPIPS, tOF,
``results.json``), on one checkpoint.

The JAX train CLI writes the checkpoint: 2 iterations of the seesaw overlay
of ``tests/test_torch_cli.py`` on a 48x32x6 synthetic scene at E=3, with no
eval, so ``--iteration best`` falls back to ``iteration_2`` in both eval
CLIs; its ``blce.pth`` aligns the test poses (at the eval CLI's default
num_warp=9, past the checkpoint's 3 time embeddings, which both packages
read as the last). Each eval CLI then runs 3 TTO steps on a copy of the
directory, the port on the JAX generator's scene, and each metrics CLI on
its eval CLI's output. The JAX side composites with its Pallas kernels in
interpret mode (its TTO is built with ``backend="pallas"``; ``"auto"``
would pick the XLA compositor on a CPU), the port with the plain forward
and backward. Then both eval CLIs read a stereo scene (``-s``, the
fabricated fixture of ``tests/test_data_loaders.py`` at 512x288) at 0 TTO
steps: the aligned renders of the same checkpoint.

Tolerances, and why: the solved poses atol 1e-5 (as ``tests/test_torch_eval.py``
after 3 TTO steps: Adam moves each pose scalar by about lr whatever the
gradient's size); the refined PNGs within one 8-bit level (a value on a
rounding boundary), the ground-truth PNGs bit-equal; the mean PSNR 1e-3 dB;
ATE and RPE-t 1e-5 (of poses within 1e-5), RPE-r as its test says; the metrics of the same PNGs: PSNR
and SSIM 1e-4, ``lpips_randfeat`` 1e-5, tOF 1e-3.
"""

import contextlib
import io
import json
import os
import re
import shutil

import numpy as np
import pytest
import torch
from PIL import Image

import mobgs_tpu.ops.rasterize as jrasterize
from mobgs_tpu.cli import eval_cli as jeval
from mobgs_tpu.cli import metrics_cli as jmetrics
from mobgs_tpu.cli import train as jtrain
from mobgs_tpu.data import stereo as jstereo
from mobgs_tpu.data import synthetic as jsyn
from mobgs_tpu.eval import pose_metrics as jpose
from mobgs_tpu.eval import tto as jtto

from mobgs_tpu_torch.cli import eval_cli as peval
from mobgs_tpu_torch.cli import metrics_cli as pmetrics
from mobgs_tpu_torch.data import synthetic as psyn
from mobgs_tpu_torch.eval import pose_metrics as ppose

from test_data_loaders import make_stereo_fixture
from test_torch_cli import OVERLAY

SIZE = "48x32x6"
TRAIN = ["--synthetic", "--synthetic_size", SIZE, "--num_warp", "3", "--quiet",
         "--iterations", "2", "--test_iterations", "100"]
EVAL = ["--iteration", "best", "--tto_steps", "3", "--tto_decay_start", "1"]


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


def _run(fn, *args, **kw):
    """fn's return value and what it printed."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args, **kw)
    return out, buf.getvalue()


def _eval_both(tmp, ckpt, argv):
    """Both eval CLIs on copies of ``ckpt``, then both metrics CLIs on
    their outputs: {"jax"/"port": dict(dir, res, printed, metrics, ...)}."""
    out = {}
    for tag in ("jax", "port"):
        shutil.copytree(ckpt, tmp / tag)
        out[tag] = {"dir": str(tmp / tag)}
    recorded = []

    def pallas_tto(*a, **kw):
        tto = _MAKE_TTO(*a, raster_cfg=_JRASTER_CONFIG(backend="pallas"), **kw)

        def run(*b):
            recorded.append(tto(*b))
            return recorded[-1]
        return run

    def jax_scene(**kw):
        kw.pop("device")
        jd, traj = jsyn.generate(**kw)
        return psyn.SceneData(**jd._asdict()), traj

    with pytest.MonkeyPatch.context() as mp:
        for var in ("MOBGS_LPIPS_WEIGHTS", "MOBGS_ALEXNET_WEIGHTS"):
            mp.delenv(var, raising=False)
        mp.setattr(jtto, "make_tto", pallas_tto)
        mp.setattr(psyn, "generate", jax_scene)
        _, out["jax"]["printed"] = _run(jeval.main, argv + ["-m", out["jax"]["dir"]])
        out["jax"]["res"] = recorded[0]
        out["port"]["res"], out["port"]["printed"] = _run(
            peval.main, argv + ["-m", out["port"]["dir"]], device="cpu")
        out["jax"]["metrics"], out["jax"]["metrics_printed"] = _run(
            jmetrics.main, ["-m", out["jax"]["dir"]])
        out["port"]["metrics"], out["port"]["metrics_printed"] = _run(
            pmetrics.main, ["-m", out["port"]["dir"]], device="cpu")
    return out


_MAKE_TTO = jtto.make_tto


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("eval_cli")
    overlay = tmp / "small.py"
    overlay.write_text(OVERLAY)
    ckpt = tmp / "ckpt"
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jrasterize, "RasterConfig", _pallas_raster_config)
        _run(jtrain.main, ["--configs", str(overlay), *TRAIN, "-m", str(ckpt)])
    (tmp / "synthetic").mkdir()
    synthetic = _eval_both(tmp / "synthetic", ckpt,
                           ["--synthetic", "--synthetic_size", SIZE, *EVAL])
    scene = tmp / "stereo_scene"
    make_stereo_fixture(str(scene), V=4)
    (tmp / "stereo").mkdir()
    stereo = _eval_both(tmp / "stereo", ckpt, ["-s", str(scene), "--iteration", "best",
                                                "--tto_steps", "0"])
    synthetic["gt_w2c"] = jsyn.generate(width=48, height=32, num_frames=6)[0].test_w2c
    stereo["gt_w2c"] = jstereo.load_stereo_scene(str(scene)).data.test_w2c
    return {"synthetic": synthetic, "stereo": stereo}


ROUTES = ("synthetic", "stereo")


@pytest.mark.parametrize("route", ROUTES)
def test_eval_cli_writes_the_same_files(runs, route):
    j, p = runs[route]["jax"], runs[route]["port"]
    for name in ("test_refined", "test_gt"):
        assert sorted(os.listdir(os.path.join(p["dir"], name))) == \
            sorted(os.listdir(os.path.join(j["dir"], name)))
    names = sorted(os.listdir(os.path.join(p["dir"], "test_refined")))
    assert names and all(n.endswith(".png.png") for n in names)
    assert "iteration_best not found; using iteration_2" in p["printed"]
    assert "aligned test poses through BLCE" in p["printed"]


@pytest.mark.parametrize("route", ROUTES)
def test_eval_cli_poses_match(runs, route):
    j, p = runs[route]["jax"], runs[route]["port"]
    a = np.load(os.path.join(j["dir"], "solved_poses.npy"))
    b = np.load(os.path.join(p["dir"], "solved_poses.npy"))
    assert a.shape == b.shape and b.shape[1:] == (4, 4)
    np.testing.assert_allclose(b, a, atol=1e-5, rtol=0)
    np.testing.assert_array_equal(b, p["res"].w2c.numpy())


@pytest.mark.parametrize("route", ROUTES)
def test_eval_cli_images_match(runs, route):
    j, p = runs[route]["jax"], runs[route]["port"]
    for name, tol in (("test_refined", 1), ("test_gt", 0)):
        for f in sorted(os.listdir(os.path.join(j["dir"], name))):
            a = np.asarray(Image.open(os.path.join(j["dir"], name, f)), np.int16)
            b = np.asarray(Image.open(os.path.join(p["dir"], name, f)), np.int16)
            assert np.abs(a - b).max() <= tol, (name, f)


def _printed(text, pattern):
    return [float(x) for x in re.search(pattern, text).groups()]


def _rotation_errors(gt_c2w, pred_c2w, pose):
    """The per-pair relative rotation errors that RPE-r reads
    (``pose_metrics.compute_rpe``), as matrices."""
    aligned = pose.align_trajectory_c2w(pred_c2w, gt_c2w)
    out = []
    for i in range(len(gt_c2w) - 1):
        gt_rel = np.linalg.inv(gt_c2w[i]) @ gt_c2w[i + 1]
        pr_rel = np.linalg.inv(aligned[i]) @ aligned[i + 1]
        out.append((np.linalg.inv(gt_rel) @ pr_rel)[:3, :3])
    return np.stack(out)


@pytest.mark.parametrize("route", ROUTES)
def test_eval_cli_psnr_and_pose_report_match(runs, route):
    """PSNR, ATE and RPE-t as stated. RPE-r is an arccos of (trace - 1) / 2,
    which near 0 turns float32 rounding of the poses alone (~1e-7 on the
    trace) into ~0.03 degrees; so its rotation matrices are held at 1e-4
    (products of four poses within 1e-5) and the printed degrees at 0.05."""
    j, p = runs[route]["jax"], runs[route]["port"]
    np.testing.assert_allclose(float(p["res"].psnr.mean()),
                               float(np.mean(np.asarray(j["res"].psnr))), atol=1e-3, rtol=0)
    psnr_re = r"mean PSNR (-?[\d.]+)"
    pose_re = r"pose ATE ([\d.]+)  RPE-t ([\d.]+)  RPE-r ([\d.]+)"
    # the printed values, to their printed digits
    np.testing.assert_allclose(_printed(p["printed"], psnr_re),
                               _printed(j["printed"], psnr_re), atol=0.01 + 1e-3)
    pa, ja = _printed(p["printed"], pose_re), _printed(j["printed"], pose_re)
    np.testing.assert_allclose(pa[:2], ja[:2], atol=1e-4 + 1e-5)
    np.testing.assert_allclose(pa[2], ja[2], atol=0.05)
    # the report's values, from each package's solved poses
    gt = np.linalg.inv(runs[route]["gt_w2c"])
    solved = [np.linalg.inv(np.load(os.path.join(r["dir"], "solved_poses.npy"))) for r in (j, p)]
    a, b = jpose.evaluate_poses(gt, solved[0]), ppose.evaluate_poses(gt, solved[1])
    assert a.keys() == b.keys() and all(np.isfinite(v) for v in b.values())
    for k in ("ate", "rpe_trans"):
        np.testing.assert_allclose(b[k], a[k], atol=1e-5, rtol=0, err_msg=k)
    np.testing.assert_allclose(b["rpe_rot_deg"], a["rpe_rot_deg"], atol=0.05, rtol=0)
    np.testing.assert_allclose(_rotation_errors(gt, solved[1], ppose),
                               _rotation_errors(gt, solved[0], jpose), atol=1e-4, rtol=0)


@pytest.mark.parametrize("route", ROUTES)
def test_metrics_cli_matches(runs, route):
    j, p = runs[route]["jax"], runs[route]["port"]
    a = json.loads(open(os.path.join(j["dir"], "results.json")).read())
    b = json.loads(open(os.path.join(p["dir"], "results.json")).read())
    assert a.keys() == b.keys() and "lpips_randfeat" in b and "lpips" not in b
    assert b["n_frames"] == a["n_frames"] == len(os.listdir(os.path.join(p["dir"], "test_refined")))
    for k, tol in (("psnr", 1e-4), ("ssim", 1e-4), ("lpips_randfeat", 1e-5), ("tof", 1e-3)):
        np.testing.assert_allclose(b[k], a[k], atol=tol, rtol=0, err_msg=k)
    assert all(b[k] == p["metrics"][k] for k in p["metrics"])  # the file is the return value
    for line in ("PSNR: ", "SSIM: ", "LPIPS_RANDFEAT: ", "tOF: ", "# LPIPS backbone: fixed-seed"):
        assert line in p["metrics_printed"] and line in j["metrics_printed"], line
