"""The port's evaluation modules against the JAX package's, on the CPU:
pose metrics (``eval/pose_metrics.py``), LPIPS (``eval/lpips.py``), the
image metrics (``eval/metrics.py``), camera paths
(``eval/trajectories.py``) and frustum line sets (``eval/cam_viz.py``).

Inputs are made from seeds with numpy: trajectories of 8 cameras, 64x64
image sequences, and a torchvision-layout AlexNet state dict and an LPIPS
``alex.pth`` of lin weights written to a temporary directory and found
through ``MOBGS_ALEXNET_WEIGHTS`` and ``MOBGS_LPIPS_WEIGHTS``.

Tolerances, and why: pose metrics rtol 1e-9 (the same float64 numpy); the
random LPIPS backbone bit-equal (the same numpy draws); LPIPS distances
rtol 1e-5 / atol 1e-6 (float32 convolutions summed in other orders);
PSNR and SSIM atol 1e-5 (float32 means and blurs); tOF atol 1e-4 (OpenCV
on 8-bit frames quantised from images within that float32 noise); camera
paths and frustums atol 1e-6 (float32 quaternion conversions).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mobgs_tpu.eval import cam_viz as jcam
from mobgs_tpu.eval import lpips as jlpips
from mobgs_tpu.eval import metrics as jmetrics
from mobgs_tpu.eval import pose_metrics as jpose
from mobgs_tpu.eval import trajectories as jtraj

from mobgs_tpu_torch.eval import cam_viz as pcam
from mobgs_tpu_torch.eval import lpips as plpips
from mobgs_tpu_torch.eval import metrics as pmetrics
from mobgs_tpu_torch.eval import pose_metrics as ppose
from mobgs_tpu_torch.eval import trajectories as ptraj

LP = dict(rtol=1e-5, atol=1e-6)
# torchvision alexnet: the convolutions' indices in ``features``
ALEX_FEATURES = (0, 3, 6, 8, 10)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's side runs on one CPU thread (as in test_torch_loop.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rot(rng):
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    return q * np.sign(np.linalg.det(q))


def _small_rot(rng, angle=0.02):
    k = rng.normal(size=3)
    k /= np.linalg.norm(k)
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(angle) * K + (1 - np.cos(angle)) * K @ K


def _trajectories(seed=0, n=8):
    """A ground-truth c2w trajectory and a noisy similarity of it."""
    rng = np.random.default_rng(seed)
    R_sim = _rot(rng)
    gt = np.tile(np.eye(4), (n, 1, 1))
    pred = gt.copy()
    for i in range(n):
        gt[i, :3, :3] = _rot(rng)
        gt[i, :3, 3] = rng.normal(size=3) + [0.3 * i, 0, 0]
        pred[i, :3, :3] = _small_rot(rng) @ R_sim @ gt[i, :3, :3]
        pred[i, :3, 3] = (1.7 * R_sim @ gt[i, :3, 3] + [0.2, -0.1, 0.4]
                          + 0.05 * rng.normal(size=3))
    return gt, pred


@pytest.mark.parametrize("align", ["sim3", "se3"])
def test_evaluate_poses_matches(align):
    gt, pred = _trajectories()
    a, b = jpose.evaluate_poses(gt, pred, align=align), ppose.evaluate_poses(gt, pred, align=align)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_allclose(b[k], a[k], rtol=1e-9, atol=0, err_msg=k)
    for x, y in zip(jpose.umeyama(pred[:, :3, 3], gt[:, :3, 3]),
                    ppose.umeyama(pred[:, :3, 3], gt[:, :3, 3])):
        np.testing.assert_allclose(y, x, rtol=1e-9, atol=1e-12)


def test_random_backbone_bit_equal():
    (jw, jb), (pw, pb) = jlpips._random_backbone(), plpips._random_backbone()
    for x, y in zip(jw + jb, pw + pb):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(y, x)
    j, p = jlpips.load_lpips(), plpips.load_lpips(device="cpu")
    assert not p.pretrained_backbone and not j.pretrained_backbone
    for leaf in ("conv_w", "conv_b", "lin_w"):
        for x, y in zip(getattr(j, leaf), getattr(p, leaf)):
            np.testing.assert_array_equal(y.numpy(), np.asarray(x))


@pytest.fixture(scope="module")
def weight_files(tmp_path_factory):
    """A torchvision-layout alexnet state dict and an LPIPS ``alex.pth``,
    written from a seed."""
    tmp = tmp_path_factory.mktemp("lpips")
    rng = np.random.default_rng(7)
    sd, cin = {}, 3
    for idx, (cout, k, _, _) in zip(ALEX_FEATURES, plpips._CONVS):
        sd[f"features.{idx}.weight"] = torch.as_tensor(
            rng.normal(size=(cout, cin, k, k)).astype(np.float32) / np.sqrt(cin * k * k))
        sd[f"features.{idx}.bias"] = torch.as_tensor(
            rng.normal(size=cout).astype(np.float32) * 0.05)
        cin = cout
    sd["classifier.1.weight"] = torch.zeros(4, 9216)  # ignored by the loaders
    torch.save(sd, tmp / "alexnet-owt.pth")
    lin = {f"lin{i}.model.1.weight": torch.as_tensor(
        rng.uniform(0, 0.2, (1, c[0], 1, 1)).astype(np.float32))
        for i, c in enumerate(plpips._CONVS)}
    torch.save(lin, tmp / "alex.pth")
    return str(tmp / "alexnet-owt.pth"), str(tmp / "alex.pth")


@pytest.fixture(scope="module")
def lpips_nets(weight_files):
    """(jax, port) pairs: the random backbone with default lin weights, and
    the written files found through the environment variables."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MOBGS_ALEXNET_WEIGHTS", weight_files[0])
        mp.setenv("MOBGS_LPIPS_WEIGHTS", weight_files[1])
        found = []
        for mod in (jlpips, plpips):
            found.append((mod.find_default_lpips_weights("/nonexistent"),
                          mod.find_default_backbone("/nonexistent")))
    assert found[0] == found[1] == (weight_files[1], weight_files[0])
    lin, backbone = found[1]
    return {"random": (jlpips.load_lpips(), plpips.load_lpips(device="cpu")),
            "state_dict": (jlpips.load_lpips(lin, backbone),
                           plpips.load_lpips(lin, backbone, device="cpu"))}


def test_lpips_state_dicts_load_equally(lpips_nets):
    j, p = lpips_nets["state_dict"]
    assert j.pretrained_backbone and p.pretrained_backbone
    for leaf in ("conv_w", "conv_b", "lin_w"):
        for x, y in zip(getattr(j, leaf), getattr(p, leaf)):
            np.testing.assert_array_equal(y.numpy(), np.asarray(x))


def _pairs(seed=0, n=2, size=64):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0, 1, (n, 3, size, size)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1).astype(np.float32)
    return 2 * a - 1, 2 * b - 1


@pytest.mark.parametrize("backbone", ["random", "state_dict"])
def test_lpips_distance_matches(lpips_nets, backbone):
    j, p = lpips_nets[backbone]
    a, b = _pairs()
    d_j = np.asarray(jlpips.lpips_distance(j, jnp.asarray(a), jnp.asarray(b)))
    d_p = plpips.lpips_distance(p, torch.as_tensor(a), torch.as_tensor(b)).numpy()
    assert d_p.shape == (2,) and (d_p > 0).all()
    np.testing.assert_allclose(d_p, d_j, **LP)
    np.testing.assert_array_equal(p(torch.as_tensor(a), torch.as_tensor(b)).numpy(), d_p)


def _sequence(seed=1, V=4, size=64):
    """A smooth moving pattern and a noisy, shifted prediction of it."""
    rng = np.random.default_rng(seed)
    ys, xs = np.mgrid[0:size, 0:size] / size
    gts = np.stack([np.stack([0.5 + 0.4 * np.sin(6 * xs + 0.3 * v + c) * np.cos(5 * ys - c)
                              for c in range(3)], -1) for v in range(V)])
    preds = np.clip(np.roll(gts, 1, axis=2) + rng.normal(0, 0.03, gts.shape), 0, 1)
    return preds.astype(np.float32), gts.astype(np.float32)


@pytest.mark.parametrize("backbone", ["random", "state_dict"])
def test_evaluate_sequence_matches(lpips_nets, backbone):
    j, p = lpips_nets[backbone]
    preds, gts = _sequence()
    a = jmetrics.evaluate_sequence(preds, gts, lpips_params=j)
    b = pmetrics.evaluate_sequence(preds, gts, lpips_params=p, device="cpu")
    assert a.keys() == b.keys()
    key = "lpips" if backbone == "state_dict" else "lpips_randfeat"
    assert key in b and b["tof"] is not None
    np.testing.assert_allclose(b["per_frame_psnr"], a["per_frame_psnr"], atol=1e-5, rtol=0)
    for k, tol in (("psnr", 1e-5), ("ssim", 1e-5), ("tof", 1e-4)):
        np.testing.assert_allclose(b[k], a[k], atol=tol, rtol=0, err_msg=k)
    np.testing.assert_allclose(b[key], a[key], **LP)


def test_image_helpers_match():
    rng = np.random.default_rng(2)
    for shape in ((64, 64, 3), (72, 100, 3)):
        img = rng.uniform(size=shape).astype(np.float32)
        np.testing.assert_array_equal(pmetrics.crop_8x8(img), jmetrics.crop_8x8(img))
        np.testing.assert_array_equal(pmetrics.to_gray(img), jmetrics.to_gray(img))
    imgs = rng.uniform(size=(4, 48, 64, 3)).astype(np.float32)
    assert pmetrics.tof_pair(*imgs) == jmetrics.tof_pair(*imgs)


def _w2cs(seed=3, n=4):
    rng = np.random.default_rng(seed)
    out = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    for i in range(n):
        out[i, :3, :3] = _rot(rng)
        out[i, :3, 3] = rng.normal(size=3)
    return out


def test_camera_paths_match():
    w2cs = _w2cs()
    np.testing.assert_allclose(ptraj.smooth_camera_path(w2cs, 5),
                               jtraj.smooth_camera_path(w2cs, 5), atol=1e-6, rtol=0)
    lookat = np.array([0.2, -0.1, 4.0], np.float32)
    for fn in ("orbit_path", "lemniscate_path"):
        a = getattr(jtraj, fn)(w2cs[0], lookat, num_frames=12, degree=20.0)
        b = getattr(ptraj, fn)(w2cs[0], lookat, num_frames=12, degree=20.0)
        np.testing.assert_allclose(b, a, atol=1e-6, rtol=0, err_msg=fn)


@pytest.mark.parametrize("coord", ["opengl", "opencv"])
def test_frustums_match(coord, tmp_path):
    w2cs = _w2cs(4)
    for x, y in zip(jcam.camera_frustum(288, 512, 400.0, 410.0, w2cs[1], coord=coord),
                    pcam.camera_frustum(288, 512, 400.0, 410.0, w2cs[1], coord=coord)):
        np.testing.assert_allclose(y, x, atol=1e-6, rtol=0)
    c2ws = np.linalg.inv(w2cs)
    a = jcam.frustums_lineset(c2ws, 288, 512, coord=coord)
    b = pcam.frustums_lineset(c2ws, 288, 512, coord=coord)
    for x, y in zip(a, b):
        np.testing.assert_allclose(y, x, atol=1e-6, rtol=0)
    jcam.save_lineset_ply(str(tmp_path / "j.ply"), *a)
    pcam.save_lineset_ply(str(tmp_path / "p.ply"), *b)
    assert (tmp_path / "p.ply").read_text() == (tmp_path / "j.ply").read_text()
    with pytest.raises(ValueError):
        pcam.camera_frustum(288, 512, 400.0, 410.0, w2cs[1], coord="other")
