"""The port's dataset loaders of the registry (``data/dycheck_camera.py``,
``data/iphone.py``, ``data/hypernerf.py``, ``data/scene.py::load_blender_scene``,
``data/panoptic.py``, ``data/colmap.py``, ``data/dynerf.py``,
``data/nvidia.py``) and ``data/scene.py::load_scene``'s sniffing and
dispatch for all seven kinds, against the JAX package's, on the CPU.

Inputs: the fixtures that ``tests/test_data_loaders.py`` (the Nvidia
monocular layout), ``tests/test_iphone_loader.py`` and
``tests/test_panoptic_loader.py`` write, and, where those tests build their
scene inline (Blender, DyNeRF, COLMAP binary, HyperNeRF), writers here with
the same layout, sizes and seeds; a COLMAP text model and iPhone TAPIR tracks
are added to exercise those readers too. Every scene is at most 128x96.

Tolerances, and why: the loaders read the same files with the same numpy
and PIL calls, so every image, depth, mask, camera, time and flow is
bit-equal; the blur features, an FFT ratio (JAX's and torch's FFTs round
differently), at rtol 1e-6, the tolerance of ``tests/test_torch_data.py``.
"""

import json
import os
import struct

import numpy as np
import pytest
import torch
from PIL import Image

from mobgs_tpu.data import colmap as jcolmap
from mobgs_tpu.data import dycheck_camera as jdc
from mobgs_tpu.data import dynerf as jdynerf
from mobgs_tpu.data import hypernerf as jhyper
from mobgs_tpu.data import iphone as jiphone
from mobgs_tpu.data import nvidia as jnvidia
from mobgs_tpu.data import panoptic as jpanoptic
from mobgs_tpu.data import scene as jscene
from mobgs_tpu.data import stereo as jstereo

from mobgs_tpu_torch.data import colmap as pcolmap
from mobgs_tpu_torch.data import dycheck_camera as pdc
from mobgs_tpu_torch.data import dynerf as pdynerf
from mobgs_tpu_torch.data import hypernerf as phyper
from mobgs_tpu_torch.data import iphone as piphone
from mobgs_tpu_torch.data import nvidia as pnvidia
from mobgs_tpu_torch.data import panoptic as ppanoptic
from mobgs_tpu_torch.data import scene as pscene
from mobgs_tpu_torch.data import stereo as pstereo

from test_data_loaders import make_nvidia_mono_fixture
from test_iphone_loader import make_iphone_fixture
from test_panoptic_loader import _write_fixture as write_panoptic_fixture

DATA_FIELDS = ("w2c", "K", "time", "images", "depths", "blur_feats", "masks", "width",
               "height", "max_time", "test_w2c", "test_images", "test_K", "test_time",
               "points_xyz", "points_rgb", "extent")
SCENE_FIELDS = ("tracklet", "track_visibles", "normals", "test_K", "test_time",
                "fwd_flow", "bwd_flow", "fwd_flow_mask", "bwd_flow_mask")
KINDS = ("nvidia_mono", "blender", "iphone", "hypernerf", "dynerf", "colmap",
         "colmap_text", "panoptic")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's side runs on one CPU thread (as in test_torch_loop.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


# ---------------------------------------------------------------------------
# writers for the layouts the JAX tests build inline (same sizes and seeds)


def write_blender(root, n=3, h=32, w=40, with_test=True):
    """``tests/test_data_loaders.py::test_blender_loader``'s scene (RGBA
    frames, extensionless paths, no ``time`` key), plus a test split whose
    frames carry ``time`` and a ``.png`` suffix."""
    os.makedirs(f"{root}/train", exist_ok=True)
    os.makedirs(f"{root}/test", exist_ok=True)
    rng = np.random.default_rng(1)
    for split, count in (("train", n), ("test", 2 if with_test else 0)):
        if not count:
            continue
        frames = []
        for i in range(count):
            img = (rng.uniform(size=(h, w, 4)) * 255).astype(np.uint8)
            Image.fromarray(img).save(f"{root}/{split}/r_{i}.png")
            c2w = np.eye(4)
            c2w[0, 3] = i * 0.1
            c2w[:3, :3] = [[np.cos(0.2 * i), 0, np.sin(0.2 * i)], [0, 1, 0],
                           [-np.sin(0.2 * i), 0, np.cos(0.2 * i)]]
            fr = {"file_path": f"{split}/r_{i}", "transform_matrix": c2w.tolist()}
            if split == "test":
                fr.update(file_path=f"{split}/r_{i}.png", time=0.25 * i)
            frames.append(fr)
        with open(f"{root}/transforms_{split}.json", "w") as f:
            json.dump({"camera_angle_x": 0.7, "frames": frames}, f)


def write_hypernerf(root, n=8, h=40, w=56):
    """``tests/test_iphone_loader.py::test_hypernerf_loader``'s scene."""
    rng = np.random.default_rng(1)
    ids = [f"{i:06d}" for i in range(n)]
    os.makedirs(f"{root}/rgb/2x", exist_ok=True)
    os.makedirs(f"{root}/camera", exist_ok=True)
    os.makedirs(f"{root}/depth/2x", exist_ok=True)
    with open(f"{root}/scene.json", "w") as f:
        json.dump({"near": 0.1, "far": 10, "scale": 0.5, "center": [0, 0, 0]}, f)
    with open(f"{root}/dataset.json", "w") as f:
        json.dump({"ids": ids, "val_ids": [], "train_ids": []}, f)
    with open(f"{root}/metadata.json", "w") as f:
        json.dump({i: {"warp_id": k, "appearance_id": k, "camera_id": 0}
                   for k, i in enumerate(ids)}, f)
    for k, i in enumerate(ids):
        img = (rng.uniform(size=(h, w, 3)) * 255).astype(np.uint8)
        Image.fromarray(img).save(f"{root}/rgb/2x/{i}.png")
        if k == 4:  # one depth prior; the others default to ones
            np.save(f"{root}/depth/2x/{i}.npy", rng.uniform(1, 3, (h, w)).astype(np.float32))
        with open(f"{root}/camera/{i}.json", "w") as f:
            json.dump({"orientation": np.eye(3).tolist(),
                       "position": [0.1 * k, 0, -2.0], "focal_length": 100.0,
                       "principal_point": [w + 3.0, h - 2.0], "skew": 0.5,
                       "image_size": [2 * w, 2 * h]}, f)


def write_dynerf(root, n_cams=3, T=4, h=36, w=48):
    """``tests/test_data_loaders.py::test_dynerf_loader``'s scene."""
    rng = np.random.default_rng(2)
    poses = np.zeros((n_cams, 3, 5))
    for i in range(n_cams):
        poses[i, :, :3] = np.eye(3)
        poses[i, :, 3] = [0.2 * i, 0, 1.0]
        poses[i, :, 4] = [2 * h, 2 * w, 100.0]
    arr = np.concatenate([poses.reshape(n_cams, 15), np.tile([[1.0, 10.0]], (n_cams, 1))], 1)
    os.makedirs(root, exist_ok=True)
    np.save(f"{root}/poses_bounds.npy", arr)
    for c in range(n_cams):
        d = f"{root}/cam{c:02d}/images"
        os.makedirs(d, exist_ok=True)
        for t in range(T):
            img = (rng.uniform(size=(2 * h, 2 * w, 3)) * 255).astype(np.uint8)
            Image.fromarray(img).save(f"{d}/{t:04d}.png")


def write_colmap(root, text=False, n_views=10, h=30, w=40):
    """``tests/test_data_loaders.py::test_colmap_scene_loader``'s scene:
    a PINHOLE camera, 10 views, 5 points; with ``text`` the same model as
    ``cameras.txt`` / ``images.txt`` / ``points3D.txt`` with a SIMPLE_RADIAL
    camera of another size than the images (so the intrinsics rescale)."""
    sparse = os.path.join(root, "sparse", "0")
    os.makedirs(sparse, exist_ok=True)
    os.makedirs(os.path.join(root, "images"), exist_ok=True)
    rng = np.random.default_rng(0)
    quats = [np.array([1.0, 0, 0, 0])] + [
        q / np.linalg.norm(q) for q in rng.normal(size=(n_views - 1, 4))]
    for i in range(n_views):
        Image.fromarray(rng.integers(0, 255, (h, w, 3), dtype=np.uint8)).save(
            os.path.join(root, "images", f"im_{i:03d}.png"))
    if text:
        with open(os.path.join(sparse, "cameras.txt"), "w") as f:
            f.write("# camera list\n")
            f.write(f"1 SIMPLE_RADIAL {2 * w} {2 * h} 70.0 {w} {h} 0.01\n")
        with open(os.path.join(sparse, "images.txt"), "w") as f:
            f.write("# image list\n")
            for i in range(n_views):
                q = " ".join(f"{x:.17g}" for x in quats[i])
                f.write(f"{i + 1} {q} {0.1 * i} 0 2.0 1 im_{i:03d}.png\n\n")
        with open(os.path.join(sparse, "points3D.txt"), "w") as f:
            f.write("# points\n")
            for i in range(5):
                f.write(f"{i} {i * 0.1} 0.2 3.0 10 20 30 0.5\n")
        return
    with open(os.path.join(sparse, "cameras.bin"), "wb") as f:
        f.write(struct.pack("<Q", 1))
        f.write(struct.pack("<iiQQ", 1, 1, w, h))
        f.write(struct.pack("<dddd", 35.0, 36.0, w / 2, h / 2))
    with open(os.path.join(sparse, "images.bin"), "wb") as f:
        f.write(struct.pack("<Q", n_views))
        for i in range(n_views):
            f.write(struct.pack("<i", i + 1))
            f.write(struct.pack("<dddd", *quats[i]))
            f.write(struct.pack("<ddd", 0.1 * i, 0, 2.0))
            f.write(struct.pack("<i", 1))
            f.write(f"im_{i:03d}.png\x00".encode())
            f.write(struct.pack("<Q", 1))
            f.write(struct.pack("<ddq", 1.0, 2.0, -1))
    with open(os.path.join(sparse, "points3D.bin"), "wb") as f:
        f.write(struct.pack("<Q", 5))
        for i in range(5):
            f.write(struct.pack("<Q", i))
            f.write(struct.pack("<ddd", i * 0.1, 0.2, 3.0))
            f.write(struct.pack("<BBB", 10, 20, 30))
            f.write(struct.pack("<d", 0.5))
            f.write(struct.pack("<Q", 1))
            f.write(struct.pack("<ii", 0, 0))


def write_iphone(root, V=3, H=48, W=64):
    """``tests/test_iphone_loader.py``'s fixture, with a motion mask for one
    frame and ``bootstapir/cam0`` tracks (TAPIR's [P, 4] per query and
    target) for ``load_iphone_tracks``."""
    make_iphone_fixture(root, V=V, H=H, W=W)
    rng = np.random.default_rng(4)
    os.makedirs(f"{root}/motion_masks", exist_ok=True)
    m = np.zeros((H, W), np.uint8)
    m[5:20, 10:30] = 200
    Image.fromarray(m).save(f"{root}/motion_masks/0_00001.png")
    os.makedirs(f"{root}/bootstapir/cam0", exist_ok=True)
    for q in range(V):
        for t in range(V):
            tr = np.concatenate([rng.uniform(0, W, (23, 1)), rng.uniform(0, H, (23, 1)),
                                 rng.normal(size=(23, 2)) * 3], 1).astype(np.float32)
            np.save(f"{root}/bootstapir/cam0/{q:05d}_{t:05d}.npy", tr)


WRITERS = {
    "nvidia_mono": make_nvidia_mono_fixture,
    "blender": write_blender,
    "iphone": write_iphone,
    "hypernerf": write_hypernerf,
    "dynerf": write_dynerf,
    "colmap": write_colmap,
    "colmap_text": lambda root: write_colmap(root, text=True),
    "panoptic": write_panoptic_fixture,
}
# (JAX loader, port loader) of each layout, called on the directory
LOADERS = {
    "nvidia_mono": (lambda p: jnvidia.load_nvidia_mono_scene(p).data,
                    lambda p: pnvidia.load_nvidia_mono_scene(p).data),
    "blender": (jscene.load_blender_scene, pscene.load_blender_scene),
    "iphone": (jiphone.load_iphone_scene, piphone.load_iphone_scene),
    "hypernerf": (jhyper.load_hypernerf_scene, phyper.load_hypernerf_scene),
    "dynerf": (lambda p: jdynerf.load_dynerf_scene(p, max_frames=4),
               lambda p: pdynerf.load_dynerf_scene(p, max_frames=4)),
    "colmap": (jcolmap.load_colmap_scene, pcolmap.load_colmap_scene),
    "colmap_text": (jcolmap.load_colmap_scene, pcolmap.load_colmap_scene),
    "panoptic": (jpanoptic.load_panoptic_scene, ppanoptic.load_panoptic_scene),
}
SNIFFED = {"nvidia_mono": "nvidia", "blender": "blender", "iphone": "dycheck",
           "hypernerf": "dycheck", "dynerf": "nvidia", "colmap": "colmap",
           "colmap_text": "colmap", "panoptic": "panoptic"}


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    """Each layout written once, and loaded once by each package."""
    out = {}
    for kind in KINDS:
        root = str(tmp_path_factory.mktemp(kind) / "scene")
        os.makedirs(root, exist_ok=True)
        WRITERS[kind](root)
        jload, pload = LOADERS[kind]
        out[kind] = (root, jload(root), pload(root))
    return out


@pytest.mark.parametrize("kind", KINDS)
def test_loader_scene_data_matches(scenes, kind):
    _, j, p = scenes[kind]
    for field in DATA_FIELDS:
        _same(getattr(j, field), getattr(p, field), field)
    assert np.isfinite(p.blur_feats).all() and p.images.shape[0] == p.w2c.shape[0]


@pytest.mark.parametrize("kind", KINDS)
def test_load_scene_sniffs_and_dispatches(scenes, kind):
    """``sniff_dataset_type`` names the kind as the JAX package does, and
    ``load_scene`` with no kind reaches the layout's own loader (``cam00/``
    turns ``nvidia`` into ``dynerf``, ``splits/`` tells iPhone from
    HyperNeRF, ``images_2/`` the Nvidia monocular layout from stereo)."""
    root, _, p = scenes[kind]
    assert pstereo.sniff_dataset_type(root) == jstereo.sniff_dataset_type(root) == SNIFFED[kind]
    kw = {"max_frames": 4} if kind == "dynerf" else {}
    got, want = pscene.load_scene(root, **kw), jscene.load_scene(root, **kw)
    for field in DATA_FIELDS:
        _same(getattr(p, field), getattr(got, field), field)
        _same(getattr(want, field), getattr(got, field), field)


def test_registry_names_every_kind():
    assert set(pscene.SCENE_LOAD_CALLBACKS) == set(jscene.SCENE_LOAD_CALLBACKS) == {
        "nvidia", "stereo", "blender", "dycheck", "dynerf", "colmap", "panoptic"}


def test_nvidia_mono_stereo_scene_fields_match(scenes):
    root = scenes["nvidia_mono"][0]
    j, p = jnvidia.load_nvidia_mono_scene(root), pnvidia.load_nvidia_mono_scene(root)
    assert type(p) is pstereo.StereoScene
    for field in SCENE_FIELDS:
        _same(getattr(j, field), getattr(p, field), field)
    assert float(np.abs(p.fwd_flow[1]).max()) > 0 and float(p.data.masks[0].max()) == 1.0


def test_nvidia_flow_and_pool_helpers_match(tmp_path):
    rng = np.random.default_rng(5)
    flow = rng.normal(size=(20, 30, 2)).astype(np.float32) * 4
    mask = rng.uniform(size=(20, 30)) > 0.5
    np.savez(tmp_path / "f.npz", flow=flow, mask=mask)
    for out_hw in ((20, 30), (12, 17), (40, 45)):
        for a, b in zip(jnvidia._read_flow(str(tmp_path / "f.npz"), out_hw),
                        pnvidia._read_flow(str(tmp_path / "f.npz"), out_hw)):
            np.testing.assert_array_equal(b, a)
    x = rng.normal(size=(9, 11, 3)).astype(np.float32)
    np.testing.assert_array_equal(pnvidia._avg_pool_5x5(x), jnvidia._avg_pool_5x5(x))


def test_iphone_tracks_match(scenes):
    root = scenes["iphone"][0]
    j, p = jiphone.load_iphone_tracks(root, 3), piphone.load_iphone_tracks(root, 3)
    for a, b in zip(j, p):
        np.testing.assert_array_equal(b, a)
    assert p[0].shape == (3, 3 * 5, 2)
    assert piphone.load_iphone_tracks(scenes["hypernerf"][0], 3) == (None, None)


def test_panoptic_max_views_per_frame_matches(tmp_path):
    root = str(tmp_path / "pan")
    write_panoptic_fixture(root, n_frames=2, n_cams=3)
    j = jpanoptic.load_panoptic_scene(root, max_views_per_frame=1)
    p = pscene.load_scene(root, max_views_per_frame=1)
    for field in DATA_FIELDS:
        _same(getattr(j, field), getattr(p, field), field)
    assert p.images.shape[0] == 2 and p.extent > 0


def test_blender_white_background_and_no_test_split_match(tmp_path):
    root = str(tmp_path / "blender")
    write_blender(root, with_test=False)
    j = jscene.load_blender_scene(root, white_background=True)
    p = pscene.load_blender_scene(root, white_background=True)
    for field in DATA_FIELDS:
        _same(getattr(j, field), getattr(p, field), field)
    assert p.test_images.shape == p.images.shape


def test_colmap_readers_match(scenes):
    for kind in ("colmap", "colmap_text"):
        sparse = os.path.join(scenes[kind][0], "sparse", "0")
        jc, ji, jp = jcolmap.load_colmap_model(sparse)
        pc, pi, pp = pcolmap.load_colmap_model(sparse)
        assert jc.keys() == pc.keys() and ji.keys() == pi.keys()
        for k in jc:
            assert jc[k][:4] == pc[k][:4]
            np.testing.assert_array_equal(pc[k].params, jc[k].params)
            np.testing.assert_array_equal(pcolmap._intrinsics(pc[k]),
                                          jcolmap._intrinsics(jc[k]))
        for k in ji:
            assert (pi[k].id, pi[k].camera_id, pi[k].name) == (ji[k].id, ji[k].camera_id,
                                                               ji[k].name)
            for a, b in ((pi[k].qvec, ji[k].qvec), (pi[k].tvec, ji[k].tvec)):
                np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(pcolmap.qvec_to_rotmat(pi[k].qvec),
                                          jcolmap.qvec_to_rotmat(ji[k].qvec))
        for a, b in zip(pp, jp):
            np.testing.assert_array_equal(a, b)
    assert pcolmap.CAMERA_MODELS == jcolmap.CAMERA_MODELS


def _camera_json(rng, skew=0.0, distort=False):
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    d = {"orientation": q.tolist(), "position": rng.normal(size=3).tolist(),
         "focal_length": 800.0 + 50 * rng.uniform(),
         "principal_point": [371.25, 455.5], "image_size": [720, 960], "skew": skew,
         "pixel_aspect_ratio": 1.0 + 0.01 * rng.uniform()}
    if distort:
        d.update(radial_distortion=[0.1, 0.02, -0.003], tangential_distortion=[0.01, -0.005])
    return d


@pytest.mark.parametrize("variant", ["plain", "skew", "distorted"])
def test_dycheck_camera_methods_match(variant):
    rng = np.random.default_rng(6)
    d = _camera_json(rng, skew=0.0 if variant == "plain" else 1.5,
                     distort=variant == "distorted")
    jcam, pcam = jdc.DycheckCamera.from_json(d), pdc.DycheckCamera.from_json(d)
    pix = rng.uniform(0, 700, size=(5, 7, 2)).astype(np.float32)
    for jc, pc in ((jcam, pcam), (jcam.rescale(2), pcam.rescale(2)),
                   (jcam.rescale(0.5), pcam.rescale(0.5))):
        for name in ("intrin", "extrin", "translation", "image_size", "principal_point"):
            np.testing.assert_array_equal(getattr(pc, name), getattr(jc, name), err_msg=name)
        for name in ("scale_factor_x", "scale_factor_y", "focal_length", "skew"):
            assert getattr(pc, name) == getattr(jc, name), name
        np.testing.assert_array_equal(pc.undistort_pixels(pix), jc.undistort_pixels(pix))
        np.testing.assert_array_equal(pc.pixels_to_rays(pix), jc.pixels_to_rays(pix))
    assert pcam.intrin[0, 1] == d["skew"]


def test_dynerf_frames_for_cam_matches(scenes):
    root = scenes["dynerf"][0]
    for downscale in (1, 2):
        np.testing.assert_array_equal(pdynerf._frames_for_cam(root, "cam01", 3, downscale),
                                      jdynerf._frames_for_cam(root, "cam01", 3, downscale))
