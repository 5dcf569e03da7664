"""The port's serving slice vs the JAX package: ``render_view`` with the
JAX state carried across by ``io/from_jax.py``, the synthetic generator,
and the SIBR viewer bridge.

The JAX side renders through its Pallas kernels in interpret mode
(``RasterConfig(backend="pallas")``), whose semantics the port's plain
composite keeps; the decoded image is compared at atol 1e-4. The JAX
generator on the CPU renders through ``raster_jax`` (no early exit, no
alpha clamp), compared at atol 1e-4.
"""

import json
import socket
import struct
import threading
import time

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mobgs_tpu.data import cameras as jcam
from mobgs_tpu.data import synthetic as jsyn
from mobgs_tpu.models import gaussians as jG
from mobgs_tpu.models import render as jR
from mobgs_tpu.models import sandwich as jsand
from mobgs_tpu.ops import projection as jprojection
from mobgs_tpu.ops.rasterize import RasterConfig as JRasterConfig

from mobgs_tpu_torch.data import cameras, synthetic
from mobgs_tpu_torch.io import from_jax
from mobgs_tpu_torch.models import render as R
from mobgs_tpu_torch.ops import projection
from mobgs_tpu_torch.ops.rasterize import RasterConfig
from mobgs_tpu_torch.viewer import ViewerServer, make_viewer_render

W, H = 64, 48
KMAT = np.array([[60.0, 0, W / 2], [0, 60.0, H / 2], [0, 0, 1]], np.float32)
CFG = RasterConfig(tile_chunk=4, max_per_tile=128)
JCFG = JRasterConfig(tile_chunk=4, max_per_tile=128, backend="pallas")
ATOL = 1e-4


def _fields(nt):
    return {f: np.asarray(getattr(nt, f)) for f in nt._fields}


@pytest.fixture(scope="module")
def scene():
    rng = np.random.default_rng(0)

    def cloud(n):
        pts = rng.normal(size=(n, 3)).astype(np.float32)
        pts[:, 2] += 6.0
        cols = rng.uniform(size=(n, 3)).astype(np.float32)
        return jnp.asarray(pts), jnp.asarray(cols), jnp.zeros(n)

    stat = jG.create_state(*cloud(200), 256, rng=jax.random.PRNGKey(0))
    dp, dc, dt = cloud(100)
    times = jnp.linspace(0, 1, 16)
    vel = jnp.asarray(rng.normal(size=(100, 3)).astype(np.float32) * 0.3)
    dyn = jG.create_state(dp, dc, dt, 128,
                          trajectory=dp[:, None] + vel[:, None] * times[None, :, None],
                          traj_times=times)
    # some time-linear features and angular velocity, so the dynamic
    # accessors do real work
    dyn = dyn._replace(
        omega=jnp.asarray(rng.normal(size=(128, 4)).astype(np.float32) * 0.1),
        features_t=jnp.asarray(rng.normal(size=(128, 3)).astype(np.float32)))
    sw = jsand.init_sandwich(jax.random.PRNGKey(1))
    return dict(
        j=(stat, dyn, sw),
        p=(from_jax.gaussian_state_from_numpy(_fields(stat), device="cpu"),
           from_jax.gaussian_state_from_numpy(_fields(dyn), device="cpu"),
           from_jax.sandwich_from_numpy(_fields(sw), device="cpu")))


def _cams(t=0.5):
    w2c = np.eye(4, dtype=np.float32)
    w2c[:3, 3] = [0.05, -0.1, 0.2]
    return (jcam.Camera(jnp.asarray(w2c), jnp.asarray(KMAT), jnp.float32(t)),
            cameras.Camera(torch.as_tensor(w2c), torch.as_tensor(KMAT),
                           torch.tensor(t)))


FLAGS = {
    "default": dict(),
    "subsets": dict(get_dynamic=True, get_static=True),
    "subset_alpha_only": dict(get_dynamic=True, get_static=True,
                              subset_alpha_only=True),
}


@pytest.mark.parametrize("name", list(FLAGS))
def test_render_view_matches_jax(scene, name):
    flags = FLAGS[name]
    jc, pc = _cams()
    bg3 = np.array([0.1, 0.2, 0.3], np.float32)
    jo = jR.render_view(*scene["j"][:3], jc, W, H, jnp.asarray(bg3),
                        max_time=1.0, config=JCFG, **flags)
    with torch.no_grad():
        po = R.render_view(*scene["p"], pc, W, H, torch.as_tensor(bg3),
                           max_time=1.0, config=CFG, **flags)
    assert float(jo.alpha.max()) > 0.5  # the view sees the scene
    for field in ("image", "alpha", "depth", "d_image", "d_alpha", "s_image",
                  "s_alpha", "feat"):
        a, b = getattr(po, field), getattr(jo, field)
        assert (a is None) == (b is None), field
        if a is None:
            continue
        if field == "depth":
            m = np.asarray(jo.alpha) > 1e-3
            np.testing.assert_allclose(a.numpy()[m], np.asarray(b)[m],
                                       atol=1e-3, rtol=1e-3, err_msg=field)
        else:
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL,
                                       err_msg=field)
    np.testing.assert_array_equal(po.radii.numpy(), np.asarray(jo.radii))
    assert int(po.tile_max) == int(jo.tile_max)


def test_assembly_and_projection_with_exposure_shift_match(scene):
    """The assembled set at an exposure-shifted time and its projection;
    the dynamic rows' projection alone; the combined set's ``means2d``."""
    jc, pc = _cams(0.9)
    jg = jR.assemble(*scene["j"][:2], jc.time, 4.0, 0.6)
    pg = R.assemble(*scene["p"][:2], pc.time, 4.0, 0.6)
    for a, b in zip(pg, jg):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   atol=1e-5, rtol=1e-5)

    def jproj(m, q, s):
        return jprojection.project(m, q, s, jc.w2c, jc.K, W, H).means2d

    def pproj(m, q, s):
        return projection.project(m, q, s, pc.w2c, pc.K, W, H).means2d.detach().numpy()

    np.testing.assert_allclose(pproj(pg.means, pg.quats, pg.scales),
                               np.asarray(jproj(jg.means, jg.quats, jg.scales)),
                               atol=1e-4, rtol=1e-5)
    jd = jR.assemble_dyn(scene["j"][1], jc.time, 4.0, 0.6)
    pd = R.assemble_dyn(scene["p"][1], pc.time, 4.0, 0.6)
    np.testing.assert_allclose(pproj(*pd[:3]), np.asarray(jproj(*jd[:3])),
                               atol=1e-4, rtol=1e-5)
    np.testing.assert_allclose(
        R.project_combined(*scene["p"][:2], pc, W, H, 4.0).detach().numpy(),
        np.asarray(jR.project_combined(*scene["j"][:2], jc, W, H, 4.0)),
        atol=1e-4, rtol=1e-5)


def test_synthetic_generator_matches_jax():
    kw = dict(width=W, height=H, num_frames=4, n_static=600, n_dyn=150,
              blur_substeps=3, seed=3)
    jd, jtraj = jsyn.generate(**kw)
    pd, ptraj = synthetic.generate(**kw, device="cpu")
    np.testing.assert_array_equal(ptraj, jtraj)
    for f in ("images", "test_images", "blur_feats", "masks", "w2c", "K",
              "time", "test_w2c"):
        np.testing.assert_allclose(getattr(pd, f), getattr(jd, f), atol=ATOL,
                                   err_msg=f)
    hit = jd.depths > 0.1
    np.testing.assert_allclose(pd.depths[hit], jd.depths[hit], atol=ATOL,
                               rtol=1e-5)
    assert (pd.width, pd.height, pd.max_time) == (jd.width, jd.height,
                                                  jd.max_time)
    s_p, c_p, t_p = synthetic.init_point_clouds(jd, jtraj, 500, 100)
    s_j, c_j, t_j = jsyn.init_point_clouds(jd, jtraj, 500, 100)
    for a, b in ((s_p, s_j), (c_p, c_j), (t_p, t_j)):
        np.testing.assert_array_equal(a, b)


def sibr_request(sock, w2c, width, height):
    """One SIBR camera message: the inverse of the server's view-matrix
    flip (``viewer.py:70-74``), then read the RGB bytes and the verify
    string."""
    view = np.array(w2c, np.float32).T.copy()
    view[:, 1] *= -1
    view[:, 2] *= -1
    msg = json.dumps({"resolution_x": width, "resolution_y": height,
                      "train": True, "keep_alive": False,
                      "view_matrix": view.reshape(-1).tolist()}).encode()
    sock.sendall(struct.pack("<I", len(msg)) + msg)

    def recv_exact(n):
        buf = b""
        while len(buf) < n:
            chunk = sock.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("server closed")
            buf += chunk
        return buf

    img = recv_exact(width * height * 3)
    n = struct.unpack("<I", recv_exact(4))[0]
    return img, recv_exact(n).decode("ascii")


def test_viewer_round_trip(scene):
    stat, dyn, sw = scene["p"]
    render_fn = make_viewer_render(stat, dyn, sw, KMAT, W, H, 1.0, config=CFG)
    server = ViewerServer(port=0)
    w2cs = [np.eye(4, dtype=np.float32) for _ in range(2)]
    w2cs[1][:3, 3] = [0.3, 0.0, -0.5]
    replies = []

    def client():
        with socket.create_connection(("127.0.0.1", server.port), timeout=60) as s:
            for w2c in w2cs:
                replies.append(sibr_request(s, w2c, W, H))

    th = threading.Thread(target=client)
    th.start()
    try:
        deadline = time.time() + 60
        while len(replies) < len(w2cs) and time.time() < deadline:
            server.poll(render_fn, verify="scene")
            time.sleep(0.01)
        th.join(timeout=10)
        assert not th.is_alive()
    finally:
        server.close()
    assert len(replies) == 2
    for (img, verify), w2c in zip(replies, w2cs):
        assert verify == "scene" and len(img) == H * W * 3
        with torch.no_grad():
            out = R.render_view(stat, dyn, sw, cameras.Camera(
                torch.as_tensor(w2c), torch.as_tensor(KMAT), torch.tensor(0.5)),
                W, H, torch.zeros(3), 1.0, config=CFG)
        want = (np.clip(out.image.numpy(), 0, 1) * 255).astype(np.uint8)
        assert img == want.tobytes()
