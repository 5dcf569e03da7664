"""The port's gsplat shim (``mobgs_tpu_torch/compat.py``) vs the JAX
package's.

The same Gaussians, made from a seed with numpy, go through JAX
``compat.rasterization`` with ``RasterConfig(backend="pallas")`` (the Pallas
kernels in interpret mode on the CPU) and through the port's, whose CPU
tensors composite through the kernels' plain versions. Forward at atol 2e-5
/ rtol 1e-4 (depth where α > 1e-3 at rtol 1e-3), gradients at atol 3e-4 /
rtol 2e-3 (``tests/test_pallas_raster.py``'s tolerances). One JAX compile a
render mode.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mobgs_tpu import compat as jcompat
from mobgs_tpu.ops.rasterize import RasterConfig as JRasterConfig

from mobgs_tpu_torch import compat
from mobgs_tpu_torch.ops.rasterize import RasterConfig

W, H = 64, 48
N = 200
IMG_TOL = dict(atol=2e-5, rtol=1e-4)
GRAD_TOL = dict(atol=3e-4, rtol=2e-3)
JCFG = JRasterConfig(max_per_tile=128, backend="pallas")
CFG = RasterConfig(max_per_tile=128)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def t(x):
    return torch.as_tensor(np.array(x))


def scene(C):
    rng = np.random.default_rng(C)
    means = rng.normal(size=(N, 3)).astype(np.float32)
    means[:, 2] += 6.0
    return dict(
        means=means, quats=rng.normal(size=(N, 4)).astype(np.float32),
        scales=np.exp(rng.uniform(-3.0, -1.5, (N, 3))).astype(np.float32),
        opacities=rng.uniform(0.3, 0.9, N).astype(np.float32),
        colors=rng.uniform(size=(N, C)).astype(np.float32),
        viewmats=np.eye(4, dtype=np.float32)[None],
        Ks=np.array([[[60.0, 0, W / 2], [0, 60.0, H / 2], [0, 0, 1]]], np.float32),
        backgrounds=np.linspace(0.1, 0.4, C, dtype=np.float32)[None],
        g_img=rng.normal(size=(1, H, W, C + 1)).astype(np.float32),
        g_alpha=rng.normal(size=(1, H, W, 1)).astype(np.float32))


DIFF = ("means", "quats", "scales", "opacities", "colors")


@pytest.mark.parametrize("C,mode", [(3, "RGB+ED"), (9, "RGB"), (1, "RGB+ED"),
                                    (2, "RGB")])
def test_rasterization_matches_jax(C, mode):
    sc = scene(C)
    ce = C + 1 if mode == "RGB+ED" else C
    g_img = sc["g_img"][..., :ce]

    def jloss(means, quats, scales, opacities, colors):
        img, alpha, info = jcompat.rasterization(
            means, quats, scales, opacities, colors, jnp.asarray(sc["viewmats"]),
            jnp.asarray(sc["Ks"]), W, H, backgrounds=jnp.asarray(sc["backgrounds"]),
            render_mode=mode, config=JCFG)
        # depth enters where it is defined (the images' test below)
        if mode == "RGB+ED":
            img = img.at[..., -1].set(jnp.where(alpha[..., 0] > 1e-3, img[..., -1], 0.0))
        return jnp.sum(img * g_img) + jnp.sum(alpha * sc["g_alpha"]), (img, alpha, info)

    jargs = [jnp.asarray(sc[k]) for k in DIFF]
    (_, (jimg, jalpha, jinfo)), jgrads = jax.jit(jax.value_and_grad(
        jloss, argnums=tuple(range(5)), has_aux=True))(*jargs)

    leaves = [t(sc[k]).requires_grad_(True) for k in DIFF]
    img, alpha, info = compat.rasterization(
        *leaves, t(sc["viewmats"]), t(sc["Ks"]), W, H,
        backgrounds=t(sc["backgrounds"]), render_mode=mode, config=CFG)
    assert img.shape == (1, H, W, ce) and alpha.shape == (1, H, W, 1)
    assert info["means2d"].shape == (1, N, 2) and info["radii"].shape == (1, N)
    np.testing.assert_array_equal(info["radii"].numpy(), np.asarray(jinfo["radii"]))
    np.testing.assert_allclose(info["means2d"].detach().numpy(),
                               np.asarray(jinfo["means2d"]), atol=1e-4, rtol=1e-5)
    np.testing.assert_allclose(alpha.detach().numpy(), np.asarray(jalpha), **IMG_TOL)
    np.testing.assert_allclose(img[..., :C].detach().numpy(),
                               np.asarray(jimg[..., :C]), **IMG_TOL)
    if mode == "RGB+ED":
        m = np.asarray(jalpha)[..., 0] > 1e-3
        assert m.sum() > 100
        np.testing.assert_allclose(img[..., -1].detach().numpy()[m],
                                   np.asarray(jimg[..., -1])[m], rtol=1e-3)
        img = torch.cat([img[..., :-1], torch.where(alpha > 1e-3, img[..., -1:],
                                                    torch.zeros_like(alpha))], -1)
    loss = torch.sum(img * t(g_img)) + torch.sum(alpha * t(sc["g_alpha"]))
    grads = torch.autograd.grad(loss, leaves)
    for name, a, b in zip(DIFF, grads, jgrads):
        b = np.asarray(b)
        assert np.abs(b).max() > 0, name
        np.testing.assert_allclose(a.numpy(), b, err_msg=name, **GRAD_TOL)


def test_fully_fused_projection_matches_jax():
    sc = scene(3)
    jr = jax.jit(lambda m, q, s, v, k: jcompat.fully_fused_projection(
        m, None, q, s, v, k, W, H, config=JCFG))(
        *(jnp.asarray(sc[k]) for k in ("means", "quats", "scales", "viewmats", "Ks")))
    pr = compat.fully_fused_projection(
        t(sc["means"]), None, t(sc["quats"]), t(sc["scales"]), t(sc["viewmats"]),
        t(sc["Ks"]), W, H, config=CFG)
    assert len(pr) == 5 and pr[4] is None and jr[4] is None
    np.testing.assert_array_equal(pr[0].numpy(), np.asarray(jr[0]))
    for a, b in zip(pr[1:4], jr[1:4]):
        assert a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("bad", ["packed", "two_cameras", "render_mode", "channels",
                                 "covars"])
def test_shim_rejects_what_the_reference_does_not_use(bad):
    sc = scene(3)
    args = [t(sc[k]) for k in DIFF]
    cams = dict(viewmats=t(sc["viewmats"]), Ks=t(sc["Ks"]), width=W, height=H)
    if bad == "covars":
        with pytest.raises(ValueError):
            compat.fully_fused_projection(args[0], torch.zeros(N, 3, 3), args[1],
                                          args[2], **cams)
        return
    kw = {}
    if bad == "packed":
        kw["packed"] = True
    elif bad == "two_cameras":
        cams["viewmats"] = cams["viewmats"].expand(2, 4, 4)
        cams["Ks"] = cams["Ks"].expand(2, 3, 3)
    elif bad == "render_mode":
        kw["render_mode"] = "D"
    else:
        args[4] = torch.zeros(N, 4)
    err = NotImplementedError if bad == "render_mode" else ValueError
    with pytest.raises(err):
        compat.rasterization(*args, **cams, **kw)
