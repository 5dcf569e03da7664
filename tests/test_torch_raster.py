"""The port's tile compositor vs the JAX package's.

``composite_tiles_plain`` keeps the Pallas kernels' semantics (chunked
prefix products, T carried between chunks, the chunk-level early exit,
the ``min(α, 1)`` clamp), so it is held against ``composite_tiles_pallas``
run in interpret mode on the CPU, at that suite's tolerance
(``tests/test_pallas_raster.py:38``): image and alpha atol 2e-5 and
rtol 1e-4, depth 1e-3 where α > 1e-3. The differences come from the order
of the products (cumprod vs the Hillis-Steele doubling scan) and of the
channel sums.

The kernel itself is held against the plain version on the card in
``tests/test_torch_gpu.py``.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mobgs_tpu.ops import pallas_raster, raster_jax
from mobgs_tpu.ops import rasterize as jrasterize
from mobgs_tpu.ops import projection as jproj
from mobgs_tpu.ops import reference_raster as jref
from mobgs_tpu.ops import tiles as jtiles

from mobgs_tpu_torch.ops import cuda_raster, projection, rasterize, tiles
from mobgs_tpu_torch.ops import reference_raster

W, H = 64, 48
IMG_TOL = dict(atol=2e-5, rtol=1e-4)
CASES = ("default", "sub", "alpha_only", "image_only")


def t(x):
    return torch.as_tensor(np.array(x))


def port_splats(js):
    return projection.ProjectedSplats(*(t(x) for x in js))


def port_bins(jb):
    return tiles.TileBins(t(jb.gauss_ids), t(jb.counts), jb.n_tiles_x,
                          jb.n_tiles_y, t(jb.max_count))


@pytest.fixture(scope="module")
def scene():
    rng = np.random.default_rng(0)
    n = 300
    means = rng.normal(size=(n, 3)).astype(np.float32)
    means[:, 2] += 6.0
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    scales = np.exp(rng.uniform(-3.5, -1.5, size=(n, 3))).astype(np.float32)
    K = np.array([[60.0, 0, W / 2], [0, 60.0, H / 2], [0, 0, 1]], np.float32)
    js = jproj.project(jnp.asarray(means), jnp.asarray(quats),
                       jnp.asarray(scales), jnp.eye(4), jnp.asarray(K), W, H)
    jb = jtiles.bin_gaussians(js, W, H, tiles_per_gauss=36, max_per_tile=128)
    return dict(
        js=js, jb=jb, ps=port_splats(js), pb=port_bins(jb),
        colors=rng.uniform(size=(n, 9)).astype(np.float32),
        opac=rng.uniform(0.2, 0.95, size=n).astype(np.float32),
        sub=(np.arange(n) % 3 == 0).astype(np.float32),
        bg=np.linspace(0.05, 0.45, 9).astype(np.float32))


def case_args(sc, case):
    """(colors, background, sub_opacities, want_depth, want_alpha)."""
    n = sc["opac"].shape[0]
    if case == "default":
        return sc["colors"], sc["bg"], None, True, True
    if case == "sub":
        return sc["colors"], sc["bg"], sc["opac"] * sc["sub"], True, True
    if case == "alpha_only":
        return np.zeros((n, 0), np.float32), None, None, True, True
    return sc["colors"], None, None, False, False


def compare(port_out, ref_out, depth=True):
    np.testing.assert_allclose(port_out[0].numpy(), np.asarray(ref_out[0]),
                               err_msg="image", **IMG_TOL)
    np.testing.assert_allclose(port_out[1].numpy(), np.asarray(ref_out[1]),
                               err_msg="alpha", **IMG_TOL)
    if depth:
        mask = np.asarray(ref_out[1]) > 1e-3
        np.testing.assert_allclose(port_out[2].numpy()[mask],
                                   np.asarray(ref_out[2])[mask],
                                   atol=1e-3, rtol=1e-3, err_msg="depth")
    if len(ref_out) == 4:
        np.testing.assert_allclose(port_out[3].numpy(), np.asarray(ref_out[3]),
                                   err_msg="sub alpha", **IMG_TOL)


@pytest.mark.parametrize("case", CASES)
def test_plain_matches_pallas(scene, case):
    cols, bg, sub, wd, wa = case_args(scene, case)
    ref = pallas_raster.composite_tiles_pallas(
        scene["jb"], scene["js"], jnp.asarray(cols), jnp.asarray(scene["opac"]),
        W, H, background=None if bg is None else jnp.asarray(bg),
        sub_opacities=None if sub is None else jnp.asarray(sub),
        want_depth=wd, want_alpha=wa)
    out = cuda_raster.composite_tiles(
        scene["pb"], scene["ps"], t(cols), t(scene["opac"]), W, H,
        background=None if bg is None else t(bg),
        sub_opacities=None if sub is None else t(sub),
        want_depth=wd, want_alpha=wa)
    assert len(out) == len(ref)
    compare(out, ref, depth=wd)
    if not wa:
        assert not out[1].any() and not out[2].any()


def _saturating_scene():
    """Full-image splats in two depth layers of 128: the front layer takes
    every pixel's transmittance to ~3e-5 (<= 1e-4), so the tile exits
    after the first chunk; the back layer is bright (colour 20), so
    compositing it anyway (raster_jax: no early exit) shows."""
    n = 256
    rng = np.random.default_rng(1)
    m2d = np.tile(np.array([[W / 2, H / 2]], np.float32), (n, 1))
    conics = np.tile(np.array([[1e-6, 0.0, 1e-6]], np.float32), (n, 1))
    depths = np.concatenate([1.0 + 0.01 * np.arange(128),
                             10.0 + 0.01 * np.arange(128)]).astype(np.float32)
    radii = np.full(n, 100, np.int32)
    opac = np.concatenate([np.full(128, 0.0781), np.full(128, 0.99)]
                          ).astype(np.float32)
    colors = np.concatenate([rng.uniform(size=(128, 3)),
                             np.full((128, 3), 20.0)]).astype(np.float32)
    js = jproj.ProjectedSplats(jnp.asarray(m2d), jnp.asarray(conics),
                               jnp.asarray(depths), jnp.asarray(radii))
    jb = jtiles.bin_gaussians(js, W, H, tiles_per_gauss=16, max_per_tile=256)
    assert int(jb.counts.min()) == 256
    return js, jb, colors, opac


def test_saturating_tiles_exit_early_like_pallas():
    js, jb, colors, opac = _saturating_scene()
    bg = jnp.asarray([0.1, 0.2, 0.3])
    ref = pallas_raster.composite_tiles_pallas(
        jb, js, jnp.asarray(colors), jnp.asarray(opac), W, H, background=bg)
    no_exit = raster_jax.composite_tiles(
        jb, js, jnp.asarray(colors), jnp.asarray(opac), W, H, background=bg,
        tile_chunk=4)
    ps, pb = port_splats(js), port_bins(jb)
    out = cuda_raster.composite_tiles(pb, ps, t(colors), t(opac), W, H,
                                      background=t(np.asarray(bg)))
    compare(out, ref)
    # the early exit fired: raster_jax composites the bright back layer
    assert np.abs(out[0].numpy() - np.asarray(no_exit[0])).max() > 1e-4
    # every tile stopped after its first chunk of 128 slots
    rec = cuda_raster.pack_records(ps, t(opac))
    col = torch.cat([t(colors), ps.depths[:, None], torch.ones(256, 1)], 1)
    work = {}
    cuda_raster.composite_tiles_plain(pb.gauss_ids, pb.counts, rec, col,
                                      pb.n_tiles_x, work=work)
    assert (work["slots"] == 128).all()


def test_bruteforce_oracle_and_plain_match():
    Wb, Hb = 96, 64
    rng = np.random.default_rng(2)
    n = 300
    means = rng.normal(size=(n, 3)).astype(np.float32)
    means[:, 2] += 6.0
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    scales = np.exp(rng.uniform(-3.5, -1.5, size=(n, 3))).astype(np.float32)
    opac = rng.uniform(0.2, 0.95, size=n).astype(np.float32)
    colors = rng.uniform(size=(n, 3)).astype(np.float32)
    K = np.array([[80.0, 0, Wb / 2], [0, 80.0, Hb / 2], [0, 0, 1]], np.float32)
    bg = np.array([0.1, 0.2, 0.3], np.float32)
    viewmat = np.eye(4, dtype=np.float32)

    js = jproj.project(*map(jnp.asarray, (means, quats, scales, viewmat, K)),
                       Wb, Hb)
    ref_j = jref.composite_bruteforce(js, jnp.asarray(colors), jnp.asarray(opac),
                                      Wb, Hb, background=jnp.asarray(bg))
    ps = port_splats(js)
    ref_p = reference_raster.composite_bruteforce(ps, t(colors), t(opac),
                                                  Wb, Hb, background=t(bg))
    compare(ref_p, ref_j)

    out = rasterize.rasterize(
        *map(t, (means, quats, scales, opac, colors, viewmat, K)), Wb, Hb,
        background=t(bg),
        config=rasterize.RasterConfig(tiles_per_gauss=36, max_per_tile=512))
    assert int(out.tile_max) <= 512
    compare((out.images[0], out.alphas[0], out.depths[0]), ref_p)


def test_rasterize_passes_and_alpha_masks(scene):
    """Pass masks are subset renders; the first alpha mask rides the main
    pass as the fused sub chain, later ones composite CE=2; backend
    'plain' and 'auto' agree on CPU tensors; 'cuda' refuses them."""
    rng = np.random.default_rng(3)
    n = 200
    means = rng.normal(size=(n, 3)).astype(np.float32)
    means[:, 2] += 6.0
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    scales = np.exp(rng.uniform(-3.5, -1.5, size=(n, 3))).astype(np.float32)
    opac = rng.uniform(0.2, 0.95, size=n).astype(np.float32)
    colors = rng.uniform(size=(n, 3)).astype(np.float32)
    K = np.array([[60.0, 0, W / 2], [0, 60.0, H / 2], [0, 0, 1]], np.float32)
    args = [*map(t, (means, quats, scales, opac, colors, np.eye(4, dtype=np.float32), K)),
            W, H]
    m = (np.arange(n) % 2 == 0).astype(np.float32)
    cfg = rasterize.RasterConfig(max_per_tile=128)
    both = rasterize.rasterize(*args, pass_masks=t(np.stack([np.ones(n), m])).float(),
                               alpha_masks=t(np.stack([m, 1 - m])).float(),
                               means2d_offset=torch.zeros(n, 2), config=cfg)
    solo = rasterize.rasterize(*args[:3], t(opac * m), *args[4:], config=cfg)
    alpha_only = rasterize.rasterize(*args[:3], t(opac * (1 - m)), *args[4:],
                                     config=cfg)
    np.testing.assert_allclose(both.images[1].numpy(), solo.images[0].numpy(),
                               atol=1e-6)
    np.testing.assert_allclose(both.sub_alphas[0].numpy(),
                               solo.alphas[0].numpy(), atol=1e-6)
    np.testing.assert_allclose(both.sub_alphas[1].numpy(),
                               alpha_only.alphas[0].numpy(), atol=1e-6)
    plain = rasterize.rasterize(*args, config=cfg._replace(backend="plain"))
    np.testing.assert_array_equal(plain.images.numpy(),
                                  rasterize.rasterize(*args, config=cfg).images.numpy())
    with pytest.raises(ValueError, match="cuda"):
        rasterize.rasterize(*args, config=cfg._replace(backend="cuda"))


def test_validate_max_per_tile_matches_jax():
    """The capacity check escalates past a cap that drops visible
    entries, and picks the same budget as the JAX package."""
    rng = np.random.default_rng(4)
    n = 400
    means = rng.normal(size=(n, 3)).astype(np.float32) * 0.3
    means[:, 2] += 6.0
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    scales = np.exp(rng.uniform(-2.5, -1.5, size=(n, 3))).astype(np.float32)
    opac = rng.uniform(0.05, 0.3, size=n).astype(np.float32)
    colors = rng.uniform(size=(n, 3)).astype(np.float32)
    K = np.array([[60.0, 0, W / 2], [0, 60.0, H / 2], [0, 0, 1]], np.float32)
    args = (means, quats, scales, opac, colors, np.eye(4, dtype=np.float32), K)
    budgets = (64, 128, 512)
    got = rasterize.validate_max_per_tile(
        *map(t, args), W, H, rasterize.RasterConfig(max_per_tile=64),
        budgets=budgets)
    want = jrasterize.validate_max_per_tile(
        *map(jnp.asarray, args), W, H,
        jrasterize.RasterConfig(max_per_tile=64, backend="xla", tile_chunk=4),
        budgets=budgets)
    assert got == want and got > 64


def test_compositor_autograd_routes(scene):
    """CPU tensors take the plain route both ways: the forward is
    ``composite_tiles_plain``'s and the backward ``composite_bwd_plain``'s,
    not autograd through the plain forward's ops; the kernels' Function
    refuses CPU tensors instead of falling back."""
    ps, pb = scene["ps"], scene["pb"]
    rec = cuda_raster.pack_records(ps, t(scene["opac"]),
                                   t(scene["opac"] * scene["sub"]))
    col = torch.cat([t(scene["colors"]), ps.depths[:, None],
                     torch.ones(rec.shape[0], 1)], 1).contiguous()
    ids, counts = pb.gauss_ids.to(torch.int32), pb.counts.to(torch.int32)
    ntx = pb.n_tiles_x
    rec.requires_grad_(True)
    col.requires_grad_(True)
    out, out2 = cuda_raster.composite_fwd(ids, counts, rec, col, ntx, sub=True)
    assert type(out.grad_fn).__name__ == "_CompositePlainBackward"
    want = cuda_raster.composite_tiles_plain(ids, counts, rec.detach(),
                                             col.detach(), ntx, sub=True)
    assert torch.equal(out, want[0]) and torch.equal(out2, want[1])
    rng = np.random.default_rng(9)
    g = t(rng.normal(size=out.shape).astype(np.float32))
    g2 = t(rng.normal(size=out2.shape).astype(np.float32))
    got = torch.autograd.grad(torch.sum(out * g) + torch.sum(out2 * g2), (rec, col))
    ref = cuda_raster.composite_bwd_plain(ids, counts, rec.detach(), col.detach(),
                                          out.detach(), out2.detach(), g, g2, ntx,
                                          sub=True)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    assert got[0][:, 6].abs().max() > 0  # the sub chain's opacity column
    with pytest.raises(ValueError, match="not CUDA"):
        cuda_raster._CompositeCuda.apply(ids, counts, rec, col, ntx, False)
    with pytest.raises(ValueError, match="not CUDA"):
        cuda_raster._launch_bwd(ids, counts, rec.detach(), col.detach(),
                                out.detach(), out2.detach(), g, g2, ntx, True)
