"""The render layer's one pipeline over a leading view axis, on the CPU's
plain compositor: ``ops/rasterize.py::rasterize`` over V views against V
one-view calls (every output to the bit, every leaf's gradient within
GRAD_REL of its largest magnitude: the views' gradients are summed in
another order); ``ops/cuda_raster.py::composite_rows`` over a V-view launch
in S contiguous row ranges (``tile0``), whose concatenation is the whole
launch to the bit and whose gradients sum to the whole launch's within
1e-6 of each column's largest magnitude; and the layering: of the render
side only ``ops/rasterize.py`` reads the mesh. Imports no JAX."""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from mobgs_tpu_torch.ops import cuda_raster, projection, tiles
from mobgs_tpu_torch.ops.rasterize import RasterConfig, rasterize

W = H = 64                 # 16 tiles a view
V, N = 3, 300
CFG = RasterConfig(max_per_tile=128, backend="plain")
GRAD_REL = 1e-5
PKG = Path(__file__).resolve().parents[1] / "mobgs_tpu_torch"


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's side runs on one CPU thread: its many small ops gain
    little from more, and beside the suite's other workers a team of
    threads waits on its slowest member at every op."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scene(n_colors=3, seed=0):
    """V views of one cloud: the means moved per view, one camera a view,
    the rest shared; leaves that need a gradient."""
    rng = np.random.default_rng(seed)
    f32 = lambda x: torch.as_tensor(np.asarray(x, np.float32))  # noqa: E731
    base = rng.normal(size=(N, 3))
    base[:, 2] += 6.0
    means = f32(base[None] + 0.2 * rng.normal(size=(V, 1, 3)) * np.arange(V)[:, None, None])
    quats = f32(rng.normal(size=(N, 4)))
    scales = f32(np.exp(rng.uniform(-3.0, -1.5, (N, 3))))
    opac = f32(rng.uniform(0.3, 0.9, (V, N)))
    colors = f32(rng.uniform(size=(N, n_colors)))
    viewmat = f32(np.tile(np.eye(4), (V, 1, 1)))
    viewmat[:, :3, 3] = f32(0.1 * rng.normal(size=(V, 3)))
    K = f32([[70.0, 0, W / 2], [0, 70.0, H / 2], [0, 0, 1]])
    leaves = [x.requires_grad_(True) for x in (means, quats, scales, opac, colors, viewmat)]
    return leaves, K, rng


CASES = {
    "image": dict(want_depth=False, want_alpha=False),
    "depth_alpha_background": dict(background=True, pass_masks=True),
    "extra_columns_sub_chain": dict(n_colors=5, background=True, alpha_masks=True,
                                    flow_to=True, offset=True),
}


def _outputs(out):
    return [x for x in (out.images, out.alphas, out.depths, out.means2d, out.sub_alphas)
            if x is not None]


@pytest.mark.parametrize("case", list(CASES))
def test_rasterize_over_views_equals_one_view_calls(case):
    spec = dict(CASES[case])
    (means, quats, scales, opac, colors, viewmat), K, rng = _scene(spec.pop("n_colors", 3))
    C = colors.shape[1] + (2 if spec.get("flow_to") else 0)
    kw = dict(want_depth=spec.get("want_depth", True), want_alpha=spec.get("want_alpha", True),
              config=CFG)
    if spec.get("background"):
        kw["background"] = torch.as_tensor(rng.uniform(size=C).astype(np.float32))
    if spec.get("pass_masks"):
        kw["pass_masks"] = torch.stack([torch.ones(N), (torch.arange(N) % 2).float()])
    if spec.get("alpha_masks"):
        kw["alpha_masks"] = torch.stack([(torch.arange(N) % 2).float(),
                                         (torch.arange(N) % 3 == 0).float()])
    flow_to = torch.as_tensor(rng.uniform(0, W, (N, 2)).astype(np.float32)) \
        if spec.get("flow_to") else None
    offset = torch.zeros((V, N, 2), requires_grad=True) if spec.get("offset") else None
    leaves = [means, quats, scales, opac, colors, viewmat] + ([offset] if offset is not None
                                                               else [])

    bat = rasterize(means, quats.expand(V, N, 4), scales.expand(V, N, 3), opac,
                    colors.expand(V, N, colors.shape[1]), viewmat, K, W, H,
                    means2d_offset=offset, flow_to=flow_to, **kw)
    one = [rasterize(means[v], quats, scales, opac[v], colors, viewmat[v], K, W, H,
                     means2d_offset=None if offset is None else offset[v],
                     flow_to=flow_to, **kw) for v in range(V)]
    assert bat.images.shape[:2] == (V, 2 if "pass_masks" in kw else 1)
    assert bat.images.shape[-1] == C and float(bat.images.detach().std()) > 0.01
    assert (bat.sub_alphas is None) == ("alpha_masks" not in kw)
    for v, o in enumerate(one):
        for a, b in zip(_outputs(bat), _outputs(o)):
            assert torch.equal(a[v], b), v
        assert torch.equal(bat.radii[v], o.radii)
    assert int(bat.tile_max) == max(int(o.tile_max) for o in one)

    wts = [torch.as_tensor(rng.uniform(size=x.shape).astype(np.float32))
           for x in _outputs(bat)]
    g_bat = torch.autograd.grad(sum((x * w).sum() for x, w in zip(_outputs(bat), wts)),
                                leaves, allow_unused=True)
    g_one = torch.autograd.grad(sum((x * w[v]).sum() for v, o in enumerate(one)
                                    for x, w in zip(_outputs(o), wts)),
                                leaves, allow_unused=True)
    n_checked = 0
    for a, b in zip(g_bat, g_one):
        if b is None or not b.any():
            assert a is None or not a.any()
            continue
        n_checked += 1
        assert float((a - b).abs().max()) / float(b.abs().max()) <= GRAD_REL
    assert n_checked >= (5 if kw["want_alpha"] else 4)


@pytest.mark.parametrize("S", [2, 4])
def test_composite_rows_ranges_concatenate_to_the_launch(S):
    """A launch of V views (V·T = 48 rows, the fused subset chain on) in S
    ranges of 48 / S rows, each with its ``tile0``, as S gauss ranks
    composite it."""
    (means, quats, scales, opac, colors, viewmat), K, rng = _scene()
    splats = projection.project(means, quats.expand(V, N, 4), scales.expand(V, N, 3),
                                viewmat, K, W, H)
    bins = tiles.bin_views(projection.ProjectedSplats(*(x.detach() for x in splats)), W, H,
                           max_per_tile=128)
    cols = colors.expand(V, N, 3)
    sub = opac * (torch.arange(N) % 2).float()
    rows = bins.counts.shape[0]
    assert rows == V * 16 and rows % S == 0

    def launch(b, tile0=0):
        return cuda_raster.composite_rows(b, splats, cols, opac, sub, backend="plain",
                                          tile0=tile0)

    whole = launch(bins)
    m = rows // S
    parts = [launch(bins._replace(gauss_ids=bins.gauss_ids[s * m:(s + 1) * m],
                                  counts=bins.counts[s * m:(s + 1) * m]), s * m)
             for s in range(S)]
    assert torch.equal(torch.cat([p[0] for p in parts]), whole[0])
    assert torch.equal(torch.cat([p[1] for p in parts]), whole[1])
    assert float(whole[0].detach().std()) > 0.01

    g = [torch.as_tensor(rng.normal(size=x.shape).astype(np.float32)) for x in whole]
    leaves = [means, opac, viewmat]
    g_whole = torch.autograd.grad((whole[0] * g[0]).sum() + (whole[1] * g[1]).sum(), leaves,
                                  retain_graph=True)
    g_parts = [torch.autograd.grad((p[0] * g[0][s * m:(s + 1) * m]).sum()
                                   + (p[1] * g[1][s * m:(s + 1) * m]).sum(), leaves,
                                   retain_graph=True)
               for s, p in enumerate(parts)]
    for i, b in enumerate(g_whole):
        a = sum(gp[i] for gp in g_parts)
        assert float((a - b).abs().max()) <= 1e-6 * float(b.abs().max()), i


@pytest.mark.parametrize("module", ["ops/projection.py", "ops/cuda_raster.py",
                                    "ops/tiles.py", "models/render.py"])
def test_render_side_imports_nothing_from_parallel(module):
    """Only ``ops/rasterize.py`` reads the mesh on the render side."""
    names = []
    for node in ast.walk(ast.parse((PKG / module).read_text())):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names += [node.module or ""] + [f"{node.module}.{a.name}" for a in node.names]
    assert names and not [n for n in names if "parallel" in n.split(".")], names
