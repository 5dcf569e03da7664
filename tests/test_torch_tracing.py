"""The port's spans and counters (``utils/observability.py``) on the CPU:
off, the training loop records nothing; on, it records exactly the spans
of its stages, with their counts and nesting, and trains bit for bit as
with them off; the tile binning's counters equal a direct count of its
entries, for one view and summed over the views of ``bin_views``; and under ``torch.profiler`` each span is
a ``mobgs.*`` annotation of the trace."""

import numpy as np
import pytest
import torch

from mobgs_tpu_torch.config import BlceParams, OptimizationParams
from mobgs_tpu_torch.data import synthetic
from mobgs_tpu_torch.data.cameras import Camera
from mobgs_tpu_torch.models import blce as B
from mobgs_tpu_torch.models import gaussians as G
from mobgs_tpu_torch.models import render as R
from mobgs_tpu_torch.models.sandwich import init_sandwich
from mobgs_tpu_torch.ops import tiles
from mobgs_tpu_torch.ops.projection import ProjectedSplats
from mobgs_tpu_torch.ops.rasterize import RasterConfig
from mobgs_tpu_torch.train import loop as L
from mobgs_tpu_torch.train.step import init_train_state
from mobgs_tpu_torch.utils import observability as obs

W, H, V, E, BATCH = 48, 32, 6, 3, 2
# iterations 9 and 10: the latents on, the exposure update at 10
FIRST, LAST = 9, 10
CFG = RasterConfig(tiles_per_gauss=64, max_per_tile=512, tile_chunk=6)
STAGES = {"iteration", "iteration/batch", "iteration/step", "iteration/step/forward",
          "iteration/step/forward/render", "iteration/step/backward",
          "iteration/step/update", "iteration/expo_update",
          "iteration/expo_update/render", "iteration/budgets", "iteration/densify",
          "iteration/read", "eval", "debug", "checkpoint"}


@pytest.fixture(autouse=True)
def tracing_off():
    """Each test starts and ends with tracing off and nothing recorded."""
    obs.tracing(False)
    obs.reset()
    yield
    obs.tracing(False)
    obs.reset()


@pytest.fixture(scope="module")
def scene():
    data, traj = synthetic.generate(width=W, height=H, num_frames=V, n_static=300,
                                    n_dyn=60, blur_substeps=2, device="cpu")
    return data, synthetic.init_point_clouds(data, traj, 200, 60)


def _state(scene):
    """A fresh state (the loop trains it in place), at step FIRST - 1."""
    data, (s_pts, s_cols, d_traj) = scene
    gen = torch.Generator().manual_seed(7)
    stat = G.create_state(s_pts, s_cols, np.zeros(len(s_pts), np.float32), 300,
                          generator=gen, device="cpu")
    dyn = G.create_state(d_traj[:, 0], np.full((len(d_traj), 3), 0.5, np.float32),
                         np.zeros(len(d_traj), np.float32), 80,
                         trajectory=torch.as_tensor(d_traj),
                         traj_times=torch.as_tensor(data.time), device="cpu")
    ts = init_train_state(stat, dyn, init_sandwich(gen, device="cpu"),
                          B.init_blce(gen, num_views=V, view_dim=8, num_warp=E,
                                      device="cpu"))
    return ts._replace(step=FIRST - 1)


def _train(scene):
    data = scene[0]
    opt = OptimizationParams(iterations=100, batch_size=BATCH, lambda_flow_loss=0.0)
    blce = BlceParams(view_dim=8, num_warp=E, start_warp_exposure=5)
    hooks = dict(eval_every=1, on_eval=lambda ts, it: None,
                 debug_every=1, on_debug=lambda ts, it: None,
                 checkpoint_every=1, on_checkpoint=lambda ts, it, h: None)
    return L.train(_state(scene), data, opt, blce, iterations=LAST, raster_cfg=CFG,
                   scene_extent=6.0, seed=3, log_every=1, start_iter=FIRST,
                   device="cpu", **hooks)


def _leaves(ts):
    return [x for grp in (G.split_diff(ts.stat)[0], G.split_diff(ts.dyn)[0],
                          ts.blce.params.leaves(), (ts.blce.exposure_expo,))
            for x in grp]


def test_loop_spans_off_on_and_bit_equal(scene):
    ts_off, hist_off = _train(scene)
    assert obs.report() == {"spans": {}, "counters": {}}

    obs.tracing(spans=True, counters=True)
    ts_on, hist_on = _train(scene)
    rep = obs.report()
    obs.tracing(False)

    assert [h["loss"] for h in hist_on] == [h["loss"] for h in hist_off]
    for a, b in zip(_leaves(ts_on), _leaves(ts_off)):
        assert torch.equal(a, b)

    spans, n_it = rep["spans"], LAST - FIRST + 1
    assert set(spans) == STAGES
    # per batch view the batched latent renders and the mid render
    want_n = {"iteration/step/forward/render": BATCH * 2 * n_it,
              "iteration/expo_update": 1, "iteration/expo_update/render": 2 * BATCH}
    for path, s in spans.items():
        assert s["n"] == want_n.get(path, n_it), path
        assert 0.0 <= s["self_s"] <= s["total_s"]
    # a parent's time holds its children's
    for path, s in spans.items():
        kids = [c for c in spans if c.rpartition("/")[0] == path]
        assert sum(spans[c]["total_s"] for c in kids) <= s["total_s"] - s["self_s"] + 1e-6
    c = rep["counters"]
    assert set(c) == {"bin.candidates", "bin.valid", "bin.kept", "bin.tiles_cut",
                      "render.latent_calls", "render.latent_views"}
    assert 0 < c["bin.kept"] <= c["bin.valid"] <= c["bin.candidates"]
    assert (c["render.latent_calls"], c["render.latent_views"]) == (
        BATCH * n_it, BATCH * (E - 1) * n_it)


def test_nested_render_calls_take_longer_paths(scene):
    ts = _state(scene)
    data = scene[0]
    cam = Camera(w2c=torch.as_tensor(data.w2c[0]), K=torch.as_tensor(data.K[0]),
                 time=torch.as_tensor(data.time[0]))
    obs.tracing(spans=True)
    with obs.span("step"), obs.span("render"):
        R.project_combined(ts.stat, ts.dyn, cam, W, H, data.max_time, None, CFG)
    spans = obs.report()["spans"]
    assert set(spans) == {"step", "step/render", "step/render/render"}
    assert spans["step/render/render"]["n"] == 1


def _splats(n, seed):
    g = torch.Generator().manual_seed(seed)
    radii = torch.randint(0, 30, (n,), generator=g, dtype=torch.int32)
    radii[: n // 8] = 0  # culled splats: entries that are not valid
    return ProjectedSplats(
        means2d=torch.rand(n, 2, generator=g) * torch.tensor([float(W), float(H)]),
        conics=torch.rand(n, 3, generator=g), depths=1.0 + torch.rand(n, generator=g),
        radii=radii)


def _direct(splats, tpg, K):
    _, _, _, counts, _, _ = tiles._expand_sort(splats, W, H, tpg)
    return counts


@pytest.mark.parametrize("route", ["bin_gaussians", "bin_views"])
def test_bin_counters_match_a_direct_count(route):
    """One binning's counters, and those of a binning of two views, each
    view's own (``bin_views``): the per-view sums."""
    tpg, K, n = 16, 24, 500
    views = [_splats(n, 1), _splats(n, 2)] if route == "bin_views" else [_splats(n, 1)]
    counts = torch.stack([_direct(sp, tpg, K) for sp in views])
    obs.tracing(spans=False, counters=True)
    if route == "bin_views":
        tiles.bin_views(ProjectedSplats(*(torch.stack(x) for x in zip(*views))), W, H, tpg, K)
    else:
        tiles.bin_gaussians(views[0], W, H, tpg, K)
    c = obs.report()["counters"]
    assert c["bin.candidates"] == len(views) * n * tpg
    assert c["bin.valid"] == int(counts.sum())
    assert c["bin.kept"] == int(counts.clamp(max=K).sum())
    assert c["bin.tiles_cut"] == int((counts > K).sum())
    assert 0 < c["bin.tiles_cut"] and c["bin.valid"] < c["bin.candidates"]


def test_counter_folds_keep_the_sum(monkeypatch):
    monkeypatch.setattr(obs, "FOLD_AT", 3)
    xs = [torch.arange(i, i + 4, dtype=torch.int32) for i in range(7)]
    for x in xs:
        obs.count("c", device_tensor=x)
        obs.count("c_above", device_tensor=x, above=5)
    obs.count("c", host_int=11)
    c = obs.report()["counters"]
    allx = torch.cat(xs)
    assert c["c"] == int(allx.sum()) + 11 and c["c_above"] == int((allx > 5).sum())


def test_spans_are_profiler_annotations():
    from torch.profiler import ProfilerActivity, profile
    obs.tracing(spans=True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with obs.span("outer"):
            with obs.span("inner"):
                torch.ones(8).sum()
    names = {e.name for e in prof.events()}
    assert {"mobgs.outer", "mobgs.outer/inner"} <= names


def test_train_cli_writes_spans_json(tmp_path):
    """``--trace_spans``: the run's spans and counters in ``spans.json``
    beside ``history.json``, the eval's stall under its own name, and
    tracing off after the run."""
    import json
    import os
    from mobgs_tpu_torch.cli import train as cli
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    overlay = tmp_path / "small.py"
    overlay.write_text(
        f"_base_ = {os.path.join(root, 'configs', 'stereo', 'seesaw.py')!r}\n"
        "ModelHiddenParams = dict(kplanes_config={'grid_dimensions': 2, "
        "'input_coordinate_dim': 4, 'output_coordinate_dim': 4, "
        "'resolution': [8, 8, 8, 4]}, multires=[1], net_width=16, "
        "timenet_width=8, timenet_output=8)\n")
    out = tmp_path / "out"
    cli.main(["--configs", str(overlay), "--synthetic", "--synthetic_size", "48x32x6",
              "--num_warp", "3", "--quiet", "--iterations", "2", "--test_iterations", "2",
              "--trace_spans", "-m", str(out)], device="cpu")
    rep = json.loads((out / "spans.json").read_text())
    assert (out / "history.json").exists() and not obs.SPANS and not obs.COUNTING
    assert rep["spans"]["iteration"]["n"] == 2 and rep["spans"]["eval"]["n"] == 1
    assert {"eval/render", "iteration/step/forward/render"} <= set(rep["spans"])
    assert rep["counters"]["bin.valid"] > 0


def test_a_span_open_across_a_reset_is_dropped():
    obs.tracing(spans=True)
    with obs.span("old"):
        obs.reset()
        with obs.span("new"):
            pass
    assert set(obs.report()["spans"]) == {"new"}


def test_span_is_exception_safe():
    obs.tracing(spans=True)
    with pytest.raises(ValueError):
        with obs.span("a"):
            with obs.span("b"):
                raise ValueError
    with obs.span("c"):
        pass
    assert set(obs.report()["spans"]) == {"a", "a/b", "c"}
