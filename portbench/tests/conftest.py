"""Shared set-up of the benchmark's tests: the harness on the import path,
the ``gpu`` marker, and tiny CPU versions of the cells."""

import copy
import json
import os
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH)
for p in (ROOT, BENCH):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line("markers", "gpu: needs a CUDA card; skips without one")


def load(rel):
    with open(os.path.join(ROOT, rel)) as f:
        return json.load(f)


@pytest.fixture
def card():
    """The CUDA device, or a skip where there is none."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    return torch.device("cuda", 0)


@pytest.fixture
def cpu_run(monkeypatch):
    """Run a generator on the CPU: the card-only calls become no-ops and
    the kernels' build is skipped (CPU tensors composite through the
    program's plain route)."""
    import torch
    from mobgs_tpu_torch.ops import cuda_raster
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a, **k: 0)
    monkeypatch.setattr(torch.cuda, "reset_peak_memory_stats", lambda *a, **k: None)
    monkeypatch.setattr(cuda_raster, "build_kernels", lambda *a, **k: {})
    return torch.device("cpu")


# the viewer mix's limit in these tests: it has no cell (and no limits
# file) while the program's dead slots can crowd its tiles (PERF.md)
VIEW_LIMITS = {"image_gap": 1e-5}


def tiny(workload):
    """(configuration, mix, limits) of a cell, cut to a CPU test's size:
    64x48, 6 frames, a few hundred seeds. ``seesaw.view`` is the viewer
    mix on the seesaw configuration."""
    bench = load("BENCHMARK.json")
    if workload == "seesaw.view":
        cell, limits = dict(config="seesaw", traffic="view"), VIEW_LIMITS
    else:
        cell = {w["name"]: w for w in bench["workloads"]}[workload]
        limits = load(f"portbench/limits/{workload}.json")
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    cfg = copy.deepcopy(load(conf["file"]))
    cfg["scene"].update(width=64, height=48, frames=6)
    cfg["OptimizationParams"].update(stat_npts=300, dyn_npts=80)
    mix = load(f"portbench/traffic/{cell['traffic']}.json")
    if "pools" in mix:
        mix["pools"] = dict(stat_live=1200, stat_capacity=1400, dyn_live=150, dyn_capacity=200)
    mix.update(warm_until=mix.get("start_iter", 0) + 2, timed_iters=1, traced_iters=1,
               traced_requests=2, warm_requests=1, sample=2)
    return cfg, mix, limits
