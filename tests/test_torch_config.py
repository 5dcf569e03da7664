"""The port's configuration tree (``mobgs_tpu_torch/config.py``) vs the JAX
package's (``mobgs_tpu/config.py``): every dataclass's field names, order
and defaults, and ``load_scene_config`` on every shipped overlay
(``configs/stereo/*.py``), exactly."""

import dataclasses
from pathlib import Path

import pytest

import mobgs_tpu.config as jconfig
import mobgs_tpu_torch.config as pconfig

ROOT = Path(__file__).resolve().parents[1]
CLASSES = ("ModelParams", "PipelineParams", "ModelHiddenParams", "OptimizationParams",
           "BlceParams", "TPUParams", "Config")
OVERLAYS = sorted((ROOT / "configs" / "stereo").glob("*.py"))


def _fields(cls):
    return [(f.name, f.type) for f in dataclasses.fields(cls)]


@pytest.mark.parametrize("name", CLASSES)
def test_dataclass_fields_and_defaults_match(name):
    pcls, jcls = getattr(pconfig, name), getattr(jconfig, name)
    assert _fields(pcls) == _fields(jcls)
    got, want = dataclasses.asdict(pcls()), dataclasses.asdict(jcls())
    assert got == want
    # mutable defaults are built anew for each instance
    if name == "ModelHiddenParams":
        a, b = pcls(), pcls()
        a.multires.append(16)
        assert b.multires == [1, 2, 4, 8]


@pytest.mark.parametrize("path", OVERLAYS, ids=lambda p: p.name)
def test_scene_overlays_load_alike(path):
    got = pconfig.load_scene_config(str(path))
    want = jconfig.load_scene_config(str(path))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    # default.py sets render_process under ModelHiddenParams, which has no
    # such key: both packages drop it, so the panels stay off
    assert got.model.render_process is False
    assert not hasattr(got.hidden, "render_process")


def test_merge_overlay_keeps_known_keys_only():
    overlay = {"OptimizationParams": {"stat_npts": 123, "desicnt": 4, "bogus": 1},
               "blceParams": {"num_warp": 5}, "TPUParams": {"max_per_tile": 512},
               "Unknown": {"x": 1}}
    got = pconfig.merge_overlay(pconfig.Config(), overlay)
    want = jconfig.merge_overlay(jconfig.Config(), overlay)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert (got.opt.stat_npts, got.opt.desicnt, got.blce.num_warp,
            got.tpu.max_per_tile) == (123, 4, 5, 512)
    assert not hasattr(got.opt, "bogus")
