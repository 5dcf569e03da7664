"""On the card, at the cell's own size: sound runs pass every limit and
the control (the reference in TF32 in the program's place) fails one."""

import pytest

from conftest import load

CELLS = [w["name"] for w in load("BENCHMARK.json")["workloads"]]


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_and_sound_passes(card, cell):
    import importlib
    import run
    _, cfg, mix, limits = run.cell_files(load("BENCHMARK.json"), cell)
    r = importlib.import_module(f"harness.{mix['generator']}").readings(cfg, mix, 9, card)
    assert all(v <= limits[k] for k, v in r["sound"].items()), r
    assert any(v > limits[k] for k, v in r["control"].items()), r
