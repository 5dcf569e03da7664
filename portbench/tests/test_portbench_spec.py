"""``BENCHMARK.json`` against the benchmark's contract, and every cell's
files found by name."""

import importlib
import importlib.util
import os
import re

import pytest

from conftest import BENCH, ROOT, load

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
bench = load("BENCHMARK.json")
E2E = {m["name"]: m for m in bench["end_to_end"]}
CELLS = [w["name"] for w in bench["workloads"]]


def line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_command():
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= len(bench["paths"]) <= 16
    for p in bench["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert not p.endswith("_torch")
    assert 1 <= len(bench["command"]) <= 32 and all(line(w) for w in bench["command"])
    files = [w for w in bench["command"] if w.endswith(".py")]
    assert files and all(any(f.startswith(p + "/") for p in bench["paths"]) for f in files)
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_run_seconds_fits_the_full_check():
    rs = bench["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_entries():
    seen = set()
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and line(c["source"]) and line(c["why"])
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
        assert c["file"].startswith("portbench/") and os.path.exists(os.path.join(ROOT, c["file"]))
        assert load(c["file"])["name"] == c["name"]
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and line(w["why"])
        assert w["chips"] in (1, 4)
        assert w["config"] in {c["name"] for c in bench["configs"]}
    pairs = [(w["config"], w["traffic"]) for w in bench["workloads"]]
    assert len(set(pairs)) == len(pairs)
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["name"] not in seen
        seen.add(m["name"])
        assert set(m.get("workloads", [])) <= set(CELLS)
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert E2E["setup_s"]["bound"] == 0.25 and "workloads" not in E2E["setup_s"]
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert line(m["layer"]) and m["moves"] in E2E
        moved = E2E[m["moves"]].get("workloads", CELLS)
        assert set(m.get("workloads", CELLS)) <= set(moved)
        if m["name"].endswith("_roofline_pct") or "mfu" in m["name"]:
            assert m["unit"] == "%"


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_reports_what_it_must(cell):
    e2e = [m for m in bench["end_to_end"] if cell in m.get("workloads", CELLS)]
    assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
    assert any(cell in m.get("workloads", CELLS) for m in bench["per_layer"])


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found_by_name(cell):
    import run
    _, cfg, mix, limits = run.cell_files(bench, cell)
    gen = importlib.import_module(f"harness.{mix['generator']}")
    assert callable(gen.run) and callable(gen.readings)
    assert limits and all(isinstance(v, float) for v in limits.values())
    assert cfg["OptimizationParams"] and cfg["scene"]["width"] == 512


READERS = sorted(f[:-3] for f in os.listdir(os.path.join(BENCH, "metrics")) if f.endswith(".py"))


def test_every_per_layer_metric_has_a_reader():
    assert {m["name"] for m in bench["per_layer"]} <= set(READERS)


@pytest.mark.parametrize("metric", READERS)
def test_metric_readers_found_by_name(metric):
    path = os.path.join(BENCH, "metrics", f"{metric}.py")
    spec = importlib.util.spec_from_file_location("m", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.read({}) is None  # nothing to read: nothing returned


def test_run_names_no_cell():
    with open(os.path.join(BENCH, "run.py")) as f:
        src = f.read()
    names = (CELLS + [c["name"] for c in bench["configs"]]
             + [w["traffic"] for w in bench["workloads"]] + [m["name"] for m in bench["per_layer"]])
    assert not [n for n in names if re.search(rf"\b{re.escape(n)}\b", src)]
