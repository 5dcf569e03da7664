"""``harness/spans.py`` and the span and counter metrics on synthetic
trace events: idle gaps and kernels named by the innermost span open at
their time, the ``idle_by_span`` and ``stages`` outputs, the trace's lists
as ``harness/trace.py`` reads them, and the readers."""

import importlib.util
import json
import os

import pytest

from conftest import BENCH
from harness import spans as SP
from harness import trace as TR


def _x(cat, name, ts, dur, tid=1, **args):
    return dict(ph="X", cat=cat, name=name, ts=ts, dur=dur, tid=tid, pid=1, args=args)


# host: iteration [0, 100] holds step [10, 60], which holds forward [10, 30]
# and backward [30, 60]; the backward's launch comes from another thread
EVENTS = [
    _x("user_annotation", "mobgs.iteration", 0, 100),
    _x("user_annotation", "mobgs.iteration/step", 10, 50),
    _x("user_annotation", "mobgs.iteration/step/forward", 10, 20),
    _x("user_annotation", "mobgs.iteration/step/backward", 30, 30),
    _x("gpu_user_annotation", "mobgs.iteration/step", 20, 40, tid=7),
    _x("cpu_op", "aten::mul", 11, 3),
    _x("cpu_op", "aten::add", 62, 10),
    _x("cuda_runtime", "cudaLaunchKernel", 12, 1, correlation=1),
    _x("cuda_runtime", "cudaLaunchKernel", 40, 1, tid=2, correlation=2),
    _x("cuda_runtime", "cudaMemcpyAsync", 41, 1, tid=2, correlation=5),
    _x("cuda_runtime", "cudaLaunchKernel", 70, 1, correlation=3),
    _x("cuda_driver", "cuLaunchKernel", 150, 1, correlation=4),
    _x("kernel", "k_fwd", 20, 5, tid=7, correlation=1),
    _x("kernel", "k_bwd", 45, 8, tid=7, correlation=2),
    _x("gpu_memcpy", "Memcpy DtoD", 53, 2, tid=7, correlation=5),
    _x("kernel", "k_loop", 75, 5, tid=7, correlation=3),
    _x("kernel", "k_late", 160, 10, tid=7, correlation=4),
]


class _FakeProfiler:
    """A stopped ``trace.Profiler`` whose export writes ``EVENTS``."""

    class prof:
        @staticmethod
        def export_chrome_trace(path):
            with open(path, "w") as f:
                json.dump({"traceEvents": EVENTS}, f)


def test_events_keep_trace_reduce_as_it_was():
    ev = SP.events(_FakeProfiler)
    want = TR.Profiler.events(_FakeProfiler)
    assert ev["device"] == want["device"] and ev["host"] == want["host"]
    assert TR.reduce(ev, 1.0, 1) == TR.reduce(want, 1.0, 1)
    assert {s[2] for s in ev["spans"]} == {"iteration", "iteration/step",
                                           "iteration/step/forward",
                                           "iteration/step/backward"}


def test_gaps_and_kernels_go_to_the_innermost_span():
    sp = SP.reduce(SP.from_trace_events(EVENTS), units=2)
    # gaps: 25-45 (mid 35: backward), 55-75 (mid 65: iteration), 80-160
    # (mid 120: none)
    assert sp["idle"] == pytest.approx({"iteration/step/backward": 20e-6,
                                        "iteration": 20e-6, SP.NO_SPAN: 80e-6})
    assert sp["idle_by_span"][0] == [SP.NO_SPAN, pytest.approx(80e-6)]
    assert [n for n, _ in sp["idle_by_span"]][1:] in (
        ["iteration/step/backward", "iteration"], ["iteration", "iteration/step/backward"])
    assert sp["idle_unnamed_pct"] == pytest.approx(100.0 * 100 / 120)
    assert sp["kernels"] == {"iteration/step/forward": 1, "iteration/step/backward": 1,
                             "iteration": 1, SP.NO_SPAN: 1}
    assert sp["device_s"] == pytest.approx({"iteration/step/forward": 5e-6,
                                            "iteration/step/backward": 10e-6,
                                            "iteration": 5e-6, SP.NO_SPAN: 10e-6})


TAIL = {"spans": {"iteration": dict(n=4, total_s=0.400, self_s=0.02),
                  "iteration/step": dict(n=4, total_s=0.300, self_s=0.01),
                  "iteration/step/forward": dict(n=4, total_s=0.120, self_s=0.04),
                  "iteration/step/forward/render": dict(n=64, total_s=0.080, self_s=0.08),
                  "iteration/step/backward": dict(n=4, total_s=0.140, self_s=0.14),
                  "iteration/step/update": dict(n=4, total_s=0.030, self_s=0.03),
                  "iteration/budgets": dict(n=4, total_s=0.004, self_s=0.004),
                  "iteration/densify": dict(n=4, total_s=0.016, self_s=0.016),
                  "eval": dict(n=4, total_s=0.001, self_s=0.001)},
        "counters": {"bin.candidates": 1000, "bin.valid": 400, "bin.kept": 390,
                     "bin.tiles_cut": 3}}


def _layer():
    trace = SP.reduce(SP.from_trace_events(EVENTS), units=2)
    return dict(kind="train", spans=dict(tail=TAIL, tail_iters=4, tail_s=0.41, trace=trace))


def test_stages_hold_what_their_spans_hold():
    st = SP.stages(_layer()["spans"])
    assert SP.NO_SPAN not in st
    assert st["iteration"]["host_ms"] == pytest.approx(100.0)
    assert st["iteration"]["launches"] == 1.5  # three of four kernels, two iterations
    assert st["iteration/step"]["launches"] == 1.0
    assert st["iteration/step"]["idle_ms"] == pytest.approx(1e3 * 20e-6 / 2)
    assert st["iteration/step/backward"]["device_ms"] == pytest.approx(1e3 * 10e-6 / 2)
    assert st["eval"]["launches"] == 0


def _reader(name):
    spec = importlib.util.spec_from_file_location(
        "m", os.path.join(BENCH, "metrics", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


WANT = {"train.forward_host_ms": 30.0, "train.render_host_ms": 20.0,
        "train.backward_host_ms": 35.0, "train.update_host_ms": 7.5,
        "train.expo_update_ms": 0.0, "train.boundary_ms": 5.0,
        "train.loop_self_ms": 22.5, "train.idle_unnamed_pct": 100.0 * 100 / 120,
        "train.bin_valid_pct": 40.0, "train.tile_cut_pct": 2.5}


@pytest.mark.parametrize("name", sorted(WANT))
def test_span_readers(name):
    read = _reader(name)
    assert read(_layer()) == pytest.approx(WANT[name])
    # a run whose program records no spans: nothing to read
    assert read(dict(kind="train", trace={}, unit_s=0.3)) is None


def test_host_metrics_partition_the_iteration():
    layer = _layer()
    parts = [_reader(n)(layer) for n in WANT
             if n.endswith("_ms") and n != "train.render_host_ms"]
    assert sum(parts) == pytest.approx(1e3 * TAIL["spans"]["iteration"]["total_s"] / 4)
