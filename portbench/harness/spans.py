"""Attribution of a profiled stretch to the program's spans
(``mobgs_tpu_torch/utils/observability.py``), and the numbers the span
and counter metrics read.

While a profiler runs, each span of the program is a ``mobgs.<path>``
annotation in the host's timeline, on the device trace's clock. ``events``
reads one export of the trace: the lists ``harness/trace.py::reduce``
reads (``device``, ``host``), each as that module's ``Profiler.events``
gives it, and beside them the annotations and the launches' correlation
ids. ``reduce`` names each idle gap of the device (at its midpoint, as
``trace.reduce`` does) and each kernel, copy and set (at the host time of
the call that launched it) by the innermost span open then on any thread.

A run's layer holds ``spans``: ``tail`` (the program's ``report()`` over
the iterations after the profiled stretch, spans and counters on),
``tail_iters``, ``tail_s`` (their wall time) and ``trace`` (``reduce``'s
output over the profiled stretch). Where the program has no spans, the
layer holds none and every reader of it returns None.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile

PREFIX = "mobgs."
NO_SPAN = "no span"
# stages whose host time partitions an iteration's, with the loop's own
# time (``iteration`` less these); ``render`` is a part of ``forward``
PARTITION = ("iteration/step/forward", "iteration/step/backward", "iteration/step/update",
             "iteration/expo_update", "iteration/budgets", "iteration/densify")
# idle time in these names no stage of the iteration
UNNAMED = ("iteration", NO_SPAN)
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def events(prof) -> dict:
    """The events of ``prof`` (a ``trace.Profiler``, stopped): ``device``
    and ``host`` as ``trace.Profiler.events`` gives them, ``spans`` (start,
    end, path) of each span, ``launch`` {correlation id: host time of the
    call} and ``device_corr`` (start, end, category, correlation id) of each
    device event."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.prof.export_chrome_trace(path)
        with open(path) as f:
            evs = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    return from_trace_events(evs)


def from_trace_events(evs: list) -> dict:
    """``events``' dict from the trace's ``traceEvents``."""
    xs = [e for e in evs if e.get("ph") == "X"]
    dev_cats = ("kernel", "gpu_memcpy", "gpu_memset")

    def ts(e):
        return float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0))

    return dict(
        device=sorted((*ts(e), e["name"], e["cat"]) for e in xs if e.get("cat") in dev_cats),
        host=[(*ts(e), e["name"]) for e in xs if e.get("cat") == "cpu_op"],
        spans=sorted((*ts(e), e["name"][len(PREFIX):]) for e in xs
                     if e.get("cat") == "user_annotation" and e["name"].startswith(PREFIX)),
        launch={e["args"]["correlation"]: float(e["ts"]) for e in xs
                if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {})},
        device_corr=[(*ts(e), e["cat"], e.get("args", {}).get("correlation"))
                     for e in xs if e.get("cat") in dev_cats])


class Timeline:
    """The innermost open span at any host time, over disjoint segments."""

    def __init__(self, spans):
        cuts = sorted({t for s, e, _ in spans for t in (s, e)})
        self.starts, self.names = [], []
        for a, b in zip(cuts, cuts[1:]):
            mid = 0.5 * (a + b)
            inner = max((sp for sp in spans if sp[0] <= mid <= sp[1]),
                        key=lambda sp: (sp[0], -sp[1]), default=None)
            self.starts.append(a)
            self.names.append(inner[2] if inner else NO_SPAN)
        self.end = cuts[-1] if cuts else None

    def at(self, t: float) -> str:
        i = bisect.bisect_right(self.starts, t) - 1
        if i < 0 or t > self.end:
            return NO_SPAN
        return self.names[i]


def reduce(ev: dict, units: int) -> dict:
    """Per span (innermost; ``no span`` outside all): idle seconds, device
    seconds and kernels launched over the profiled stretch of ``units``
    iterations; the top ten by idle (``idle_by_span``), the idle total and
    the unnamed share of it."""
    tl = Timeline(ev["spans"])
    idle, dev_s, kernels = {}, {}, {}
    end = None
    for s, e, _, _ in ev["device"]:
        if end is not None and s > end:
            name = tl.at(0.5 * (s + end))
            idle[name] = idle.get(name, 0.0) + (s - end) * 1e-6
        end = e if end is None else max(end, e)
    for s, e, cat, corr in ev["device_corr"]:
        t = ev["launch"].get(corr)
        name = NO_SPAN if t is None else tl.at(t)
        dev_s[name] = dev_s.get(name, 0.0) + (e - s) * 1e-6
        if cat == "kernel":
            kernels[name] = kernels.get(name, 0) + 1
    idle_s = sum(idle.values())
    unnamed_s = sum(idle.get(n, 0.0) for n in UNNAMED)
    top = sorted(idle.items(), key=lambda kv: -kv[1])[:10]
    return dict(units=units, idle=idle, device_s=dev_s, kernels=kernels, idle_s=idle_s,
                unnamed_s=unnamed_s,
                idle_unnamed_pct=100.0 * unnamed_s / idle_s if idle_s else 0.0,
                idle_by_span=[[n[:160], v] for n, v in top])


def _within(path: str, table: dict) -> float:
    """``table``'s values summed over ``path`` and the spans inside it."""
    return sum(v for p, v in table.items() if p == path or p.startswith(path + "/"))


def stages(sp: dict) -> dict:
    """The info line's table: per span path, host ms an iteration of the
    tail (total) and, over the profiled stretch, kernels launched, device
    ms and idle ms an iteration inside it (the span and the spans it
    holds)."""
    tr, tail, n = sp["trace"], sp["tail"]["spans"], sp["tail_iters"]
    units = tr["units"]
    paths = sorted((set(tail) | set(tr["idle"]) | set(tr["device_s"])) - {NO_SPAN})
    out = {}
    for p in paths:
        out[p] = dict(host_ms=1e3 * tail[p]["total_s"] / n if p in tail else None,
                      launches=_within(p, tr["kernels"]) / units,
                      device_ms=1e3 * _within(p, tr["device_s"]) / units,
                      idle_ms=1e3 * _within(p, tr["idle"]) / units)
    return out


def tail_ms(layer: dict, *paths) -> float | None:
    """Host ms an iteration of the tail in the spans ``paths`` (each
    counted whole; a span the tail never entered counts 0), or None where
    the layer holds no spans."""
    sp = layer.get("spans") if layer.get("kind") == "train" else None
    if not sp:
        return None
    tail = sp["tail"]["spans"]
    return 1e3 * sum(tail[p]["total_s"] for p in paths if p in tail) / sp["tail_iters"]


def counters(layer: dict) -> dict | None:
    """The tail's counters, or None where the layer holds no spans."""
    sp = layer.get("spans") if layer.get("kind") == "train" else None
    return sp["tail"]["counters"] if sp else None
