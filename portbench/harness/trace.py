"""Reduction of a ``torch.profiler`` trace of the device to the numbers the
per-layer metrics read: kernels launched, device busy time, the
compositor's device time, the longest device operations and the idle gaps
by what the host was doing."""

from __future__ import annotations

import bisect
import contextlib
import json
import os
import tempfile


class Profiler:
    """Profiles the host's and the device's activity between ``start`` and
    ``stop``; ``events`` then reads the trace's events."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile
        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])

    def start(self):
        self.prof.start()

    def stop(self):
        self.prof.stop()

    def events(self) -> dict:
        """``device``: (start, end, name, category) of each kernel, copy and
        set, in time order; ``host``: (start, end, name) of each operator."""
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.remove(path)
        return dict(
            device=sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)), e["name"],
                           e["cat"]) for e in events if e.get("ph") == "X"
                          and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")),
            host=[(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)), e["name"])
                  for e in events if e.get("ph") == "X" and e.get("cat") == "cpu_op"])


@contextlib.contextmanager
def profiled():
    """Profile the block's host and device activity. Yields a dict that
    holds, once the block has closed, the trace's events."""
    p, out = Profiler(), {}
    p.start()
    yield out
    p.stop()
    out.update(p.events())


def reduce(events: dict, window_s: float, units: int, raster=("raster_fwd", "raster_bwd")):
    """The trace's numbers: ``kernels`` (launched), ``busy_s`` (the union
    of device activity), ``raster_s`` (device time of the compositor's
    kernels), ``window_s``, ``units`` (iterations or requests traced) and
    the ``breakdown``."""
    dev = events["device"]
    busy, end = 0.0, None
    for s, e, _, _ in dev:
        if end is None or s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    by_name: dict = {}
    for s, e, name, cat in dev:
        by_name[name] = by_name.get(name, 0.0) + (e - s) * 1e-6
    kernels = sum(1 for d in dev if d[3] == "kernel")
    raster_s = sum((e - s) * 1e-6 for s, e, name, cat in dev if any(r in name for r in raster))
    # the host's outermost operators, disjoint and in time order
    outer, last_end = [], None
    for hs, he, hn in sorted(events["host"], key=lambda h: (h[0], -h[1])):
        if last_end is None or hs >= last_end:
            outer.append((hs, he, hn))
            last_end = he
        elif he > last_end:
            last_end = he
    starts = [h[0] for h in outer]
    gaps: dict = {}
    end = None
    for s, e, _, _ in dev:
        if end is not None and s > end:
            mid = 0.5 * (s + end)
            i = bisect.bisect_right(starts, mid) - 1
            name = outer[i][2] if i >= 0 and outer[i][1] >= mid else "host: no operator"
            gaps[name] = gaps.get(name, 0.0) + (s - end) * 1e-6
        end = e if end is None else max(end, e)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:10]
    return dict(kernels=kernels, busy_s=busy * 1e-6, raster_s=raster_s, window_s=window_s,
                units=units, breakdown=dict(device_ops=[[n[:160], v] for n, v in top],
                                            idle_gaps=[[n[:160], v] for n, v in idle]))
