"""Share of the device's idle time in the profiled stretch that falls in
no stage of the iteration: in the span ``iteration`` itself or in no span
(``harness/spans.py``: each gap named by the innermost span open at its
midpoint)."""


def read(layer):
    sp = layer.get("spans") if layer.get("kind") == "train" else None
    return sp["trace"]["idle_unnamed_pct"] if sp else None
