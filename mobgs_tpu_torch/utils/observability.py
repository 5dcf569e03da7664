"""Spans and counters of the training path, debug image grids and seeding.

``span(name)`` marks a stage of the host's work and ``count(name, ...)``
a quantity, both off by default. Off, a span is one flag check that
returns a shared null context and a counter site is one ``if``: nothing is
allocated, launched or synchronised. ``tracing(spans, counters)`` turns
them on for the process:

- a span aggregates, per path (the names of the open spans joined by
  ``/``), its count, its total host time and its self time (total less
  its child spans), by ``time.perf_counter_ns``; while a
  ``torch.profiler`` runs, it also opens ``record_function("mobgs." +
  path)``, so the span sits in the profiler's timeline beside the kernels,
  on the device trace's clock. A span never synchronises: it measures the
  host's time in a stage, and the device's time comes from the trace;
- a counter adds host integers at once and keeps device tensors by
  reference, summed when ``report()`` is taken (outside every span), so
  counting launches no kernel in the iterations it counts.

``report()`` returns ``{"spans": {path: {"n", "total_s", "self_s"}},
"counters": {name: int}}``; ``reset()`` clears both. The state is the
process's, as a profiler's is: one training loop at a time.

The counters the program keeps: ``bin.candidates``, ``bin.valid``,
``bin.kept`` and ``bin.tiles_cut``, once a binning (``ops/tiles.py``);
``render.latent_calls`` and ``render.latent_views``, the train step's
batched latent renders and the views they composite
(``models/render.py::render_latents``: 2 and 16 a step at B=2, E=9);
``render.flow_calls`` and ``render.flow_views``, its batched exposure-flow
passes and the passes they composite (``render_flow_passes``: 2 and 16 a
step at B=2, E=9 with flow on); ``loss.warp_calls`` and
``loss.warp_images``, the flow-warp loss's kernel calls and the warps they
take (``train/losses.py::warp_images`` on CUDA tensors: 2 and 36 a step at
B=2, E=9 with flow on; 0 on the plain route).

``save_debug_grid`` and ``setup_seed`` are the ports of
``main_utils.py:49-92`` and ``train.py:941-947``.
"""

from __future__ import annotations

import contextlib
import functools
import os
import random
import time

import numpy as np
import torch

SPANS = False      # spans record
COUNTING = False   # counter sites count; read as ``if obs.COUNTING:``
# device tensors a counter holds before they are folded into one sum (a
# bound on the memory a long run's counters keep)
FOLD_AT = 4096

_NULL = contextlib.nullcontext()
_resets = 0         # reset() calls so far: a span open across one is dropped
_stack: list = []   # paths of the open spans
_spans: dict = {}   # path -> [n, total ns, ns in child spans]
_host: dict = {}    # counter -> int
_device: dict = {}  # (counter, above) -> [folded sum or None, held tensors]


class _Span:
    __slots__ = ("path", "rf", "t0", "era")

    def __init__(self, name: str):
        self.path = f"{_stack[-1]}/{name}" if _stack else name
        self.rf = None
        self.era = _resets

    def __enter__(self):
        _stack.append(self.path)
        if torch.autograd._profiler_enabled():
            self.rf = torch.profiler.record_function("mobgs." + self.path)
            self.rf.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter_ns() - self.t0
        if self.rf is not None:
            self.rf.__exit__(*exc)
        if _stack and _stack[-1] == self.path:
            _stack.pop()
        if self.era != _resets:
            return False
        agg = _spans.setdefault(self.path, [0, 0, 0])
        agg[0] += 1
        agg[1] += dt
        parent = self.path.rpartition("/")[0]
        if parent:
            _spans.setdefault(parent, [0, 0, 0])[2] += dt
        return False


def span(name: str):
    """A context manager that marks the block as the stage ``name``,
    nested under the spans open around it."""
    if not SPANS:
        return _NULL
    return _Span(name)


def spanned(name: str):
    """Decorator: every call of the function runs in ``span(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return call
    return wrap


def count(name: str, host_int: int | None = None,
          device_tensor: torch.Tensor | None = None,
          above: int | None = None):
    """Add to counter ``name``: a host integer, or the sum of a device
    tensor's elements (with ``above``, the number of its elements above
    that value), kept by reference until ``report()``. Call it under ``if
    COUNTING:``."""
    if host_int is not None:
        _host[name] = _host.get(name, 0) + int(host_int)
    if device_tensor is not None:
        slot = _device.setdefault((name, above), [None, []])
        slot[1].append(device_tensor)
        if len(slot[1]) >= FOLD_AT:
            slot[:] = [_reduce(slot, above), []]


def _reduce(slot: list, above: int | None) -> torch.Tensor:
    """A counter's device value as one int64 tensor: the folded sum so far
    plus the held tensors' sum (with ``above``, their elements above it)."""
    folded, held = slot
    total = torch.zeros((), dtype=torch.int64) if folded is None else folded
    if held:
        x = torch.cat([t.reshape(-1) for t in held])
        total = total.to(x.device) + (x.sum(dtype=torch.int64) if above is None
                                      else (x > above).sum(dtype=torch.int64))
    return total


def tracing(spans: bool = True, counters: bool = False):
    """Turn spans and counters on or off (``tracing(False)``: both off)."""
    global SPANS, COUNTING
    SPANS, COUNTING = bool(spans), bool(counters)


def reset():
    """Clear every span and counter recorded so far; a span open now is not
    recorded when it closes."""
    global _resets
    _resets += 1
    _stack.clear()
    _spans.clear()
    _host.clear()
    _device.clear()


def report() -> dict:
    """What was recorded since the last ``reset()``: per span path its
    count, total and self host seconds; per counter its value (device
    values read here, one read per counter)."""
    spans = {p: dict(n=n, total_s=tot * 1e-9, self_s=(tot - child) * 1e-9)
             for p, (n, tot, child) in sorted(_spans.items()) if n}
    counters = dict(_host)
    for (name, above), slot in _device.items():
        counters[name] = counters.get(name, 0) + int(_reduce(slot, above))
    return dict(spans=spans, counters=dict(sorted(counters.items())))


def save_debug_grid(path: str, images: dict[str, np.ndarray]):
    """A labelled image grid (main_utils.save_debug_imgs): each entry
    [H, W, 3] or [H, W] in [0, 1], tiled horizontally, written as PNG."""
    from PIL import Image
    tiles = []
    for img in images.values():
        img = np.asarray(img)
        if img.ndim == 2:
            img = np.stack([img] * 3, -1)
        tiles.append(np.clip(img, 0, 1))
    grid = np.concatenate(tiles, axis=1)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    Image.fromarray((grid * 255).astype(np.uint8)).save(path)


def setup_seed(seed: int):
    """Deterministic seeding (reference train.py:941-947)."""
    random.seed(seed)
    np.random.seed(seed % (2**32))
    return seed
