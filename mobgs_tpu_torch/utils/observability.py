"""Observability: wall-clock timer, run logging, debug image grids and
profiler traces (port of ``mobgs_tpu/utils/observability.py``).

Parity targets: ``utils/timer.py`` (a pause/resume timer that leaves
eval and IO out of the training time), ``helper_train.py:303-309`` (the
exp_log point-count journal), ``main_utils.py:49-92`` (debug image grids)
and TensorBoard-optional scalar logging (``train.py:40-45, 871-934``).
The trace context is ``torch.profiler``'s where the JAX package uses
``jax.profiler``.
"""

from __future__ import annotations

import json
import os
import random
import time
from contextlib import contextmanager

import numpy as np


class Timer:
    """Pause/resume wall-clock timer (reference utils/timer.py:2-24)."""

    def __init__(self):
        self.start_time = None
        self.elapsed = 0.0
        self.paused = False

    def start(self):
        if self.start_time is None or self.paused:
            self.start_time = time.time()
            self.paused = False

    def pause(self):
        if not self.paused and self.start_time is not None:
            self.elapsed += time.time() - self.start_time
            self.paused = True

    def get_elapsed_time(self) -> float:
        if self.paused or self.start_time is None:
            return self.elapsed
        return self.elapsed + (time.time() - self.start_time)


class RunLogger:
    """JSONL scalar logger, plus TensorBoard where it imports.

    Scalars always go to ``<dir>/scalars.jsonl`` (greppable, no
    dependency) and to TensorBoard when ``torch.utils.tensorboard`` loads.
    """

    def __init__(self, log_dir: str):
        self.log_dir = log_dir
        os.makedirs(log_dir, exist_ok=True)
        self._f = open(os.path.join(log_dir, "scalars.jsonl"), "a")
        self.tb = None
        try:
            from torch.utils.tensorboard import SummaryWriter
            self.tb = SummaryWriter(log_dir)
        except ImportError:
            pass

    def scalars(self, step: int, **kv):
        rec = {"step": step, **{k: float(v) for k, v in kv.items()}}
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()
        if self.tb is not None:
            for k, v in kv.items():
                self.tb.add_scalar(k, float(v), step)

    def record_points(self, step: int, note: str, n_points: int):
        """The exp_log journal (helper_train.py:303-309)."""
        with open(os.path.join(self.log_dir, "exp_log.txt"), "a") as f:
            f.write(f"iteration {step} {note} {n_points}\n")

    def close(self):
        self._f.close()
        if self.tb is not None:
            self.tb.close()


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


@contextmanager
def profiler_trace(log_dir: str, enabled: bool = True):
    """A ``torch.profiler`` trace of the block (host and, where there is a
    card, device activity), written to ``<log_dir>/trace.json`` for
    chrome://tracing or Perfetto. Yields the profiler (None when
    disabled), whose ``key_averages()`` give the times by operator."""
    if not enabled:
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield prof
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def setup_seed(seed: int):
    """Deterministic seeding (reference train.py:941-947)."""
    random.seed(seed)
    np.random.seed(seed % (2**32))
    return seed


# ---------------------------------------------------------------------------
# Analytic FLOP model for the train step (MFU / roofline reporting), the
# JAX package's as it is (observability.py:120-160):
#
#   projection: per Gaussian slot, the EWA chain (quat->rotmat,
#     R diag(s^2) R^T, camera transform, Jacobian/cov2d, 2x2 eigen-radii)
#     ~= 300 flops.
#   compositing: per (tile-entry, pixel): conic quadratic + exp + alpha
#     ~= 13, the transmittance prefix ~= 7, channel accumulation 2*C ->
#     (20 + 2*C) flops over P=256 pixels per intersection entry. The
#     backward replays the chain: counted as 2x forward.
#   binning sort: integer key compares, not FLOPs — excluded.
#
# Intersections are the post-clamp per-tile entry counts summed over
# tiles (the compositor is count-bounded, not capacity-bounded).
# ---------------------------------------------------------------------------

def analytic_step_flops(n_intersections: float, cap_total: int,
                        n_passes: int, channels: int = 13,
                        pixels_per_tile: int = 256) -> float:
    """Total train-step FLOPs (fwd+bwd) under the model above.

    Args:
      n_intersections: post-clamp (gaussian, tile) pairs for ONE
        geometry pass (the counts of ops/tiles.bin_gaussians).
      cap_total: total Gaussian slot capacity projected per pass.
      n_passes: geometry passes per step (fwd): batch x exposures.
      channels: composited channel count (9 feat + depth + subset
        alpha columns).
    """
    proj = 300.0 * cap_total
    comp_fwd = float(n_intersections) * pixels_per_tile * (20.0 + 2.0 * channels)
    per_pass_fwd_bwd = 3.0 * (proj + comp_fwd)  # bwd ~= 2x fwd
    return n_passes * per_pass_fwd_bwd
