"""Timers, run logging, debug image grids and profiler traces."""
from mobgs_tpu_torch.utils import observability  # noqa: F401
