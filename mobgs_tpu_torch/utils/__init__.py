"""Spans and counters of the training path, debug image grids and seeding."""
from mobgs_tpu_torch.utils import observability  # noqa: F401
