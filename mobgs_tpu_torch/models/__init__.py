"""Gaussian pools, the Sandwich decoder, rendering."""
from mobgs_tpu_torch.models import blce, gaussians, render, sandwich  # noqa: F401
