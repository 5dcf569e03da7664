"""Cameras and the synthetic scene generator."""
from mobgs_tpu_torch.data import cameras, synthetic  # noqa: F401
