"""Carrying weights across from the JAX package."""
from mobgs_tpu_torch.io import ply  # noqa: F401
