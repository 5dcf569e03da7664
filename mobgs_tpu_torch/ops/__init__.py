"""Projection, binning, and the tile compositor with its CUDA kernel."""
from mobgs_tpu_torch.ops import projection, rasterize, reference_raster, tiles  # noqa: F401
