"""Core math: rotations, spherical harmonics, splines, k-NN."""
from mobgs_tpu_torch.core import image, knn, se3, sh, spline  # noqa: F401
