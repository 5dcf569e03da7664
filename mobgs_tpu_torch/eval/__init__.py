"""Evaluation: test-pose alignment, test-time pose optimization (TTO),
image metrics (PSNR, SSIM, LPIPS, tOF), pose metrics (ATE, RPE), camera
paths and frustum line sets."""
from mobgs_tpu_torch.eval import lpips, metrics, tto  # noqa: F401
