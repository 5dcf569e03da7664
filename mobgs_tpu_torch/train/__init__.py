"""Training: losses, Adam, densify statistics and the fine-stage step."""
from mobgs_tpu_torch.train import densify, loop, losses, optim, step  # noqa: F401
