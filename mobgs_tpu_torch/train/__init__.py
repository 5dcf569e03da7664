"""Training: losses, Adam, densify statistics and the fine-stage step."""
