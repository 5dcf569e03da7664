"""Command-line entry points: ``python -m mobgs_tpu_torch.cli.train``."""
