"""mobgs_tpu_torch — MoBGS in PyTorch with hand-written CUDA kernels for Hopper.

A module-for-module port of the JAX package ``mobgs_tpu``: each module here
keeps the path and the public names of its counterpart, and its tests
(``tests/test_torch_*.py``) hold it against that counterpart. Every module
of the JAX package has its counterpart, in the same subpackages: ``core/``,
``data/``, ``models/``, ``ops/`` (the tile compositor's CUDA kernels in
``csrc/``), ``train/``, ``eval/``, ``io/``, ``cli/``, ``utils/`` and
``parallel/`` (the data x gauss mesh over ``torch.distributed``); only
``ops/raster_jax.py``, the XLA compositor, has none by design. The JAX
package is the reference; nothing here imports it.

Entry points that create tensors take a ``device`` argument. It defaults
to the card (``"cuda"``); asking for the card where none is present raises
instead of running on the CPU. Pass ``device="cpu"`` for the CPU path,
which the tests use.
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless told otherwise.

    Raises RuntimeError for a CUDA device when no card is present — the
    port never falls back to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run on the CPU")
    return dev
