"""Host-side batch sampling (port of ``mobgs_tpu/train/loop.py:30-96``).
The training loop itself (densify, exposure updates, checkpoints) comes
with the host-loop slice."""

from __future__ import annotations

import numpy as np
import torch

from mobgs_tpu_torch import resolve_device
from mobgs_tpu_torch.data.synthetic import SceneData
from mobgs_tpu_torch.train.step import Batch


class BatchSampler:
    """Without-replacement view sampler (train.py:330-350 semantics). A
    numpy generator, so a seed gives the JAX package's view ids."""

    def __init__(self, num_views: int, batch_size: int, seed: int = 0):
        self.num_views = num_views
        self.batch_size = batch_size
        self.rng = np.random.default_rng(seed)
        self.pool: list[int] = []

    def next_ids(self) -> np.ndarray:
        ids = []
        for _ in range(self.batch_size):
            if not self.pool:
                self.pool = list(range(self.num_views))
            j = self.rng.integers(len(self.pool))
            ids.append(self.pool.pop(j))
        return np.asarray(ids, np.int64)


def make_batch(data: SceneData, ids: np.ndarray, device=None) -> Batch:
    """The views ``ids`` of ``data`` as a Batch on ``device``."""
    dev = resolve_device(device)

    def on(x, dtype=torch.float32):
        return torch.as_tensor(np.asarray(x), dtype=dtype).to(dev)

    return Batch(view_idx=on(ids, torch.int64), w2c=on(data.w2c[ids]),
                 K=on(data.K[ids]), time=on(data.time[ids]),
                 image=on(data.images[ids]), depth=on(data.depths[ids]),
                 blur_feat=on(data.blur_feats[ids]))
