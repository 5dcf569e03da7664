"""The train loop's view sampler (without replacement within an epoch,
``numpy.random.default_rng(seed)``), so the benchmark knows the batch of
every iteration the loop runs."""

from __future__ import annotations

import numpy as np


def batches(num_views: int, batch_size: int, seed: int, upto: int):
    """{iteration: view ids} for iterations 1..upto."""
    rng = np.random.default_rng(seed)
    pool: list = []
    out = {}
    for it in range(1, upto + 1):
        ids = []
        for _ in range(batch_size):
            if not pool:
                pool = list(range(num_views))
            ids.append(pool.pop(int(rng.integers(len(pool)))))
        out[it] = np.asarray(ids, np.int64)
    return out
