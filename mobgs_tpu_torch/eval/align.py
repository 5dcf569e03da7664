"""Test-pose alignment through the BLCE-refined training poses (port of
``mobgs_tpu/eval/align.py``).

Reference ``train.py:746-764``: before evaluating, each test camera is
re-expressed relative to the refined mid-exposure latent pose of its
paired training view,

    aligned_test_w2c = w2c_train_mid_refined · w2c_train_in⁻¹ · w2c_test_in
"""

from __future__ import annotations

import torch

from mobgs_tpu_torch.core import se3
from mobgs_tpu_torch.models import blce as B


@torch.no_grad()
def align_test_poses(blce_state: B.BLCEState, train_w2c: torch.Tensor,
                     test_w2c: torch.Tensor, blur_feats: torch.Tensor,
                     num_warp: int = 9) -> torch.Tensor:
    """Align every test pose; tensors stacked over views [V, ...], on the
    BLCE state's device. Returns [V, 4, 4]. Test view i is paired with train
    view i, so the two splits must hold as many views (the JAX package's
    ``vmap`` over both raises ValueError otherwise, as this does)."""
    if test_w2c.shape[0] != train_w2c.shape[0]:
        raise ValueError(f"align_test_poses pairs test view i with train view i: "
                         f"{train_w2c.shape[0]} train views, {test_w2c.shape[0]} test views")
    half = num_warp // 2
    out = []
    for idx in range(train_w2c.shape[0]):
        c2w = se3.view_to_world(train_w2c[idx])
        lat_c2w, _ = B.latent_poses(blce_state, c2w, blur_feats[idx], idx, num_warp)
        mid_w2c = se3.view_to_world(lat_c2w[half])
        out.append(mid_w2c @ c2w @ test_w2c[idx])
    return torch.stack(out)
