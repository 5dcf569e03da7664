"""LPIPS (AlexNet, v0.1) (port of ``mobgs_tpu/eval/lpips.py``).

Reference: the vendored LPIPS stack at reference ``models/``
(``networks_basic.py:31-96``): torchvision AlexNet conv features at 5
taps → channel-unit-normalize → learned 1x1 linear per tap (weights in
``models/weights/v0.1/alex.pth``) → spatial mean → sum over taps.

Weight sourcing: the learned linear weights load from any LPIPS v0.1
``alex.pth``. The AlexNet *backbone* weights load from a torchvision
``alexnet`` state_dict when one is found on a local path; otherwise the
backbone is a fixed-seed random one, the same numpy draws as the JAX
package's — the metric is then a valid perceptual-style distance but NOT
numerically comparable to published LPIPS numbers (callers label it
``lpips_randfeat``; see eval/metrics.py). Nothing is downloaded.

The convolutions are ``F.conv2d`` calls in full float32 on the card
(``core/image.py::fp32_convolutions``), whatever the process-wide TF32 flag.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from mobgs_tpu_torch import resolve_device
from mobgs_tpu_torch.core.image import fp32_convolutions

# AlexNet feature config: (out_ch, kernel, stride, pad), with taps after
# each ReLU and maxpools between groups, exactly torchvision's layout.
_CONVS = [(64, 11, 4, 2), (192, 5, 1, 2), (384, 3, 1, 1),
          (256, 3, 1, 1), (256, 3, 1, 1)]
_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)


class LPIPSParams(nn.Module):
    """The LPIPS network: 5 AlexNet convolutions and the 5 per-tap lin
    weights, as buffers on one device. ``conv_w`` 5 x [out, in, k, k],
    ``conv_b`` 5 x [out], ``lin_w`` 5 x [C]; ``pretrained_backbone`` says
    whether the convolutions are torchvision's (else the random fallback).
    Calling it is ``lpips_distance``."""

    def __init__(self, conv_w, conv_b, lin_w, pretrained_backbone: bool):
        super().__init__()
        for name, leaves in (("conv_w", conv_w), ("conv_b", conv_b), ("lin_w", lin_w)):
            for i, x in enumerate(leaves):
                self.register_buffer(f"{name}{i}", torch.as_tensor(x, dtype=torch.float32))
        self.pretrained_backbone = bool(pretrained_backbone)

    def _leaves(self, name):
        return tuple(getattr(self, f"{name}{i}") for i in range(len(_CONVS)))

    @property
    def conv_w(self) -> tuple[torch.Tensor, ...]:
        return self._leaves("conv_w")

    @property
    def conv_b(self) -> tuple[torch.Tensor, ...]:
        return self._leaves("conv_b")

    @property
    def lin_w(self) -> tuple[torch.Tensor, ...]:
        return self._leaves("lin_w")

    def forward(self, img0: torch.Tensor, img1: torch.Tensor) -> torch.Tensor:
        return lpips_distance(self, img0, img1)


def _random_backbone(seed: int = 0):
    rng = np.random.default_rng(seed)
    ws, bs = [], []
    cin = 3
    for cout, k, _, _ in _CONVS:
        fan = cin * k * k
        ws.append((rng.normal(size=(cout, cin, k, k)) / np.sqrt(fan)).astype(np.float32))
        bs.append(np.zeros(cout, np.float32))
        cin = cout
    return ws, bs


def find_default_lpips_weights(near: str | None = None) -> str | None:
    """Locate LPIPS v0.1 lin weights (``alex.pth``) without flags.

    Search order: (1) $MOBGS_LPIPS_WEIGHTS, (2) next to the checkpoint
    / results dir being evaluated. The reference always loads its vendored
    ``models/weights/v0.1/alex.pth`` (``models/dist_model.py:61-65``);
    point $MOBGS_LPIPS_WEIGHTS at that file (the JAX package also tries one
    fixed install path of the reference, which the port leaves out).
    """
    import os
    cands = []
    env = os.environ.get("MOBGS_LPIPS_WEIGHTS")
    if env:
        cands.append(env)
    if near:
        cands.append(os.path.join(near, "alex.pth"))
        cands.append(os.path.join(near, "weights", "v0.1", "alex.pth"))
    for c in cands:
        if c and os.path.isfile(c):
            return c
    return None


def find_default_backbone(near: str | None = None) -> str | None:
    """Locate a torchvision alexnet state_dict for the LPIPS backbone.

    Published-comparable LPIPS needs torchvision's ImageNet alexnet
    weights; where they are absent the metric falls back to a fixed-seed
    random backbone (labelled ``lpips_randfeat`` by callers)."""
    import glob
    import os
    cands = []
    env = os.environ.get("MOBGS_ALEXNET_WEIGHTS")
    if env:
        cands.append(env)
    if near:
        cands.append(os.path.join(near, "alexnet.pth"))
    hub = os.path.expanduser("~/.cache/torch/hub/checkpoints")
    cands.extend(sorted(glob.glob(os.path.join(hub, "alexnet*.pth"))))
    for c in cands:
        if c and os.path.isfile(c):
            return c
    return None


def load_lpips(lin_path: str | None = None, backbone_path: str | None = None,
               device: str | torch.device | None = None) -> LPIPSParams:
    """The LPIPS network on ``device`` (the card unless ``"cpu"``)."""
    dev = resolve_device(device)
    if lin_path is not None:
        sd = torch.load(lin_path, map_location="cpu", weights_only=True)
        lin_w = tuple(sd[f"lin{i}.model.1.weight"].reshape(-1) for i in range(5))
    else:
        lin_w = tuple(torch.ones(c[0], dtype=torch.float32) / c[0] for c in _CONVS)

    pretrained = False
    if backbone_path is not None:
        sd = torch.load(backbone_path, map_location="cpu", weights_only=True)
        conv_keys = [k for k in sd if k.startswith("features") and "weight" in k]
        conv_keys = sorted(conv_keys, key=lambda k: int(k.split(".")[1]))
        ws = [sd[k] for k in conv_keys]
        bs = [sd[k.replace("weight", "bias")] for k in conv_keys]
        pretrained = True
    else:
        ws, bs = _random_backbone()
    return LPIPSParams(ws, bs, lin_w, pretrained).to(dev)


def _features(params: LPIPSParams, x: torch.Tensor):
    """x: [B, 3, H, W] in [-1, 1] (LPIPS convention). Returns 5 taps."""
    shift = torch.as_tensor(_SHIFT, device=x.device)[None, :, None, None]
    scale = torch.as_tensor(_SCALE, device=x.device)[None, :, None, None]
    x = (x - shift) / scale
    taps = []
    for i, (_, _, s, p) in enumerate(_CONVS):
        x = torch.relu(F.conv2d(x, params.conv_w[i], stride=s, padding=p)
                       + params.conv_b[i][None, :, None, None])
        taps.append(x)
        if i in (0, 1):
            x = F.max_pool2d(x, kernel_size=3, stride=2)
    return taps


@torch.no_grad()
def lpips_distance(params: LPIPSParams, img0: torch.Tensor,
                   img1: torch.Tensor) -> torch.Tensor:
    """Images [B, 3, H, W] in [-1, 1]. Returns [B] distances."""
    with fp32_convolutions():
        f0 = _features(params, img0)
        f1 = _features(params, img1)
    total = 0.0
    for a, b, w in zip(f0, f1, params.lin_w):
        an = a / torch.clamp(torch.linalg.vector_norm(a, dim=1, keepdim=True), min=1e-10)
        bn = b / torch.clamp(torch.linalg.vector_norm(b, dim=1, keepdim=True), min=1e-10)
        diff = (an - bn) ** 2
        # elementwise, not a matmul: no TF32 whatever the matmul flag says
        weighted = (diff * w[None, :, None, None]).sum(1)
        total = total + torch.mean(weighted, dim=(1, 2))
    return total
