"""Blur-aware latent camera estimation (port of ``mobgs_tpu/models/blce.py``).

A per-view neural-ODE pose model predicts ``num_warp`` latent sharp camera
poses inside the exposure window of each blurry training frame; the latent
renders average into the synthetic blurry image the loss compares with the
frame. As in the JAX package, every per-view module of the reference is one
leading ``[V, ...]`` axis of a stacked parameter, indexed by view id; the
Euler integration over integer timesteps (``torchdiffeq.odeint`` with
``method='euler'`` in the reference) is a Python loop of ``num_warp - 1``
unit steps.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from mobgs_tpu_torch import resolve_device
from mobgs_tpu_torch.core import se3

NUM_FREQS = 10  # blur-feature positional encoding (blce.py:334)

BLCE_FIELDS = ("view_embed", "bf_w0", "bf_b0", "bf_w1", "bf_b1", "bf_w2",
               "bf_b2", "rt_w", "rt_b", "venc_w", "venc_b", "time_embed",
               "w_lin_w", "w_lin_b", "v_lin_w", "v_lin_b", "rot_w", "rot_b",
               "trans_w", "trans_b", "theta_w", "theta_b")


class BLCEParams(nn.Module):
    """Per-view stacked parameters, leading axis V = num_views, in the JAX
    ``BLCEParams`` field order and layout (``blce.py:34-60``): linears are
    ``x @ w + b`` with w [V, fan_in, fan_out]."""

    def __init__(self, **fields: torch.Tensor):
        super().__init__()
        missing = set(BLCE_FIELDS) - set(fields)
        if missing:
            raise ValueError(f"BLCEParams missing fields {sorted(missing)}")
        for name in BLCE_FIELDS:
            self.register_parameter(
                name, nn.Parameter(fields[name].to(torch.float32)))

    def leaves(self) -> tuple[torch.Tensor, ...]:
        return tuple(getattr(self, f) for f in BLCE_FIELDS)


class BLCEState(nn.Module):
    """BLCE parameters plus the per-view exposure scale, a buffer that no
    gradient reaches (re-estimated online in a later slice; init 0.4)."""

    def __init__(self, params: BLCEParams, exposure_expo: torch.Tensor):
        super().__init__()
        self.params = params
        self.register_buffer("exposure_expo", exposure_expo.to(torch.float32))


def init_blce(generator: torch.Generator | None, num_views: int,
              view_dim: int = 32, num_warp: int = 9,
              device: str | torch.device | None = None) -> BLCEState:
    """The JAX package's init laws (``blce.py:68-113``), drawn from
    ``generator`` (so not its numbers): torch ``nn.Linear``'s
    U(±1/√fan_in) for the encoders and the ODE right-hand side, a tiny
    Xavier-uniform with zero bias for the decoders, zeros for the view and
    time embeddings."""
    dev = resolve_device(device)
    V, D, E = num_views, view_dim, num_warp
    H = D // 2

    def uniform(shape, bound):
        u = torch.rand(shape, generator=generator, dtype=torch.float32,
                       device=dev)
        return u * (2 * bound) - bound

    def lin(fan_in, fan_out):
        b = 1.0 / math.sqrt(fan_in)
        return uniform((V, fan_in, fan_out), b), uniform((V, fan_out), b)

    def tiny_xavier(fan_in, fan_out):
        gain = 1e-5 / math.sqrt((H + 3) / 6.0)
        a = gain * math.sqrt(6.0 / (fan_in + fan_out))
        return (uniform((V, fan_in, fan_out), a),
                torch.zeros((V, fan_out), dtype=torch.float32, device=dev))

    f = {}
    f["bf_w0"], f["bf_b0"] = lin(2 * NUM_FREQS + 1, D)
    f["bf_w1"], f["bf_b1"] = lin(D, D)
    f["bf_w2"], f["bf_b2"] = lin(D, D)
    f["rt_w"], f["rt_b"] = lin(12, D)
    f["venc_w"], f["venc_b"] = lin(2 * D, D)
    f["w_lin_w"], f["w_lin_b"] = lin(H + 8 + D, H)
    f["v_lin_w"], f["v_lin_b"] = lin(H + 8 + D, H)
    f["rot_w"], f["rot_b"] = tiny_xavier(H, 3)
    f["trans_w"], f["trans_b"] = tiny_xavier(H, 3)
    f["theta_w"], f["theta_b"] = tiny_xavier(H, 1)
    f["view_embed"] = torch.zeros((V, D), dtype=torch.float32, device=dev)
    f["time_embed"] = torch.zeros((V, E, 8), dtype=torch.float32, device=dev)
    return BLCEState(BLCEParams(**f),
                     torch.full((V,), 0.4, dtype=torch.float32, device=dev))


def blur_feature(image: torch.Tensor, center_size: int = 20) -> torch.Tensor:
    """Low-frequency energy ratio of the frame (blce.py:27-52).

    Args:
      image: [3, H, W] or [H, W, 3] RGB in [0,1].
    Returns: scalar blur feature (higher = blurrier).
    """
    if image.shape[0] == 3:
        r, g, b = image[0], image[1], image[2]
    else:
        r, g, b = image[..., 0], image[..., 1], image[..., 2]
    gray = 0.299 * r + 0.587 * g + 0.114 * b
    f = torch.fft.fftshift(torch.fft.fft2(gray))
    mag = torch.abs(f)
    h, w = mag.shape
    c = center_size // 2
    low = torch.sum(mag[h // 2 - c:h // 2 + c, w // 2 - c:w // 2 + c])
    total = torch.sum(mag)
    return low / total


def latent_poses(state: BLCEState, c2w: torch.Tensor, bf: torch.Tensor,
                 view_idx, num_warp: int = 9):
    """Predict latent sharp camera poses for one view (``blce.py:137-189``).

    Args:
      state: BLCE parameters.
      c2w: [4, 4] camera-to-world of the blurry view.
      bf: scalar precomputed blur feature.
      view_idx: view id (int or 0-dim integer tensor).

    Returns:
      (c2w_latents [E, 4, 4], exposure_times [E]).
    """
    p = {f: getattr(state.params, f)[view_idx] for f in BLCE_FIELDS}
    D = p["view_embed"].shape[-1]
    H = D // 2
    dev = c2w.device
    bf = torch.as_tensor(bf, dtype=torch.float32, device=dev)

    freqs = 2.0 ** torch.arange(NUM_FREQS, dtype=torch.float32, device=dev)
    ang = bf * freqs * math.pi
    bf_embed = torch.cat([bf[None], torch.sin(ang), torch.cos(ang)])
    h = torch.relu(bf_embed @ p["bf_w0"] + p["bf_b0"])
    h = torch.relu(h @ p["bf_w1"] + p["bf_b1"])
    bf_feat = h @ p["bf_w2"] + p["bf_b2"]  # [D]

    rt_enc = c2w[:3, :].reshape(-1) @ p["rt_w"] + p["rt_b"]
    x = torch.cat([p["view_embed"], rt_enc]) @ p["venc_w"] + p["venc_b"]

    states = [x]
    for t in range(num_warp - 1):
        # WV_Derivative.forward (blce.py:260-275), unit Euler step
        r = torch.relu(x)
        # an index past the last embedding reads the last, as JAX's clamped
        # indexing does (the eval CLI's default num_warp=9 on a checkpoint
        # trained at fewer exposures)
        te = p["time_embed"][min(t, p["time_embed"].shape[0] - 1)]
        w_in = torch.cat([r[:H], te, bf_feat])
        v_in = torch.cat([r[H:], te, bf_feat])
        x = x + torch.cat([w_in @ p["w_lin_w"] + p["w_lin_b"],
                           v_in @ p["v_lin_w"] + p["v_lin_b"]])
        states.append(x)
    states = torch.stack(states)  # [E, D]

    latent_w, latent_v = states[:, :H], states[:, H:]
    w_rigid = latent_w @ p["rot_w"] + p["rot_b"]        # [E, 3]
    theta = latent_w @ p["theta_w"] + p["theta_b"]      # [E, 1]
    v_rigid = latent_v @ p["trans_w"] + p["trans_b"]    # [E, 3]

    delta = se3.se3_exp_wvtheta(w_rigid, v_rigid, theta)  # [E, 4, 4]
    c2w_new = torch.einsum("ij,tjk->tik", c2w, delta)
    expo = torch.linspace(-1.0, 1.0, num_warp, dtype=torch.float32,
                          device=dev) * state.exposure_expo[view_idx]
    return c2w_new, expo
