"""The reference's auxiliary loss library (port of
``mobgs_tpu/train/losses_extra.py``; dead in the reference's shipped train
path).

The parts of the reference's ``utils/loss_utils.py`` that train.py never
calls, ``utils/depth_loss_utils.py`` (never imported by its train) and the
depth-volume warps of ``scene/deformation.py``. The active losses live in
``train/losses.py``. Boolean indexing (``x[mask].mean()``) is a masked
mean, as in the JAX package.

Reference facts kept verbatim:
* ``weighted_l2_loss_v1`` is undefined in the reference, so its
  ``KnnConstraint`` would raise if called; ``knn_constraint_loss`` uses the
  shape-of-motion ``mean(w · (d - d_ref)²)``.
* ``sgt_smoothness`` computes its activations and returns 0.
"""

from __future__ import annotations

import contextlib

import torch

# rows of the ball query's [rows, N] distance panel per block, as a budget
# of panel entries: at 2^24 the block's float32 panel, int32 ranks and int64
# scatter indices take ~270 MB whatever N is
BALL_QUERY_PANEL = 1 << 24


# ---------------------------------------------------------------------------
# quaternion helpers (loss_utils.py:23-68)
# ---------------------------------------------------------------------------

def _normalize(q, dim=-1, eps=1e-12):
    n = torch.sqrt(torch.sum(q * q, dim=dim, keepdim=True))
    return q / torch.clamp(n, min=eps)


def quaternion_distance(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Geodesic distance between unit quaternions, radians ([B,4]→[B])."""
    q1 = _normalize(q1)
    q2 = _normalize(q2)
    dot = torch.clamp(torch.abs(torch.sum(q1 * q2, dim=-1)), -1.0, 1.0)
    return 2.0 * torch.arccos(dot)


def quaternion_slerp(q1: torch.Tensor, q2: torch.Tensor, t) -> torch.Tensor:
    """SLERP between two quaternions (loss_utils.py:37-68); ``t`` a scalar
    or a [S] vector (broadcast over samples)."""
    q1 = _normalize(q1)
    q2 = _normalize(q2)
    dot = torch.sum(q1 * q2, dim=-1)
    q2 = torch.where(dot < 0.0, -q2, q2)
    dot = torch.clamp(torch.abs(dot), -1.0, 1.0)
    theta = torch.arccos(dot)
    sin_theta = torch.sin(theta)
    tt = torch.as_tensor(t, dtype=q1.dtype, device=q1.device)[..., None]
    lin = (1.0 - tt) * q1 + tt * q2  # near-parallel fallback
    safe_sin = torch.where(sin_theta < 1e-6, torch.ones_like(sin_theta), sin_theta)
    slerp = (torch.sin((1.0 - tt) * theta) / safe_sin * q1
             + torch.sin(tt * theta) / safe_sin * q2)
    return torch.where(sin_theta < 1e-6, lin, slerp)


def trbfunction(x: torch.Tensor) -> torch.Tensor:
    """exp(-x²) temporal radial basis (loss_utils.py:70-71)."""
    return torch.exp(-torch.square(x))


# ---------------------------------------------------------------------------
# image-space regularizers (loss_utils.py:73-167)
# ---------------------------------------------------------------------------

def compute_tv_loss(pred: torch.Tensor) -> torch.Tensor:
    """Total variation over [B,H,W,3] (loss_utils.py:73-84)."""
    h_diff = pred[..., :, :-1, :] - pred[..., :, 1:, :]
    w_diff = pred[..., :-1, :, :] - pred[..., 1:, :, :]
    return torch.mean(torch.abs(h_diff)) + torch.mean(torch.abs(w_diff))


def _masked_mean(vals: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    m = mask.to(vals.dtype)
    return torch.sum(vals * m) / torch.clamp(torch.sum(m), min=1e-12)


def _quantile(x: torch.Tensor, q) -> torch.Tensor:
    """``jnp.quantile(x, q)`` (linear) over all of x, its arithmetic:
    ``low · (1 - w) + high · w`` at ``q · (n - 1)``. ``torch.quantile``
    interpolates with ``lerp``, which can differ in the last place (and the
    gates below compare against the quantile) and gives NaN between a finite
    and an infinite neighbour, which ``compute_gradient_loss``'s padding
    meets."""
    a = torch.sort(x.reshape(-1)).values
    n = a.shape[0]
    pos = torch.as_tensor(q, dtype=a.dtype, device=a.device) * (n - 1)
    low, high = torch.floor(pos), torch.ceil(pos)
    hw = pos - low
    low = torch.clamp(low, 0, n - 1).long()
    high = torch.clamp(high, 0, n - 1).long()
    return a[low] * (1 - hw) + a[high] * hw


def trimmed_mse_loss(pred, gt, quantile=0.9):
    """Mean of per-element MSE below its ``quantile`` (loss_utils.py:134-139)."""
    loss = torch.mean(torch.square(pred - gt), dim=-1)
    return _masked_mean(loss, loss < _quantile(loss, quantile))


def trimmed_l1_loss(pred, gt, quantile=0.9):
    """loss_utils.py:141-146."""
    loss = torch.mean(torch.abs(pred - gt), dim=-1)
    return _masked_mean(loss, loss < _quantile(loss, quantile))


def _masked_quantile_loss(sum_loss, mask, normalize, quantile):
    """Shared core of masked_{mse,l1}_loss (loss_utils.py:86-119).
    sum_loss: [..., 1] per-element loss."""
    if quantile < 1:
        qmask = (sum_loss < _quantile(sum_loss, quantile))[..., 0]
    else:
        qmask = torch.ones(sum_loss.shape[:-1], dtype=torch.bool,
                           device=sum_loss.device)
    ndim = sum_loss.shape[-1]  # == 1, kept for formula parity
    weighted = sum_loss * mask
    sel = qmask[..., None].to(sum_loss.dtype)
    if normalize:
        return torch.sum(weighted * sel) / (ndim * torch.sum(mask * sel) + 1e-8)
    return torch.sum(weighted * sel) / torch.clamp(torch.sum(sel) * ndim, min=1e-12)


def masked_mse_loss(pred, gt, mask=None, normalize=True, quantile: float = 1.0):
    """loss_utils.py:86-103."""
    if mask is None:
        return trimmed_mse_loss(pred, gt, quantile)
    sum_loss = torch.mean(torch.square(pred - gt), dim=-1, keepdim=True)
    return _masked_quantile_loss(sum_loss, mask, normalize, quantile)


def masked_l1_loss(pred, gt, mask=None, normalize=True, quantile: float = 1.0):
    """loss_utils.py:105-119."""
    if mask is None:
        return trimmed_l1_loss(pred, gt, quantile)
    sum_loss = torch.mean(torch.abs(pred - gt), dim=-1, keepdim=True)
    return _masked_quantile_loss(sum_loss, mask, normalize, quantile)


def _huber(diff, delta):
    a = torch.abs(diff)
    return torch.where(a <= delta, 0.5 * diff * diff, delta * (a - 0.5 * delta))


def masked_huber_loss(pred, gt, delta, mask=None, normalize=True):
    """loss_utils.py:122-132 (torch F.huber_loss semantics)."""
    h = _huber(pred - gt, delta)
    if mask is None:
        return torch.mean(h)
    ndim = h.shape[-1]
    if normalize:
        return torch.sum(h * mask) / (ndim * torch.sum(mask) + 1e-8)
    return torch.mean(h * mask)


def compute_gradient_loss(pred, gt, mask, quantile=0.98):
    """Masked finite-difference gradient loss (loss_utils.py:148-167).

    pred/gt: [B,H,W] or [B,H,W,D]; mask: [B,H,W]. The reference's boolean
    gather and quantile over the gathered values, with static shapes: the
    invalid entries pushed to +inf and the quantile level rescaled so that
    the interpolation point lands at the same rank of the valid prefix."""
    mask = mask.to(pred.dtype)
    mask_x = mask[:, :, 1:] * mask[:, :, :-1]
    mask_y = mask[:, 1:, :] * mask[:, :-1, :]
    pgx = pred[:, :, 1:] - pred[:, :, :-1]
    pgy = pred[:, 1:, :] - pred[:, :-1, :]
    ggx = gt[:, :, 1:] - gt[:, :, :-1]
    ggy = gt[:, 1:, :] - gt[:, :-1, :]
    if pgx.ndim == 3:  # add the feature axis the reference indexes with
        pgx, pgy, ggx, ggy = (x[..., None] for x in (pgx, pgy, ggx, ggy))

    def term(p, g, m):
        sl = torch.mean(torch.abs(p - g), dim=-1).reshape(-1)
        mf = (m > 0).reshape(-1)
        n_valid = torch.sum(mf)
        n_full = sl.shape[0]
        q_adj = quantile * (n_valid - 1) / max(n_full - 1, 1)
        qv = _quantile(torch.where(mf, sl, torch.full_like(sl, float("inf"))),
                       torch.clamp(q_adj.to(sl.dtype), 0, 1))
        return _masked_mean(sl, (sl < qv) & mf)
    return term(pgx, ggx, mask_x) + term(pgy, ggy, mask_y)


# ---------------------------------------------------------------------------
# shape-of-motion ("som") losses (loss_utils.py:170-226)
# ---------------------------------------------------------------------------

def get_weights_for_procrustes(clusters: torch.Tensor,
                               visibilities: torch.Tensor | None = None):
    """loss_utils.py:170-184. The medians are ``torch.median``'s, the lower
    of the two middle elements, which the JAX package rebuilds by hand."""
    med = torch.median(clusters, dim=-2, keepdim=True).values
    d = torch.linalg.norm(clusters - med, dim=-1)
    d = d / torch.median(d, dim=-1, keepdim=True).values
    w = torch.exp(-d)
    w = w / (torch.mean(w, dim=-1, keepdim=True) + 1e-6)
    if visibilities is not None:
        w = w * (visibilities.to(w.dtype) + 1e-6)
    invalid = (d > _quantile(d, 0.9)) | torch.isnan(w)
    return torch.where(invalid, torch.zeros_like(w), w)


def compute_z_acc_loss(means_ts_nb: torch.Tensor, w2cs: torch.Tensor):
    """Along-ray velocity penalty over a 3-frame window
    (loss_utils.py:186-203). means_ts_nb: [G,3,B,3], w2cs: [B,4,4]."""
    cam_centers = torch.linalg.inv(w2cs)[:, :3, 3]  # [B,3]
    ray_dir = _normalize(means_ts_nb[:, 1] - cam_centers)  # [G,B,3]
    v01 = torch.sum((means_ts_nb[:, 1] - means_ts_nb[:, 0]) * ray_dir, dim=-1)
    v12 = torch.sum((means_ts_nb[:, 2] - means_ts_nb[:, 1]) * ray_dir, dim=-1)
    return torch.mean(v01 ** 2) + torch.mean(v12 ** 2)


def compute_accel_loss(transls: torch.Tensor) -> torch.Tensor:
    """Central-difference acceleration norm (loss_utils.py:222-225)."""
    accel = 2 * transls[:, 1:-1] - transls[:, :-2] - transls[:, 2:]
    return torch.mean(torch.linalg.norm(accel, dim=-1))


def compute_se3_smoothness_loss(rots, transls, weight_rot=1.0,
                                weight_transl=2.0):
    """loss_utils.py:206-219."""
    return (compute_accel_loss(rots) * weight_rot
            + compute_accel_loss(transls) * weight_transl)


# ---------------------------------------------------------------------------
# alpha / motion regularizers (loss_utils.py:242-319, 445-469)
# ---------------------------------------------------------------------------

def l2_loss(pred, gt, mask=None):
    """loss_utils.py:242-249 ([B,C,H,W] mask broadcast over channels)."""
    if mask is None:
        return torch.mean(torch.square(pred - gt))
    mask = torch.broadcast_to(mask, gt.shape)
    return torch.sum(torch.square((pred - gt) * mask)) / (torch.sum(mask) + 1e-8)


def entropy_loss_logit(alpha: torch.Tensor) -> torch.Tensor:
    """loss_utils.py:278-283."""
    eps = 1e-6
    logit = torch.log(alpha + eps) - torch.log(1 - alpha + eps)
    return -torch.sum(torch.sigmoid(logit) * logit)


def sparsity_loss_boost(alpha: torch.Tensor) -> torch.Tensor:
    """Push α toward 0.1 early in training (loss_utils.py:297-299)."""
    return torch.sum(torch.square(alpha - 0.1))


def motion_consistency_loss(positions_t, positions_t_prev, alpha):
    """Penalize high-α low-motion splats (loss_utils.py:302-316)."""
    motion = torch.linalg.norm(positions_t - positions_t_prev, dim=1)
    return torch.sum(alpha * motion)


def sgt_smoothness(trbf_center, trbf_scale, time, fwd_time, bwd_time):
    """loss_utils.py:445-469: the reference computes the three trbf
    activations and then returns 0; kept verbatim."""
    for t in (time, bwd_time, fwd_time):
        _ = trbfunction((t - trbf_center) / torch.exp(trbf_scale))
    return torch.zeros((), dtype=trbf_center.dtype, device=trbf_center.device)


# ---------------------------------------------------------------------------
# KNN rigidity constraint (loss_utils.py:506-543)
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def _fp32_matmuls():
    """cuBLAS matmuls in full float32 inside the block (TF32 off), the
    caller's flag restored after it."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def ball_query(query: torch.Tensor, points: torch.Tensor, k: int,
               radius: float):
    """pytorch3d-style ball query (``losses_extra.py:269-296``): for each
    query point, up to k point indices within ``radius`` in first-found
    order (ascending index), -1-padded. Returns (dists [B,N,k], idx [B,N,k]
    int32) like ``pytorch3d.ops.ball_query``.

    The [N, M] squared-distance panel is the expansion |q|² + |p|² - 2 q·p
    in the JAX package's order of operations, so the in-ball gate flips on
    the same pairs, with the product in full float32. Rows are independent:
    the panel is built BALL_QUERY_PANEL entries at a time, the same function
    in bounded memory. Hits past the k-th scatter into a (k+1)-th slot that
    is dropped (the JAX scatter's ``mode="drop"``)."""
    B, N, _ = query.shape
    M = points.shape[1]
    rows = max(1, BALL_QUERY_PANEL // max(M, 1))
    dists = torch.zeros((B, N, k), dtype=query.dtype, device=query.device)
    idx = torch.full((B, N, k), -1, dtype=torch.int32, device=query.device)
    cols = torch.arange(M, dtype=torch.int32, device=query.device)
    with _fp32_matmuls():
        for b in range(B):
            p = points[b]
            pp = torch.sum(p * p, -1)[None, :]
            for r0 in range(0, N, rows):
                q = query[b, r0:r0 + rows]
                d2 = torch.sum(q * q, -1)[:, None] + pp - (2.0 * q) @ p.T
                inball = d2 <= radius * radius
                rank = torch.cumsum(inball, dim=1, dtype=torch.int32) - 1
                dst = torch.where(inball & (rank < k), rank,
                                  torch.full_like(rank, k)).long()
                n = q.shape[0]
                slot_i = torch.full((n, k + 1), -1, dtype=torch.int32,
                                    device=query.device)
                slot_i.scatter_(1, dst, cols.expand(n, M))
                slot_d = torch.zeros((n, k + 1), dtype=d2.dtype, device=d2.device)
                slot_d.scatter_(1, dst, torch.clamp(d2, min=0.0))
                idx[b, r0:r0 + n] = slot_i[:, :k]
                dists[b, r0:r0 + n] = slot_d[:, :k]
    return dists, idx


def knn_constraint_loss(xyz: torch.Tensor, canno_xyz: torch.Tensor,
                        radius: float, neighborhood_size: int = 20,
                        temperature: float = 0.1) -> torch.Tensor:
    """Ball-query rigidity constraint (``KnnConstraint``,
    loss_utils.py:506-543): neighbour distances at time t must match the
    canonical-frame distances, weighted by exp(-d_canno² · T).

    xyz: [B,N,3] deformed positions; canno_xyz: [N,3] canonical. The
    reference body calls the undefined ``weighted_l2_loss_v1``; this uses
    mean(w · (d - d_canno)²) (the shape-of-motion convention)."""
    _, nbr = ball_query(xyz, xyz, k=neighborhood_size, radius=radius)
    nbr = nbr[..., 1:].long()  # drop self (the first hit, at d=0)
    nbr_mask = nbr != -1
    nbr_safe = torch.where(nbr_mask, nbr, torch.zeros_like(nbr))
    bidx = torch.arange(xyz.shape[0], device=xyz.device)[:, None, None]
    neigh = xyz[bidx, nbr_safe]                              # [B,N,K,3]
    cur_d = torch.linalg.norm(xyz[:, :, None, :] - neigh, dim=-1)
    canno_neigh = canno_xyz[nbr_safe]
    canno_d = torch.linalg.norm(canno_xyz[None, :, None, :] - canno_neigh,
                                dim=-1).detach()
    w = torch.exp(-torch.square(canno_d) * temperature).detach()
    w = torch.where(nbr_mask, w, torch.zeros_like(w))
    return torch.mean(w * torch.square(cur_d - canno_d))


def compute_cluster_cohesion_loss(means3d: torch.Tensor, labels: torch.Tensor,
                                  centroids: torch.Tensor) -> torch.Tensor:
    """Per-cluster mean squared distance to the centroid, averaged over
    clusters (loss_utils.py:546-574). Empty clusters contribute 0; a label
    outside [0, C) belongs to none (``jax.nn.one_hot``)."""
    C = centroids.shape[0]
    onehot = (labels[:, None] == torch.arange(C, device=labels.device)
              ).to(means3d.dtype)                                  # [N,C]
    per_pt = torch.mean(torch.square(means3d[:, None, :] - centroids[None]),
                        dim=-1)  # [N,C]
    sums = torch.sum(per_pt * onehot, dim=0)
    counts = torch.sum(onehot, dim=0)
    per_cluster = torch.where(counts > 0, sums / torch.clamp(counts, min=1.0),
                              torch.zeros_like(sums))
    return torch.mean(per_cluster)


# ---------------------------------------------------------------------------
# SLERP path-distance losses (loss_utils.py:576-733)
# ---------------------------------------------------------------------------

def _linspace01(n: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """``jnp.linspace(0, 1, n)`` as XLA computes it, bit for bit: iota times
    the float32 reciprocal of n - 1, the last entry exactly 1.
    ``torch.linspace`` counts down from the end over the upper half, which
    differs in the last place (the disparity buckets' edges must agree)."""
    if n == 1:
        return torch.zeros(1, dtype=dtype, device=device)
    recip = torch.ones((), dtype=dtype) / torch.tensor(n - 1, dtype=dtype)
    s = torch.arange(n, dtype=dtype, device=device) * recip.to(device)
    s[-1] = 1.0
    return s


def path_distance_loss_separate(ref_quats: torch.Tensor,
                                warped_quats: torch.Tensor,
                                num_samples: int = 100) -> torch.Tensor:
    """Min geodesic distance of each warped rotation to the sampled
    R1→R2 / R2→R3 SLERP paths (loss_utils.py:576-630), on quaternions
    ([3,4] and [N,4]); a degenerate (equal-endpoint) path is excluded like
    the reference's allclose gates."""
    t_vals = _linspace01(num_samples, ref_quats.dtype, ref_quats.device)[1:-1]
    paths = []
    for a, b in ((0, 1), (1, 2)):
        same = torch.all(torch.abs(ref_quats[a] - ref_quats[b]) <= 1e-6)
        path = quaternion_slerp(ref_quats[a], ref_quats[b], t_vals)  # [S,4]
        d = quaternion_distance(
            warped_quats[:, None, :].expand(-1, path.shape[0], -1), path[None])
        mind = torch.min(d, dim=-1).values
        paths.append(torch.where(same, torch.full_like(mind, float("inf")), mind))
    mind = torch.min(torch.stack(paths), dim=0).values
    mind = torch.where(torch.isinf(mind), torch.zeros_like(mind), mind)
    return torch.mean(mind)


def _arc_min_distances(v_a, v_b, warped_points, num_samples):
    theta = torch.arccos(torch.clamp(torch.dot(v_a, v_b), -1.0, 1.0))
    t = _linspace01(num_samples, v_a.dtype, v_a.device)[:, None]
    sin_t = torch.where(torch.sin(theta) < 1e-12, torch.ones_like(theta),
                        torch.sin(theta))
    arc = (torch.sin((1 - t) * theta) / sin_t * v_a
           + torch.sin(t * theta) / sin_t * v_b)  # [S,3]
    d = torch.linalg.norm(warped_points[:, None, :] - arc[None], dim=-1)
    return torch.min(d, dim=-1).values  # [N]


def path_distance_loss_rotation(ref_rs: torch.Tensor, warped_rs: torch.Tensor,
                                num_samples: int = 50) -> torch.Tensor:
    """Unit-sphere arc version (loss_utils.py:632-692): the normalised
    [1,1,1] probe rotated by each matrix, its distance to the great-circle
    arcs v1→v2, v2→v3; the sum over the applicable arcs over N."""
    base = torch.full((3,), 1.0, dtype=ref_rs.dtype, device=ref_rs.device)
    base = base / torch.sqrt(torch.tensor(3.0, dtype=ref_rs.dtype))
    v1, v2, v3 = (ref_rs[i] @ base for i in range(3))
    warped = torch.einsum("nij,j->ni", warped_rs, base)
    total = torch.zeros((), dtype=ref_rs.dtype, device=ref_rs.device)
    for a, b in ((v1, v2), (v2, v3)):
        same = torch.all(torch.abs(a - b) <= 1e-6)
        s = torch.sum(_arc_min_distances(a, b, warped, num_samples))
        total = total + torch.where(same, torch.zeros_like(s), s)
    return total / warped_rs.shape[0]


def path_distance_loss_translation(ref_ts: torch.Tensor,
                                   warped_ts: torch.Tensor,
                                   num_samples: int = 50) -> torch.Tensor:
    """Straight-segment version for camera centres (loss_utils.py:694-733)."""
    t = _linspace01(num_samples, ref_ts.dtype, ref_ts.device)[:, None]
    total = torch.zeros((), dtype=ref_ts.dtype, device=ref_ts.device)
    for a, b in ((ref_ts[0], ref_ts[1]), (ref_ts[1], ref_ts[2])):
        same = torch.all(torch.abs(a - b) <= 1e-6)
        seg = (1 - t) * a + t * b  # [S,3]
        d = torch.linalg.norm(warped_ts[:, None, :] - seg[None], dim=-1)
        s = torch.sum(torch.min(d, dim=-1).values)
        total = total + torch.where(same, torch.zeros_like(s), s)
    return total / warped_ts.shape[0]


# ---------------------------------------------------------------------------
# depth priors (the reference's utils/depth_loss_utils.py)
# ---------------------------------------------------------------------------

def loss_depth_smoothness(depth: torch.Tensor, img: torch.Tensor):
    """Edge-aware depth smoothness (depth_loss_utils.py:29-38).
    depth [B,1,H,W], img [B,C,H,W]."""
    igx = img[:, :, :, :-1] - img[:, :, :, 1:]
    igy = img[:, :, :-1, :] - img[:, :, 1:, :]
    wx = torch.exp(-torch.mean(torch.abs(igx), dim=1, keepdim=True))
    wy = torch.exp(-torch.mean(torch.abs(igy), dim=1, keepdim=True))
    num = (torch.sum(torch.abs(depth[:, :, :, :-1] - depth[:, :, :, 1:]) * wx)
           + torch.sum(torch.abs(depth[:, :, :-1, :] - depth[:, :, 1:, :]) * wy))
    return num / (torch.sum(wx) + torch.sum(wy))


def loss_depth_grad(depth: torch.Tensor, img: torch.Tensor):
    """Sign-of-gradient agreement (depth_loss_utils.py:40-52)."""
    igx = img[:, :, :, :-1] - img[:, :, :, 1:]
    igy = img[:, :, :-1, :] - img[:, :, 1:, :]
    wx = igx / (torch.abs(igx) + 1e-6)
    wy = igy / (torch.abs(igy) + 1e-6)
    dgx = depth[:, :, :, :-1] - depth[:, :, :, 1:]
    dgy = depth[:, :, :-1, :] - depth[:, :, 1:, :]
    gx = dgx / (torch.abs(dgx) + 1e-6)
    gy = dgy / (torch.abs(dgy) + 1e-6)
    return torch.mean(torch.abs(gx - wx)) + torch.mean(torch.abs(gy - wy))


def margin_l2_loss(pred, gt, margin, return_mask=False):
    """Mean squared error over the elements beyond ``margin``
    (depth_loss_utils.py:61-66)."""
    mask = torch.abs(pred - gt) > margin
    val = _masked_mean(torch.square(pred - gt), mask)
    return (val, mask) if return_mask else val


def margin_l1_loss(pred, gt, margin, return_mask=False):
    """depth_loss_utils.py:68-74."""
    mask = torch.abs(pred - gt) > margin
    val = _masked_mean(torch.abs(pred - gt), mask)
    return (val, mask) if return_mask else val


def kl_loss(inp, target):
    """F.kl_div(log_softmax(inp), softmax(target), 'batchmean')
    (depth_loss_utils.py:76-79)."""
    logp = torch.log_softmax(inp, dim=-1)
    q = torch.softmax(target, dim=-1)
    per = q * (torch.log(torch.clamp(q, min=1e-38)) - logp)
    return torch.sum(per) / inp.shape[0]


def patchify(x: torch.Tensor, patch_size: int) -> torch.Tensor:
    """F.unfold(kernel=stride=patch) → [B·P, C·patch²]
    (depth_loss_utils.py:81-83)."""
    B, C, H, W = x.shape
    ph, pw = H // patch_size, W // patch_size
    x = x[:, :, :ph * patch_size, :pw * patch_size]
    x = x.reshape(B, C, ph, patch_size, pw, patch_size)
    # unfold flattens (C, kh, kw) per patch with C outermost
    return x.permute(0, 2, 4, 1, 3, 5).reshape(B * ph * pw,
                                               C * patch_size * patch_size)


def _norm_patches(p, std=None):
    # torch.std applies Bessel's correction
    mean = torch.mean(p, dim=1, keepdim=True)
    s = torch.std(p, dim=1, keepdim=True) if std is None else std
    return (p - mean) / (s + 1e-2 * torch.std(p.reshape(-1)))


def patch_norm_mse_loss(inp, target, patch_size, margin, return_mask=False):
    """depth_loss_utils.py:85-88."""
    return margin_l2_loss(_norm_patches(patchify(inp, patch_size)),
                          _norm_patches(patchify(target, patch_size)),
                          margin, return_mask)


def patch_norm_mse_loss_global(inp, target, patch_size, margin,
                               return_mask=False):
    """depth_loss_utils.py:90-93 (global detached std)."""
    si = torch.std(inp).detach()
    st = torch.std(target).detach()
    return margin_l2_loss(_norm_patches(patchify(inp, patch_size), si),
                          _norm_patches(patchify(target, patch_size), st),
                          margin, return_mask)


def patch_norm_l1_loss(inp, target, patch_size, margin, return_mask=False):
    """depth_loss_utils.py:100-103."""
    return margin_l1_loss(_norm_patches(patchify(inp, patch_size)),
                          _norm_patches(patchify(target, patch_size)),
                          margin, return_mask)


def patch_norm_l1_loss_global(inp, target, patch_size, margin,
                              return_mask=False):
    """depth_loss_utils.py:95-98."""
    si = torch.std(inp).detach()
    st = torch.std(target).detach()
    return margin_l1_loss(_norm_patches(patchify(inp, patch_size), si),
                          _norm_patches(patchify(target, patch_size), st),
                          margin, return_mask)


# ---------------------------------------------------------------------------
# depth-volume warps (the reference's scene/deformation.py:509-638)
# ---------------------------------------------------------------------------

def _grid_sample_ac(img: torch.Tensor, grid: torch.Tensor,
                    padding_mode: str = "zeros") -> torch.Tensor:
    """torch ``F.grid_sample(bilinear, align_corners=True)`` as the JAX
    package writes it (``losses_extra.py:526-553``): the four taps gathered,
    an out-of-range tap tested on its float index and zeroed ("zeros") or
    its index clamped ("border").

    img [..., C, H, W]; grid [..., Ho, Wo, 2] normalised (x, y) in [-1, 1],
    the leading axes those of img or img has none → [..., C, Ho, Wo]."""
    C, H, W = img.shape[-3:]
    lead = grid.shape[:-3]
    Ho, Wo = grid.shape[-3], grid.shape[-2]
    flat = img.reshape(*img.shape[:-2], H * W).expand(*lead, C, H * W)
    x = (grid[..., 0] + 1.0) * 0.5 * (W - 1)
    y = (grid[..., 1] + 1.0) * 0.5 * (H - 1)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    wx = (x - x0)[..., None, :, :]
    wy = (y - y0)[..., None, :, :]

    def at(iy, ix):
        iyc = torch.clamp(iy.to(torch.int64), 0, H - 1)
        ixc = torch.clamp(ix.to(torch.int64), 0, W - 1)
        tap = (iyc * W + ixc).reshape(*lead, 1, Ho * Wo).expand(*lead, C, Ho * Wo)
        v = torch.gather(flat, -1, tap).reshape(*lead, C, Ho, Wo)
        if padding_mode == "zeros":
            ok = (iy >= 0) & (iy <= H - 1) & (ix >= 0) & (ix <= W - 1)
            v = torch.where(ok[..., None, :, :], v, torch.zeros_like(v))
        return v

    top = at(y0, x0) * (1 - wx) + at(y0, x0 + 1) * wx
    bot = at(y0 + 1, x0) * (1 - wx) + at(y0 + 1, x0 + 1) * wx
    return top * (1 - wy) + bot * wy


def _pixel_grid_h(height: int, width: int, device=None) -> torch.Tensor:
    """Homogeneous integer pixel grid [3, H*W] (the reference's set_id_grid:
    x=j, y=i, 1, no half-pixel offset)."""
    j, i = torch.meshgrid(torch.arange(width, dtype=torch.float32, device=device),
                          torch.arange(height, dtype=torch.float32, device=device),
                          indexing="xy")
    return torch.stack([j.reshape(-1), i.reshape(-1),
                        torch.ones(height * width, dtype=torch.float32,
                                   device=device)])


def _to_grid(c2: torch.Tensor, K: torch.Tensor, H: int, W: int,
             padding_mode: str) -> torch.Tensor:
    """Camera points [..., 3, HW] → the normalised sample grid
    [..., H, W, 2]; with "zeros" padding an out-of-range coordinate is set
    to exactly 2, as the reference does."""
    z = c2[..., 2:3, :]
    z = torch.where(torch.abs(z) < 1e-6, torch.full_like(z, 1e-6), z)
    p2 = K @ (c2 / z)
    xn = 2.0 * p2[..., 0, :] / (W - 1) - 1.0
    yn = 2.0 * p2[..., 1, :] / (H - 1) - 1.0
    if padding_mode == "zeros":
        xn = torch.where((xn > 1) | (xn < -1), torch.full_like(xn, 2.0), xn)
        yn = torch.where((yn > 1) | (yn < -1), torch.full_like(yn, 2.0), yn)
    return torch.stack([xn, yn], dim=-1).reshape(*c2.shape[:-2], H, W, 2)


def inverse_warp_grid_rt1_rt2(depth: torch.Tensor, w2c1: torch.Tensor,
                              w2c2: torch.Tensor, K: torch.Tensor,
                              K_inv: torch.Tensor,
                              padding_mode: str = "zeros") -> torch.Tensor:
    """Normalised frame-2 sample grid for frame-1 pixels at the given depth
    (the reference's deformation.py:704-756, one view).

    depth [..., H, W] (leading axes: depths sampled as a batch); w2c*
    [3/4, 4] (rows 0:3 used); K/K_inv [3, 3]. Returns [..., H, W, 2] for
    ``_grid_sample_ac``."""
    H, W = depth.shape[-2:]
    R1, t1 = w2c1[:3, :3], w2c1[:3, 3:4]
    R2, t2 = w2c2[:3, :3], w2c2[:3, 3:4]
    pix = _pixel_grid_h(H, W, depth.device)
    c1 = K_inv @ pix * depth.reshape(*depth.shape[:-2], 1, H * W)  # [..., 3, HW]
    w = R1.T @ c1 - R1.T @ t1
    c2 = R2 @ w + t2
    return _to_grid(c2, K, H, W, padding_mode)


def _disp_buckets(no_bucket: int, device=None) -> torch.Tensor:
    """Linear disparity bins over depth (0.1, 100) (the reference's
    deformation.py:515-520), bit-equal with the JAX package's."""
    min_disp, max_disp = 1.0 / 100.0, 1.0 / 0.1
    return _linspace01(no_bucket, device=device) * (max_disp - min_disp) + min_disp


def _disparity_volume(depth, no_bucket, right, w2c1, w2c2, K, K_inv,
                      padding_mode):
    """The one-hot disparity volume [B, H, W] (searchsorted on the given
    side, then clipped into the buckets) and the sample grids of the B depth
    levels [B, H, W, 2]."""
    H, W = depth.shape
    buckets = _disp_buckets(no_bucket, depth.device)
    disp = 1.0 / depth
    idx = torch.clamp(torch.searchsorted(buckets, disp.reshape(-1), right=right),
                      0, no_bucket - 1)
    levels = torch.arange(no_bucket, device=depth.device)
    disp_vol = (idx[None, :] == levels[:, None]).to(depth.dtype).reshape(no_bucket, H, W)
    depth_levels = (1.0 / buckets)[:, None, None].expand(no_bucket, H, W)
    grid_vol = inverse_warp_grid_rt1_rt2(depth_levels, w2c1, w2c2, K, K_inv,
                                         padding_mode)
    return disp_vol, grid_vol


def direct_warp_rt1_rt2(img: torch.Tensor, depth: torch.Tensor,
                        w2c1: torch.Tensor, w2c2: torch.Tensor,
                        K: torch.Tensor, K_inv: torch.Tensor,
                        padding_mode: str = "zeros", ret_grid: bool = False,
                        no_bucket: int = 64):
    """Forward ("direct") warp through a discretised disparity volume (the
    reference's deformation.py:509-555, one view).

    img [C, H, W]; depth [H, W]. Returns (fw_img [C, H, W], occ_map [H, W]
    [, grid_vol [no_bucket, H, W, 2]]). The bucket index is
    ``searchsorted(side="right")``, the reference's ``bucketize(right=True)``;
    a depth outside (0.1, 100) lands in an edge bucket (the reference's
    ``F.one_hot`` would raise)."""
    disp_vol, grid_vol = _disparity_volume(depth, no_bucket, True, w2c1, w2c2,
                                           K, K_inv, padding_mode)
    fw_img = _grid_sample_ac(img, grid_vol, padding_mode)            # [B, C, H, W]
    dprob_ = _grid_sample_ac(disp_vol[:, None], grid_vol, padding_mode)[:, 0]
    dprob = torch.softmax(dprob_, dim=0)
    out = torch.sum(fw_img * dprob[:, None], dim=0)                  # [C, H, W]
    occ = torch.clamp(torch.sum(dprob_, dim=0).detach(), max=1.0)
    if ret_grid:
        return out, occ, grid_vol
    return out, occ


def occ_rt1_rt2(depth: torch.Tensor, w2c1: torch.Tensor, w2c2: torch.Tensor,
                K: torch.Tensor, K_inv: torch.Tensor,
                padding_mode: str = "zeros",
                no_bucket: int = 128) -> torch.Tensor:
    """Occlusion map from the warped disparity volume (the reference's
    deformation.py:557-588, one view; ``searchsorted(side="left")``, its
    ``bucketize(right=False)``). depth [H, W] → occ [H, W]."""
    disp_vol, grid_vol = _disparity_volume(depth, no_bucket, False, w2c1, w2c2,
                                           K, K_inv, padding_mode)
    dprob_ = _grid_sample_ac(disp_vol[:, None], grid_vol, padding_mode)[:, 0]
    return torch.clamp(torch.sum(dprob_, dim=0), max=1.0)


def warp_pc2flow(img: torch.Tensor, pc2: torch.Tensor, w2c2: torch.Tensor,
                 K: torch.Tensor, padding_mode: str = "zeros",
                 ret_grid: bool = False):
    """Warp by projecting a per-pixel world point cloud (the reference's
    deformation.py:590-638, one view).

    img [C, H, W]; pc2 [3, H, W] world coordinates per pixel; w2c2 [3/4, 4].
    Returns projected_img [C, H, W] (+ grid [H, W, 2] if ret_grid)."""
    _, H, W = img.shape
    R2, t2 = w2c2[:3, :3], w2c2[:3, 3:4]
    c2 = R2 @ pc2.reshape(3, -1) + t2
    grid = _to_grid(c2, K, H, W, padding_mode)
    out = _grid_sample_ac(img, grid, padding_mode)
    if ret_grid:
        return out, grid
    return out
