"""The benchmark's plain reference of the MoBGS fine stage, in plain PyTorch.

It imports nothing of the program under test and takes nothing the program
made: it works out its own projection, tile lists, composites, decoder,
latent poses, losses, gradients (autograd through a plain compositor) and
Adam updates from the inputs the benchmark makes (the scene, the seed
points and the drawn weights).

Semantics, as the system defines them (MoBGS / gsplat v1.4 projection; the
tile compositor of the JAX package):

* projection: EWA with the Jacobian's plane coordinates clamped to
  1.3 tan(fov), +0.3 on the 2D covariance diagonal, radius ceil(3 sigma) of
  the larger eigenvalue, culled at z <= 0.01, off-image or degenerate;
* tiles of 16x16 pixels; a splat covers the tiles of its radius box; a box
  wider than ``tiles_per_gauss`` tiles is cut to its centre's
  sqrt(tiles_per_gauss)-wide square; each tile composites its front-most
  ``max_per_tile`` splats in depth order (the depth's float32 bit pattern
  cut to the bits that the tile index leaves in a 31-bit key; ties in index
  order);
* alpha = min(o exp(-sigma), 0.99), kept when sigma >= 0 and alpha > 1/255;
  a tile stops after a chunk of ``chunk`` slots once every pixel's
  transmittance (of both chains, where a subset chain runs) is <= 1e-4.

Differentiation is autograd through that forward, recomputed per block of
tiles in the backward (``torch.utils.checkpoint``), so no hand-derived
gradient enters the reference.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

TILE = 16
PIX = TILE * TILE
ALPHA_MAX = 0.99
ALPHA_MIN = 1.0 / 255.0
TRANS_EPS = 1e-4
SPLINE_SCALE = 1e-2
SH_C0 = 0.28209479177387814
NUM_FREQS = 10
# entries x pixels of one block of the compositor: bounds the memory of a
# block's recomputation in the backward
BLOCK_ELEMS = 1 << 24


def set_precision(tf32: bool):
    """float32 matmuls and convolutions in full float32 (the configuration's
    precision), or in TF32 (the control)."""
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32


# ---------------------------------------------------------------------------
# rotations and rigid transforms

def normalize(v, eps=1e-12):
    sq = (v * v).sum(-1, keepdim=True)
    return v * torch.rsqrt(torch.clamp(sq, min=eps * eps))


def quat_to_rotmat(q):
    w, x, y, z = normalize(q).unbind(-1)
    return torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], -1).reshape(q.shape[:-1] + (3, 3))


def rigid_inverse(m):
    R, t = m[..., :3, :3], m[..., :3, 3:]
    Rt = R.transpose(-1, -2)
    out = torch.zeros_like(m)
    out[..., :3, :3] = Rt
    out[..., :3, 3:] = -Rt @ t
    out[..., 3, 3] = 1.0
    return out


def se3_exp(w, v, theta):
    """SE(3) from an axis (normalised here), a translation and an angle:
    Rodrigues' rotation and p = G(w, theta) v. [..., 4, 4]."""
    u = w * torch.rsqrt(torch.clamp((w * w).sum(-1, keepdim=True), min=1e-20))
    zero = torch.zeros_like(u[..., 0])
    Wx = torch.stack([zero, -u[..., 2], u[..., 1], u[..., 2], zero, -u[..., 0],
                      -u[..., 1], u[..., 0], zero], -1).reshape(u.shape[:-1] + (3, 3))
    th = theta[..., None]
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    W2 = Wx @ Wx
    R = eye + torch.sin(th) * Wx + (1 - torch.cos(th)) * W2
    G = eye * th + (1 - torch.cos(th)) * Wx + (th - torch.sin(th)) * W2
    out = torch.zeros(u.shape[:-1] + (4, 4), dtype=w.dtype, device=w.device)
    out[..., :3, :3] = R
    out[..., :3, 3] = (G @ v[..., None])[..., 0]
    out[..., 3, 3] = 1.0
    return out


# ---------------------------------------------------------------------------
# cubic Hermite splines (dynamic positions)

def _hermite(t):
    s = 1.0 - t
    return (1 + 2 * t) * s * s, t * s * s, t * t * (3 - 2 * t), t * t * (t - 1)


def spline_eval(ctrl, t, n):
    """Per-point Hermite spline over n live knots of ``ctrl`` [P, K, 3] at
    normalised time t; tangents one-sided at the ends."""
    P = ctrl.shape[0]
    n = n.to(torch.int64)
    ts = t * (n - 1).to(ctrl.dtype)
    i = torch.minimum(torch.clamp(torch.floor(ts).to(torch.int64), min=0), n - 2)
    lo = torch.clamp(i - 1, min=0)
    hi = torch.minimum(i + 1, n - 1)
    hh = torch.minimum(i + 2, n - 1)
    rows = torch.arange(P, device=ctrl.device)
    p0, p1, p2, p3 = ctrl[rows, lo], ctrl[rows, i], ctrl[rows, hi], ctrl[rows, hh]
    m0 = torch.where((lo == i)[:, None], p2 - p1, 0.5 * (p2 - p0))
    m1 = torch.where((hh == hi)[:, None], p2 - p1, 0.5 * (p3 - p1))
    h00, h10, h01, h11 = _hermite((ts - i.to(ctrl.dtype))[:, None])
    return h00 * p1 + h10 * m0 + h01 * p2 + h11 * m1


def spline_fit(traj, times, n_knots):
    """Least-squares knots [P, n_knots, 3] of tracks [P, T, 3] sampled at
    ``times`` [T] (ridge 1e-8), through the Hermite basis above."""
    T = times.shape[0]
    A = torch.zeros((T, n_knots), dtype=torch.float64, device=traj.device)
    tt = times.to(torch.float64)
    for r in range(T):
        ts = float(tt[r]) * (n_knots - 1)
        i = min(max(int(math.floor(ts)), 0), n_knots - 2)
        lo, hi, hh = max(i - 1, 0), min(i + 1, n_knots - 1), min(i + 2, n_knots - 1)
        h00, h10, h01, h11 = _hermite(torch.tensor(ts - i, dtype=torch.float64))
        # p(t) = h00 p1 + h10 m0 + h01 p2 + h11 m1 as a row over the knots
        m0 = {hi: 1.0, i: -1.0} if lo == i else {hi: 0.5, lo: -0.5}
        m1 = {hi: 1.0, i: -1.0} if hh == hi else {hh: 0.5, i: -0.5}
        A[r, i] += float(h00)
        A[r, hi] += float(h01)
        for k, c in m0.items():
            A[r, k] += float(h10) * c
        for k, c in m1.items():
            A[r, k] += float(h11) * c
    AtA = A.T @ A + 1e-8 * torch.eye(n_knots, dtype=A.dtype, device=A.device)
    Atb = torch.einsum("tk,ptc->pkc", A, traj.to(torch.float64))
    return torch.linalg.solve(AtA[None], Atb).to(torch.float32)


# ---------------------------------------------------------------------------
# projection, tiles and the compositor

def project(means, quats, scales, w2c, K, W, H):
    """(means2d [N,2], conics [N,3], depths [N], radii [N] int64)."""
    Rcw, tcw = w2c[:3, :3], w2c[:3, 3]
    p = means @ Rcw.T + tcw
    x, y, z = p.unbind(-1)
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    zs = torch.clamp(z, min=0.01)
    limx, limy = 1.3 * 0.5 * W / fx, 1.3 * 0.5 * H / fy
    tx = zs * torch.clamp(x / zs, -limx, limx)
    ty = zs * torch.clamp(y / zs, -limy, limy)
    Rm = quat_to_rotmat(quats) * scales[:, None, :]
    cov = Rcw @ (Rm @ Rm.transpose(-1, -2)) @ Rcw.T
    J = torch.zeros((means.shape[0], 2, 3), dtype=means.dtype, device=means.device)
    J[:, 0, 0] = fx / zs
    J[:, 0, 2] = -fx * tx / (zs * zs)
    J[:, 1, 1] = fy / zs
    J[:, 1, 2] = -fy * ty / (zs * zs)
    c2 = J @ cov @ J.transpose(-1, -2)
    a = torch.clamp(c2[:, 0, 0] + 0.3, 0.0, 1e12)
    b = torch.clamp(c2[:, 0, 1], -1e12, 1e12)
    c = torch.clamp(c2[:, 1, 1] + 0.3, 0.0, 1e12)
    det = torch.clamp(a * c - b * b, min=1e-12)
    conics = torch.stack([c / det, -b / det, a / det], -1)
    m2d = torch.stack([fx * x / zs + cx, fy * y / zs + cy], -1)
    mid = 0.5 * (a + c)
    radius = torch.ceil(3.0 * torch.sqrt(mid + torch.sqrt(torch.clamp(mid * mid - det, min=0.1))))
    ok = ((z > 0.01) & (det > 1e-12) & (m2d[:, 0] + radius > 0) & (m2d[:, 0] - radius < W)
          & (m2d[:, 1] + radius > 0) & (m2d[:, 1] - radius < H))
    return m2d, conics, z, torch.where(ok, radius, 0.0).detach().to(torch.int64)


class Tiles:
    """The tile lists of one camera: each tile's front-most splats in depth
    order, as [T, Kmax] ids with per-tile counts."""

    def __init__(self, m2d, radii, depths, opac, W, H, tiles_per_gauss, max_per_tile):
        dev = m2d.device
        self.ntx, self.nty = -(-W // TILE), -(-H // TILE)
        T = self.ntx * self.nty
        with torch.no_grad():
            g = torch.nonzero((radii > 0) & (opac > 0))[:, 0]
            x, y = m2d[g, 0].float(), m2d[g, 1].float()
            r = radii[g].float()

            def tix(v, n):
                return torch.clamp(torch.floor(v / TILE), 0, n - 1).to(torch.int64)
            tx0, tx1 = tix(x - r, self.ntx), tix(x + r, self.ntx)
            ty0, ty1 = tix(y - r, self.nty), tix(y + r, self.nty)
            bw, bh = tx1 - tx0 + 1, ty1 - ty0 + 1
            side = int(tiles_per_gauss ** 0.5)
            over = bw * bh > tiles_per_gauss
            bw = torch.where(over, torch.clamp(bw, max=side), bw)
            bh = torch.where(over, torch.clamp(bh, max=side), bh)
            tx0 = torch.where(over, torch.clamp(tix(x, self.ntx) - (bw - 1) // 2, 0, self.ntx - 1), tx0)
            ty0 = torch.where(over, torch.clamp(tix(y, self.nty) - (bh - 1) // 2, 0, self.nty - 1), ty0)
            n = bw * bh
            rep = torch.repeat_interleave(torch.arange(g.shape[0], device=dev), n)
            off = torch.arange(rep.shape[0], device=dev) - (torch.cumsum(n, 0) - n)[rep]
            tx, ty = tx0[rep] + off % bw[rep], ty0[rep] + off // bw[rep]
            keep = (tx < self.ntx) & (ty < self.nty)
            rep, tile = rep[keep], (ty * self.ntx + tx)[keep]
            # the system's depth order: the top (31 - bits of the tile
            # count) bits of the positive float32 depth's bit pattern, ties
            # in index order
            shift = max(1, T.bit_length())
            dkey = (depths[g].detach().float().contiguous().view(torch.int32) >> shift)
            order = torch.sort(tile * (1 << 32) + dkey.to(torch.int64)[rep], stable=True).indices
            tile, gid = tile[order], g[rep[order]]
            counts = torch.bincount(tile, minlength=T)
            start = torch.cumsum(counts, 0) - counts
            rank = torch.arange(tile.shape[0], device=dev) - start[tile]
            self.raw_max = int(counts.max()) if counts.numel() else 0
            keep = rank < max_per_tile
            tile, gid, rank = tile[keep], gid[keep], rank[keep]
            self.counts = torch.clamp(counts, max=max_per_tile)
            kmax = max(int(self.counts.max()), 1)
            self.ids = torch.zeros((T, kmax), dtype=torch.int64, device=dev)
            self.ids[tile, rank] = gid
            self.live = torch.zeros((T, kmax), dtype=torch.bool, device=dev)
            self.live[tile, rank] = True
            self.n_entries = int(tile.shape[0])
        self.chunk = 128 if max_per_tile % 128 == 0 else 64

    def blocks(self):
        """Groups of tiles of similar list length (longest first), each
        group's padded entries x pixels within BLOCK_ELEMS: (tile ids,
        padded length)."""
        counts = self.counts.tolist()
        order = sorted(range(len(counts)), key=lambda t: -counts[t])
        out, cur = [], []
        for t in order:
            k = max(counts[cur[0]] if cur else counts[t], 1)
            if cur and (len(cur) + 1) * k * PIX > BLOCK_ELEMS:
                out.append((cur, max(counts[cur[0]], 1)))
                cur = []
            cur.append(t)
        out.append((cur, max(counts[cur[0]], 1)))
        return [(torch.tensor(ts, device=self.ids.device), k) for ts, k in out]


def _pixels(tiles, ntx, dt):
    lin = torch.arange(PIX, device=tiles.device)
    px = (tiles % ntx * TILE)[:, None].to(dt) + (lin % TILE).to(dt)[None] + 0.5
    py = (tiles // ntx * TILE)[:, None].to(dt) + (lin // TILE).to(dt)[None] + 0.5
    return px, py


def _alphas(m2d, conics, ids, live, px, py):
    m, q = m2d[ids], conics[ids]                                   # [Tb,Kb,2|3]
    dx = px[:, None, :] - m[..., 0:1]
    dy = py[:, None, :] - m[..., 1:2]
    sigma = 0.5 * (q[..., 0:1] * dx * dx + q[..., 2:3] * dy * dy) + q[..., 1:2] * dx * dy
    return torch.exp(-sigma), (sigma >= 0) & live[..., None]


def _chain(op, ids, e, gate):
    a = torch.clamp(op[ids][..., None] * e, max=ALPHA_MAX)
    return torch.where(gate & (a > ALPHA_MIN), a, torch.zeros((), dtype=a.dtype, device=a.device))


def _active(alphas, chunk):
    """[Tb, Kb] slots a tile composites before its chunk-level stop."""
    Kb = alphas[0].shape[1]
    ends = torch.clamp(torch.arange(chunk, Kb + chunk, chunk, device=alphas[0].device), max=Kb) - 1
    tmax = None
    for a in alphas:
        tm = torch.cumprod(1.0 - a, 1)[:, ends].amax(-1)
        tmax = tm if tmax is None else torch.maximum(tmax, tm)
    go = torch.cumprod((tmax > TRANS_EPS).to(torch.int64), 1)
    act = torch.cat([torch.ones_like(go[:, :1]), go[:, :-1]], 1).bool()
    return act.repeat_interleave(chunk, 1)[:, :Kb]


def _block(m2d, conics, op, sop, col, ids, live, px, py, chunk):
    e, gate = _alphas(m2d, conics, ids, live, px, py)
    a = _chain(op, ids, e, gate)
    a2 = _chain(sop, ids, e, gate) if sop is not None else None
    with torch.no_grad():
        act = _active([a] if a2 is None else [a, a2], chunk)[..., None]
    outs = []
    for x in ([a] if a2 is None else [a, a2]):
        x = x * act
        t = torch.cumprod(1.0 - x, 1)
        outs.append(x * torch.cat([torch.ones_like(t[:, :1]), t[:, :-1]], 1))
    res = torch.einsum("tkp,tkc->tpc", outs[0], col[ids])
    acc = outs[0].sum(1)
    if a2 is None:
        return res, acc
    return res, acc, outs[1].sum(1)


def composite(tiles: Tiles, m2d, conics, op, col, sop=None, work=None):
    """Composite every tile: (colour sums [T, P, C], weight sums [T, P],
    subset weight sums [T, P] or None). ``work``, a dict, receives what the
    inputs needed under the chunk-level stop: ``slots`` (slots composited),
    ``valid`` / ``valid_sub`` ((slot, pixel) pairs that passed the gates),
    ``n_ref`` (distinct splats read)."""
    dev, dt = col.device, col.dtype
    T = tiles.ntx * tiles.nty
    res = torch.zeros((T, PIX, col.shape[1]), dtype=dt, device=dev)
    acc = torch.zeros((T, PIX), dtype=dt, device=dev)
    sub = torch.zeros((T, PIX), dtype=dt, device=dev) if sop is not None else None
    grad = torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in (m2d, conics, op, col, sop))
    used = torch.zeros(col.shape[0], dtype=torch.bool, device=dev) if work is not None else None
    for sel, kb in tiles.blocks():
        ids, live = tiles.ids[sel, :kb], tiles.live[sel, :kb]
        px, py = _pixels(sel, tiles.ntx, dt)
        args = (m2d, conics, op, sop, col, ids, live, px, py, tiles.chunk)
        if grad:
            out = checkpoint(_block, *args, use_reentrant=False)
        else:
            out = _block(*args)
        res = res.index_copy(0, sel, out[0])
        acc = acc.index_copy(0, sel, out[1])
        if sop is not None:
            sub = sub.index_copy(0, sel, out[2])
        if work is not None:
            with torch.no_grad():
                e, gate = _alphas(m2d, conics, ids, live, px, py)
                al = [_chain(op, ids, e, gate)] + ([_chain(sop, ids, e, gate)] if sop is not None else [])
                act = _active(al, tiles.chunk) & live
                work["slots"] = work.get("slots", 0) + int(act.sum())
                work["valid"] = work.get("valid", 0) + int(((al[0] > 0) & act[..., None]).sum())
                if sop is not None:
                    work["valid_sub"] = work.get("valid_sub", 0) + int(((al[1] > 0) & act[..., None]).sum())
                used[ids[act]] = True
    if work is not None:
        work["n_ref"] = int(used.sum())
        work["tiles"] = T
    return res, acc, sub


def untile(x, tiles: Tiles, W, H):
    C = x.shape[-1]
    x = x.reshape(tiles.nty, tiles.ntx, TILE, TILE, C).permute(0, 2, 1, 3, 4)
    return x.reshape(tiles.nty * TILE, tiles.ntx * TILE, C)[:H, :W]


def rasterize(geom, w2c, K, W, H, budgets, colors=None, bg=None, depth=True,
              alpha=True, sub_mask=None, work=None):
    """One camera: projection, tile lists and the composite of the colour
    columns (``colors``, default the geometry's), with the expected depth
    and the weight column when asked, the subset chain over
    ``opacity * sub_mask``. Returns dict(image [H,W,C], alpha, depth,
    sub_alpha, means2d, radii, tiles)."""
    means, quats, scales, opac = geom["means"], geom["quats"], geom["scales"], geom["opacity"]
    colors = geom["colors"] if colors is None else colors
    m2d, conics, z, radii = project(means, quats, scales, w2c, K, W, H)
    tiles = Tiles(m2d, radii, z, opac, W, H, *budgets)
    ext = [colors]
    if depth:
        ext.append(z[:, None])
    if alpha:
        ext.append(torch.ones_like(z)[:, None])
    col = torch.cat(ext, 1)
    sop = None if sub_mask is None else opac * sub_mask
    out, _, out2 = composite(tiles, m2d, conics, opac, col, sop, work)
    if work is not None:
        work.update(CE=col.shape[1], sub=sop is not None, N=means.shape[0],
                    entries=tiles.n_entries)
    full = untile(out, tiles, W, H)
    C = colors.shape[1]
    image = full[..., :C]
    zeros = torch.zeros(image.shape[:2], dtype=image.dtype, device=image.device)
    a = torch.clamp(full[..., C + int(depth)], max=1.0) if alpha else zeros
    if bg is not None:
        image = image + bg * (1.0 - a[..., None])
    d = full[..., C] / torch.clamp(a, min=1e-10) if depth else zeros
    sub = (torch.clamp(untile(out2[..., None], tiles, W, H)[..., 0], max=1.0)
           if out2 is not None else None)
    return dict(image=image, alpha=a, depth=d, sub_alpha=sub, means2d=m2d,
                radii=radii, tiles=tiles)


# the system's init validation of the raster budgets: the tile-box span
# ladder, the capacity ladder and the agreement its composites must reach
SPAN_LADDER = (9, 16, 25, 36, 64)
SPAN_QUANTILE = 0.995
CAPACITY_LADDER = (256, 384, 512, 1024, 1536, 2048)
MIN_PSNR_DB = 60.0


@torch.no_grad()
def validated_budgets(P, w2c, K, W, H, t, max_time, base):
    """The budgets the system's init validation chooses, worked out on the
    reference's own projection and composites of one view: the least span
    of the ladder (at least ``base``'s) that covers the tile box of the
    ``SPAN_QUANTILE`` splat radius, then the least capacity of the ladder
    (at least ``base``'s) whose composite agrees with the ladder's top to
    ``MIN_PSNR_DB``. Returns (tiles_per_gauss, max_per_tile)."""
    g = assemble(P, torch.as_tensor(t, device=w2c.device), max_time)
    radii = project(g["means"], g["quats"], g["scales"], w2c, K, W, H)[3]
    r = radii[radii > 0].double().cpu().numpy()
    span = base[0]
    if r.size:
        side = math.ceil(2.0 * float(np.quantile(r, SPAN_QUANTILE)) / TILE) + 1
        span = max(span, next((b for b in SPAN_LADDER if b >= side * side), SPAN_LADDER[-1]))
    hi = CAPACITY_LADDER[-1]

    def image(k):
        return rasterize(g, w2c, K, W, H, (span, k), depth=False, alpha=False)["image"]
    top = image(hi)
    for k in CAPACITY_LADDER:
        if k < base[1]:
            continue
        if k == hi:
            break
        mse = float(torch.mean((image(k) - top) ** 2))
        if 10.0 * math.log10(1.0 / max(mse, 1e-12)) >= MIN_PSNR_DB:
            return span, k
    return span, hi


# ---------------------------------------------------------------------------
# the scene: assembled Gaussians, the decoder, the latent poses

def assemble(P, t, max_time, delta=None):
    """The static pool then the dynamic pool at time t, shifted by
    ``delta`` / max_time (positions from the knots at the clamped time,
    rotation q + dt omega, features [dc | dt f_t], dt = t' - trbf_center
    with no gradient)."""
    s, d = P["stat"], P["dyn"]
    t_eff = t if delta is None else t + delta / max_time
    dt = (t_eff - d["trbf_center"]).detach()
    d_means = spline_eval(d["control_xyz"], torch.clamp(t_eff, 0.0, 1.0),
                          P["dyn_control_num"]) * SPLINE_SCALE
    Ms, Md = s["xyz"].shape[0], d["xyz"].shape[0]
    ones = torch.ones(Ms, dtype=torch.float32, device=s["xyz"].device)
    return dict(
        means=torch.cat([s["xyz"], d_means]),
        quats=torch.cat([normalize(s["rotation"]), normalize(d["rotation"] + dt * d["omega"])]),
        scales=torch.exp(torch.cat([s["scaling"], d["scaling"]])),
        opacity=torch.cat([torch.sigmoid(s["opacity"][:, 0]) * P["stat_live"],
                           torch.sigmoid(d["opacity"][:, 0]) * P["dyn_live"]]),
        colors=torch.cat([torch.cat([s["features_dc"], 0.0 * s["features_t"]], 1),
                          torch.cat([d["features_dc"], dt * d["features_t"]], 1)]),
        dyn_mask=torch.cat([torch.zeros_like(ones), torch.ones(Md, dtype=torch.float32, device=ones.device)]),
    )


def cam_rays(w2c, K, W, H):
    c2w = rigid_inverse(w2c)
    yy, xx = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=w2c.device),
                            torch.arange(W, dtype=torch.float32, device=w2c.device), indexing="ij")
    loc = torch.stack([(xx + 0.5 - K[0, 2]) / K[0, 0], (yy + 0.5 - K[1, 2]) / K[1, 1],
                       torch.ones_like(xx)], -1)
    d = normalize(normalize(loc) @ c2w[:3, :3].T)
    return torch.cat([c2w[:3, 3].expand(d.shape), d], -1)


def decode(sw, feat9, rays):
    """Sandwich decoder: sigmoid(albedo + relu([spec | time | ray] w1) w2)."""
    x = torch.cat([feat9[..., 3:9], rays], -1)
    return torch.sigmoid(feat9[..., 0:3] + torch.relu(x @ sw["w1"]) @ sw["w2"])


def latent_poses(bl, expo_scale, c2w, bf, v, E):
    """BLCE: E latent camera-to-world poses inside view v's exposure and
    their exposure-time shifts (an Euler-integrated ODE over a view
    embedding, a pose encoding and the blur feature's encoding)."""
    p = {k: x[v] for k, x in bl.items()}
    D = p["view_embed"].shape[-1]
    Hh = D // 2
    ang = bf * (2.0 ** torch.arange(NUM_FREQS, dtype=torch.float32, device=c2w.device)) * math.pi
    h = torch.cat([bf[None], torch.sin(ang), torch.cos(ang)])
    h = torch.relu(h @ p["bf_w0"] + p["bf_b0"])
    h = torch.relu(h @ p["bf_w1"] + p["bf_b1"])
    bfe = h @ p["bf_w2"] + p["bf_b2"]
    x = torch.cat([p["view_embed"], c2w[:3, :].reshape(-1) @ p["rt_w"] + p["rt_b"]]) @ p["venc_w"] + p["venc_b"]
    xs = [x]
    for t in range(E - 1):
        r = torch.relu(x)
        te = p["time_embed"][min(t, p["time_embed"].shape[0] - 1)]
        x = x + torch.cat([torch.cat([r[:Hh], te, bfe]) @ p["w_lin_w"] + p["w_lin_b"],
                           torch.cat([r[Hh:], te, bfe]) @ p["v_lin_w"] + p["v_lin_b"]])
        xs.append(x)
    xs = torch.stack(xs)
    lw, lv = xs[:, :Hh], xs[:, Hh:]
    delta = se3_exp(lw @ p["rot_w"] + p["rot_b"], lv @ p["trans_w"] + p["trans_b"],
                    lw @ p["theta_w"] + p["theta_b"])
    expo = torch.linspace(-1.0, 1.0, E, dtype=torch.float32, device=c2w.device) * expo_scale[v]
    return c2w @ delta, expo


def blur_feature(img):
    gray = 0.299 * img[..., 0] + 0.587 * img[..., 1] + 0.114 * img[..., 2]
    mag = torch.abs(torch.fft.fftshift(torch.fft.fft2(gray)))
    h, w = mag.shape
    return mag[h // 2 - 10:h // 2 + 10, w // 2 - 10:w // 2 + 10].sum() / mag.sum()


# ---------------------------------------------------------------------------
# losses

def ssim(a, b):
    """SSIM of [B, C, H, W] images: 11x11 Gaussian window (sigma 1.5), zero
    padding, per channel."""
    x = torch.arange(11, dtype=torch.float64) - 5
    g = torch.exp(-x * x / 4.5)
    g = (g / g.sum()).to(torch.float32)
    C = a.shape[1]
    w = (g[:, None] * g[None, :]).expand(C, 1, 11, 11).contiguous().to(a.device)

    def blur(t):
        return F.conv2d(t, w, padding=5, groups=C)
    mu1, mu2 = blur(a), blur(b)
    s1, s2, s12 = blur(a * a) - mu1 * mu1, blur(b * b) - mu2 * mu2, blur(a * b) - mu1 * mu2
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    return (((2 * mu1 * mu2 + c1) * (2 * s12 + c2))
            / ((mu1 * mu1 + mu2 * mu2 + c1) * (s1 + s2 + c2))).mean()


def masked_l1(x, y, m):
    m = m.expand(y.shape)
    return torch.abs((x - y) * m).sum() / (m.sum() + 1e-8)


def warp(img, coords, W, H):
    """img [E, H, W, C] sampled at pixel coordinates [E, H, W, 2]: bilinear,
    border padding, align_corners=False, on the coordinates normalised as
    c / (S - 1) * 2 - 1."""
    grid = torch.stack([coords[..., 0] / (W - 1) * 2 - 1, coords[..., 1] / (H - 1) * 2 - 1], -1)
    out = F.grid_sample(img.permute(0, 3, 1, 2), grid, mode="bilinear",
                        padding_mode="border", align_corners=False)
    return out.permute(0, 2, 3, 1)


def flow_loss(mid, lat, lat_alpha, d_alpha, e2m, m2e, W, H):
    E = lat.shape[0]
    rep = mid[None].expand((E,) + mid.shape)
    t1 = masked_l1(warp(rep, e2m, W, H), lat, lat_alpha[..., None])
    t2 = masked_l1(warp(lat, m2e, W, H), rep, d_alpha[None, ..., None].expand(E, H, W, 1))
    return t1 + t2


# ---------------------------------------------------------------------------
# the step

def pixel_grid(W, H, dev):
    yy, xx = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=dev),
                            torch.arange(W, dtype=torch.float32, device=dev), indexing="ij")
    return torch.stack([xx, yy], -1)


def _recorder(works, grad):
    """``rasterize`` that appends each composite's work to ``works``
    (a list) when given."""
    def rz(*a, **k):
        if works is None:
            return rasterize(*a, **k)
        w = {"grad": grad}
        out = rasterize(*a, work=w, **k)
        works.append(w)
        return out
    return rz


def forward(P, batch, cfg, budgets, works=None):
    """The step's loss: per view E-1 latent renders at BLCE's poses and
    exposure shifts, the mid render (depth, weight, the dynamic subset's
    alpha), with flow on the exposure-flow passes and the warp loss; the
    blurry prediction's L1 and SSIM, depth L1, alpha entropy and sparsity.
    ``works``, a list, receives the work of every composite."""
    rasterize = _recorder(works, True)
    W, H, E, mt = cfg["width"], cfg["height"], cfg["num_warp"], cfg["max_time"]
    half = E // 2
    others = [e for e in range(E) if e != half]
    flow_on = cfg["lambda_flow_loss"] > 0
    dev = P["stat"]["xyz"].device
    preds, depths, d_alphas, flows = [], [], [], []
    for b in range(batch["view"].shape[0]):
        v = int(batch["view"][b])
        w2c, K, t = batch["w2c"][b], batch["K"][b], batch["time"][b]
        rays = cam_rays(w2c, K, W, H)
        lat_c2w, expo = latent_poses(P["blce"], P["exposure"], rigid_inverse(w2c),
                                     batch["blur"][b], v, E)
        lat_w2c = rigid_inverse(lat_c2w)
        lats, f_img, f_alpha, f_e2m, f2d = [], {}, {}, {}, {}
        if flow_on:
            g_mid = assemble(P, t, mt)
            mid2d = project(g_mid["means"], g_mid["quats"], g_mid["scales"], w2c, K, W, H)[0].detach()
        for e in others:
            g = assemble(P, t, mt, expo[e])
            out = rasterize(g, lat_w2c[e], K, W, H, budgets, depth=False, alpha=False)
            lats.append(decode(P["sandwich"], out["image"], cam_rays(lat_w2c[e], K, W, H)))
            if not flow_on:
                continue
            g = assemble(P, t, mt, torch.tensor((e - half) / half, device=dev))
            fl = (mid2d - project(g["means"], g["quats"], g["scales"], w2c, K, W, H)[0]).detach()
            col = torch.cat([g["colors"], fl], 1)
            out = rasterize(g, w2c, K, W, H, budgets, colors=col, depth=False,
                            alpha=False, sub_mask=g["dyn_mask"])
            f_img[e] = decode(P["sandwich"], out["image"][..., :9], rays)
            f_alpha[e], f_e2m[e], f2d[e] = out["sub_alpha"], out["image"][..., 9:], fl
        g = assemble(P, t, mt)
        col = g["colors"]
        if flow_on:
            fl = torch.stack([f2d[e] if e != half else torch.zeros_like(f2d[others[0]])
                              for e in range(E)])                      # [E, N, 2]
            col = torch.cat([col, (-fl).permute(1, 0, 2).reshape(-1, 2 * E)], 1)
        bg = torch.zeros(col.shape[1], dtype=torch.float32, device=dev)
        mid = rasterize(g, w2c, K, W, H, budgets, colors=col, bg=bg, sub_mask=g["dyn_mask"])
        mid_img = decode(P["sandwich"], mid["image"][..., :9], rays)
        preds.append((torch.stack(lats).sum(0) + mid_img) / E + 1e-10)
        depths.append(mid["depth"])
        d_alphas.append(mid["sub_alpha"])
        if flow_on:
            pix = pixel_grid(W, H, dev)
            m2e = mid["image"][..., 9:].reshape(H, W, E, 2).permute(2, 0, 1, 3)
            zero = torch.zeros((H, W, 2), dtype=torch.float32, device=dev)
            lat_f = torch.stack([f_img[e] if e != half else mid_img for e in range(E)])
            lat_a = torch.stack([f_alpha[e] if e != half else mid["sub_alpha"] for e in range(E)])
            e2m = torch.stack([f_e2m[e] if e != half else zero for e in range(E)])
            flows.append(flow_loss(mid_img, lat_f, lat_a, mid["sub_alpha"], pix + e2m, pix + m2e, W, H))
    pred = torch.stack(preds).permute(0, 3, 1, 2)
    gt = batch["image"].permute(0, 3, 1, 2)
    photo = torch.abs(pred - gt).mean()
    if cfg["lambda_dssim"]:
        photo = photo + cfg["lambda_dssim"] * (1.0 - ssim(pred, gt))
    depth_l1 = torch.abs(torch.stack(depths) - batch["depth"]).mean()
    da = torch.clamp(torch.stack(d_alphas), 0.0, 1.0)
    ent = -(da * torch.log(da + 1e-6) + (1 - da) * torch.log(1 - da + 1e-6)).sum()
    mask = 1e-7 * (ent + (torch.stack(d_alphas) ** 2).sum())
    total = photo + 0.2 * depth_l1 + mask
    if flow_on:
        total = total + cfg["lambda_flow_loss"] * torch.stack(flows).sum()
    return total


GAUSS_FIELDS = ("xyz", "control_xyz", "features_dc", "features_rest", "features_t",
                "scaling", "rotation", "opacity", "omega", "motion", "zeta",
                "trbf_center", "trbf_scale")
BLCE_FIELDS = ("view_embed", "bf_w0", "bf_b0", "bf_w1", "bf_b1", "bf_w2", "bf_b2",
               "rt_w", "rt_b", "venc_w", "venc_b", "time_embed", "w_lin_w", "w_lin_b",
               "v_lin_w", "v_lin_b", "rot_w", "rot_b", "trans_w", "trans_b",
               "theta_w", "theta_b")


def leaves(P):
    """(name, tensor) of every optimised leaf, in a fixed order."""
    out = [(f"stat.{k}", P["stat"][k]) for k in GAUSS_FIELDS]
    out += [(f"dyn.{k}", P["dyn"][k]) for k in GAUSS_FIELDS]
    out += [(f"sandwich.{k}", P["sandwich"][k]) for k in ("w1", "w2")]
    out += [(f"blce.{k}", P["blce"][k]) for k in BLCE_FIELDS]
    return out


def _expon_lr(step, lr0, lr1, max_steps):
    f32 = np.float32
    t = np.clip(f32(step) / f32(max_steps), f32(0), f32(1))
    return float(np.exp(np.log(f32(lr0)) * (f32(1) - t) + np.log(f32(lr1)) * t))


def learning_rates(cfg, step):
    """Each leaf's rate at ``step`` (the Gaussian fields' schedule, the
    decoder's constant rate, BLCE's decayed rate)."""
    o, s = cfg["opt"], cfg["extent"]
    g = dict(xyz=_expon_lr(step, o["position_lr_init"] * s, o["position_lr_final"] * s,
                           o["position_lr_max_steps"]),
             control_xyz=10.0 * o["position_lr_init"] * s, features_dc=o["feature_lr"],
             features_rest=o["feature_lr"] / 20.0, features_t=o["featuret_lr"],
             scaling=o["scaling_lr"], rotation=o["rotation_lr"], opacity=o["opacity_lr"],
             omega=o["omega_lr"], motion=o["position_lr_init"] * s * 0.5 * o["movelr"],
             zeta=o["zeta_lr"], trbf_center=o["trbfc_lr"], trbf_scale=o["trbfs_lr"])
    f32 = np.float32
    blce = float(f32(1e-4) * f32(0.01) ** (f32(step) / f32(o["iterations"])))
    lr = {f"{p}.{k}": v for p in ("stat", "dyn") for k, v in g.items()}
    lr.update({f"sandwich.{k}": o["rgb_lr"] for k in ("w1", "w2")})
    lr.update({f"blce.{k}": blce for k in BLCE_FIELDS})
    return lr


def train_step(P, adam, batch, cfg, budgets, step):
    """One update at iteration ``step``: the loss, the gradients of every
    leaf (BLCE's clipped to global norm 1) and Adam (eps 1e-15) in place.
    Returns (loss, {leaf: gradient as the optimiser got it})."""
    named = leaves(P)
    for _, x in named:
        x.requires_grad_(True)
    with torch.enable_grad():
        loss = forward(P, batch, cfg, budgets)
        grads = torch.autograd.grad(loss, [x for _, x in named], allow_unused=True)
    grads = {n: torch.zeros_like(x) if g is None else g for (n, x), g in zip(named, grads)}
    with torch.no_grad():
        bl = [n for n, _ in named if n.startswith("blce.")]
        gn = torch.sqrt(sum((grads[n] * grads[n]).sum() for n in bl) + 1e-20)
        sc = torch.where(torch.isfinite(gn), torch.clamp(1.0 / gn, max=1.0), torch.zeros_like(gn))
        for n in bl:
            grads[n] = grads[n] * sc
        lrs = learning_rates(cfg, step)
        adam["t"] += 1
        f32 = np.float32
        bc1 = float(f32(1) - f32(0.9) ** f32(adam["t"]))
        bc2 = float(f32(1) - f32(0.999) ** f32(adam["t"]))
        for n, x in named:
            m = adam["m"].setdefault(n, torch.zeros_like(x))
            v = adam["v"].setdefault(n, torch.zeros_like(x))
            g = grads[n]
            m.mul_(0.9).add_(0.1 * g)
            v.mul_(0.999).add_(0.001 * g * g)
            x.sub_(lrs[n] * (m / bc1) / (torch.sqrt(v / bc2) + 1e-15))
    for _, x in named:
        x.requires_grad_(False)
    return float(loss.detach()), grads


@torch.no_grad()
def exposure_update(P, batch, nbr, cfg, budgets, works=None):
    """Re-estimate the batch views' exposure scale: the median, over pixels
    above the 1 % quantile of the neighbour-view flow, of the ratio of the
    latent window's static flow to the frame-to-frame static flow, halved at
    the sequence's ends, kept where not finite."""
    rasterize = _recorder(works, False)
    W, H, E = cfg["width"], cfg["height"], cfg["num_warp"]
    s = P["stat"]
    g = dict(means=s["xyz"], quats=normalize(s["rotation"]), scales=torch.exp(s["scaling"]),
             opacity=torch.sigmoid(s["opacity"][:, 0]) * P["stat_live"])
    V = P["exposure"].shape[0]
    new = P["exposure"].clone()
    for b in range(batch["view"].shape[0]):
        v = int(batch["view"][b])
        w2c, K = batch["w2c"][b], batch["K"][b]
        lat, _ = latent_poses(P["blce"], P["exposure"], rigid_inverse(w2c), batch["blur"][b], v, E)
        lat = rigid_inverse(lat)

        def flow(src, dst):
            f = (project(g["means"], g["quats"], g["scales"], src, K, W, H)[0]
                 - project(g["means"], g["quats"], g["scales"], dst, K, W, H)[0])
            return rasterize(g, w2c, K, W, H, budgets, colors=f)["image"]
        cam = torch.linalg.norm(flow(nbr[max(v - 1, 0)], nbr[min(v + 1, V - 1)]), dim=-1).reshape(-1)
        latf = torch.linalg.norm(flow(lat[0], lat[-1]), dim=-1).reshape(-1)
        q = torch.quantile(cam, 0.01)
        ratio = torch.where(cam > q, latf / torch.clamp(cam, min=1e-12),
                            torch.full_like(cam, float("nan")))
        est = torch.nanquantile(ratio, 0.5)
        if v in (0, V - 1):
            est = est * 0.5
        new[v] = est if bool(torch.isfinite(est)) else P["exposure"][v]
    P["exposure"] = new


@torch.no_grad()
def view_render(P, w2c, K, W, H, max_time, budgets, t=0.5, works=None):
    """The viewer's image: the combined scene at time t, black background,
    decoded."""
    g = assemble(P, torch.tensor(t, device=w2c.device), max_time)
    bg = torch.zeros(9, dtype=torch.float32, device=w2c.device)
    out = _recorder(works, False)(g, w2c, K, W, H, budgets, bg=bg)
    return decode(P["sandwich"], out["image"], cam_rays(w2c, K, W, H))
