"""Cubic-Hermite spline engine (port of ``mobgs_tpu/core/spline.py``).

Per-point splines over a fixed maximum knot count ``K`` with a live knot
count ``n`` per point, one-sided boundary derivatives, the shared
design-matrix least-squares fit used at init, and the knot-prune
controller (refit with one knot fewer, gated on the reprojection error).
"""

from __future__ import annotations

import numpy as np
import torch


def hermite_basis(t: torch.Tensor):
    """Cubic Hermite basis functions h00, h10, h01, h11 at local t∈[0,1]."""
    one_m_t = 1.0 - t
    h00 = (1.0 + 2.0 * t) * one_m_t * one_m_t
    h10 = t * one_m_t * one_m_t
    h01 = t * t * (3.0 - 2.0 * t)
    h11 = t * t * (t - 1.0)
    return h00, h10, h01, h11


def _segment_indices(times_scaled: torch.Tensor, n: torch.Tensor):
    """Knot indices (left, i, right, right-right) for scaled times: the
    segment index is clipped to [0, n-2] and neighbours to [0, n-1]."""
    idx = torch.clamp(torch.floor(times_scaled).to(torch.int32),
                      min=torch.zeros_like(n), max=n - 2)
    zero = torch.zeros_like(idx)
    left = torch.clamp(idx - 1, min=zero, max=n - 1)
    right = torch.clamp(idx + 1, min=zero, max=n - 1)
    rright = torch.clamp(idx + 2, min=zero, max=n - 1)
    return idx, left, right, rright


def eval_spline(control: torch.Tensor, t, n: torch.Tensor) -> torch.Tensor:
    """Evaluate per-point cubic Hermite splines.

    Args:
      control: ``[P, K, C]`` control points (K = max knot capacity).
      t: scalar, ``[P]`` or ``[P, 1]`` normalized time in [0, 1]; or
        ``[V, 1, 1]``, V times at which every point is evaluated.
      n: ``[P]`` or ``[P, 1]`` int live knot count per point (4 ≤ n ≤ K).

    Returns:
      ``[P, C]`` interpolated values (``[V, P, C]`` for V times).
    """
    P, K, C = control.shape
    t = torch.as_tensor(t, dtype=control.dtype, device=control.device)
    lead = tuple(t.shape[:-2]) if t.ndim > 2 else ()
    t = t.reshape(lead + (-1,)).expand(lead + (P,)) if t.ndim else t.expand(P)
    n = torch.as_tensor(n, device=control.device).to(torch.int32)
    n = n.reshape(-1).expand(P)

    ts = t * (n - 1).to(control.dtype)  # [..., P]
    idx, left, right, rright = _segment_indices(ts, n)

    def take(i):  # [..., P] -> [..., P, C]
        j = i.long().reshape(-1, P).T                                 # [P, L]
        out = torch.gather(control, 1, j[:, :, None].expand(P, j.shape[1], C))
        return out.transpose(0, 1).reshape(i.shape + (C,))

    p0, p1, p2, p3 = take(left), take(idx), take(right), take(rright)

    # one-sided derivatives at segment boundaries
    at_left_edge = (left == idx)[..., None]
    at_right_edge = (rright == right)[..., None]
    m0 = torch.where(at_left_edge, p2 - p1, (p2 - p0) * 0.5)
    m1 = torch.where(at_right_edge, p2 - p1, (p3 - p1) * 0.5)

    tfrac = (ts - idx.to(control.dtype))[..., None]
    h00, h10, h01, h11 = hermite_basis(tfrac)
    return h00 * p1 + h10 * m0 + h01 * p2 + h11 * m1


def design_matrix(times: torch.Tensor, n, K: int) -> torch.Tensor:
    """Hermite design matrix rows: ``[..., T, K]`` with
    ``A @ control ≈ curve`` (times ``[..., T]``, n broadcastable)."""
    dt = torch.float32
    times = torch.as_tensor(times, dtype=dt)
    n = torch.as_tensor(n, device=times.device).to(torch.int32)
    ts = times * (n - 1).to(dt)
    n = n.expand(ts.shape) if n.ndim < ts.ndim or n.shape != ts.shape \
        else n
    idx, left, right, rright = _segment_indices(ts, n)
    tf = ts - idx.to(dt)
    h00, h10, h01, h11 = hermite_basis(tf)

    at_left = left == idx
    at_right = rright == right
    zero = torch.zeros_like(h00)
    c_idx = (h00 + torch.where(at_left, -h10, zero)
             + torch.where(at_right, -h11, -h11 * 0.5))
    c_left = torch.where(at_left, zero, -h10 * 0.5)
    c_right = (h01 + torch.where(at_left, h10, h10 * 0.5)
               + torch.where(at_right, h11, zero))
    c_rright = torch.where(at_right, zero, h11 * 0.5)

    cols = torch.arange(K, dtype=torch.int32, device=times.device)
    A = torch.zeros(ts.shape + (K,), dtype=dt, device=times.device)
    for i, c in ((idx, c_idx), (left, c_left), (right, c_right),
                 (rright, c_rright)):
        A = A + torch.where(cols == i[..., None], c[..., None],
                            torch.zeros((), dtype=dt, device=times.device))
    return A


def fit_spline_shared(traj: torch.Tensor, times: torch.Tensor, n_pts: int,
                      K: int, ridge: float = 1e-8) -> torch.Tensor:
    """Fit control points when all points share times and knot count.

    One shared ``[T, n_pts]`` design matrix, so the fit is one small
    solve for all P points.

    Args:
      traj: ``[P, T, C]`` trajectories.
      times: ``[T]`` sample times in [0, 1].
      n_pts: live knot count (same for every point).
      K: max knot capacity (output columns; trailing K - n_pts are zero).

    Returns:
      ``[P, K, C]`` fitted control points.
    """
    A = design_matrix(times.to(traj.device), n_pts, n_pts)  # [T, n_pts]
    AtA = A.T @ A + ridge * torch.eye(n_pts, dtype=A.dtype, device=A.device)
    Atb = torch.einsum("tk,ptc->pkc", A, traj)
    sol = torch.linalg.solve(AtA[None], Atb)  # [P, n_pts, C]
    if n_pts < K:
        pad = torch.zeros((traj.shape[0], K - n_pts, sol.shape[-1]),
                          dtype=sol.dtype, device=sol.device)
        sol = torch.cat([sol, pad], dim=1)
    return sol


def design_row_np(t: float, n_pts: int, K: int) -> np.ndarray:
    """One row of the Hermite design matrix (numpy, host-side helper)."""
    row = np.zeros(K, np.float64)
    ts = t * (n_pts - 1)
    idx = int(np.clip(np.floor(ts), 0, n_pts - 2))
    left = max(idx - 1, 0)
    right = min(idx + 1, n_pts - 1)
    rright = min(idx + 2, n_pts - 1)
    tf = ts - idx
    h00 = (1 + 2 * tf) * (1 - tf) ** 2
    h10 = tf * (1 - tf) ** 2
    h01 = tf * tf * (3 - 2 * tf)
    h11 = tf * tf * (tf - 1)
    row[idx] += h00
    row[right] += h01
    if left == idx:  # boundary: m0 = p2 - p1
        row[right] += h10
        row[idx] -= h10
    else:  # m0 = (p2 - p0)/2
        row[right] += h10 / 2
        row[left] -= h10 / 2
    if rright == right:  # boundary: m1 = p2 - p1
        row[right] += h11
        row[idx] -= h11
    else:  # m1 = (p3 - p1)/2
        row[rright] += h11 / 2
        row[idx] -= h11 / 2
    return row


def project_points(pts: torch.Tensor, w2c: torch.Tensor,
                   K_mat: torch.Tensor) -> torch.Tensor:
    """World points -> pixel coordinates (the reference's ``pts2pixel``:
    the w2c transform, then K, with its 1e-7 z-guard)."""
    cam = pts @ w2c[:3, :3].T + w2c[:3, 3]
    pix = cam @ K_mat.T
    return pix[..., :2] / (pix[..., 2:3] + 1e-7)


def compute_prune_error(control: torch.Tensor, n_cur: torch.Tensor,
                        new_control: torch.Tensor, n_new: torch.Tensor,
                        view_w2c: torch.Tensor, view_times: torch.Tensor,
                        focal: float, width: int, height: int,
                        pos_scale: float = 1e-2) -> torch.Tensor:
    """Mean reprojection error of the pruned spline against the current one
    (``spline.py:191-227``): over the INTERIOR views (the reference skips
    the first and last), both splines at the view's time, times 1e-2,
    projected through K = [[f,0,W/2],[0,f,H/2],[0,0,1]], the per-point 2-D
    L2 distances averaged. control/new_control ``[P, K, 3]``, n_cur/n_new
    ``[P]``, view_w2c ``[V, 4, 4]`` (V ≥ 3), view_times ``[V]``; returns
    ``[P]``."""
    K_mat = torch.tensor([[focal, 0.0, width / 2.0],
                          [0.0, focal, height / 2.0],
                          [0.0, 0.0, 1.0]], dtype=control.dtype,
                         device=control.device)
    V = view_w2c.shape[0]
    errs = []
    for v in range(1, V - 1):  # interior views only
        t = view_times[v]
        old3d = eval_spline(control, t, n_cur) * pos_scale
        new3d = eval_spline(new_control, t, n_new) * pos_scale
        old2d = project_points(old3d, view_w2c[v], K_mat)
        new2d = project_points(new3d, view_w2c[v], K_mat)
        errs.append(torch.linalg.norm(old2d - new2d, dim=-1))
    return torch.stack(errs, 0).mean(0)


def onedown_control_pts(control: torch.Tensor, n_cur: torch.Tensor,
                        view_w2c: torch.Tensor, view_times: torch.Tensor,
                        focal: float, width: int, height: int,
                        error_threshold: float):
    """Knot-prune controller (``spline.py:230-252``): refit every spline
    with one control point fewer and keep the refit where the reprojection
    error stays under ``error_threshold``. Returns (control', n_cur',
    n_accepted). Points at the 4-knot floor target n_new = 4, so an
    accepted swap re-solves them at the same count. A refit that comes out
    non-finite has a NaN error and is rejected (``NaN <= thr`` is false):
    the point keeps its knots."""
    K = control.shape[1]
    n_cur = torch.as_tensor(n_cur, device=control.device).to(torch.int32).reshape(-1)
    n_new = torch.clamp(n_cur - 1, min=4)
    new_control = refit_spline_pruned(control, n_cur, K)
    err = compute_prune_error(control, n_cur, new_control, n_new,
                              view_w2c, view_times, focal, width, height)
    accept = err <= error_threshold
    control_out = torch.where(accept[:, None, None], new_control, control)
    n_out = torch.where(accept, n_new, n_cur)
    return control_out, n_out, torch.sum(accept)


def refit_spline_pruned(control: torch.Tensor, n_cur: torch.Tensor,
                        K: int, ridge: float = 1e-6) -> torch.Tensor:
    """Refit each spline with one control point fewer (``spline.py:255-299``).

    The current knots are the curve's samples at times j / (n_cur - 1); a
    design matrix with max(n_cur - 1, 4) live columns is assembled, the rows
    past the live sample count replaced by a shifted identity so the system
    stays well-posed, and the [P, K, K] normal equations (ridge 1e-6) are
    solved per point. ``solve_ex`` does not raise on a singular or
    non-finite system, as ``jnp.linalg.solve`` does not: such a point's
    refit comes out non-finite and the caller's gate rejects it.

    Args:
      control: ``[P, K, C]`` current control points.
      n_cur: ``[P]`` current live knot counts.
      K: capacity.

    Returns:
      ``[P, K, C]`` refitted control points, the columns at and past the
      new knot count zeroed (the caller updates the counts).
    """
    dev = control.device
    n_cur = torch.as_tensor(n_cur, device=dev).to(torch.int32).reshape(-1)
    n_new = torch.clamp(n_cur - 1, min=4)

    j = torch.arange(K, dtype=torch.float32, device=dev)[None, :]   # [1, K]
    t_samples = j / (n_cur[:, None] - 1).to(torch.float32)        # [P, K]
    A = design_matrix(t_samples, n_new[:, None], K)               # [P, K, K]

    row_live = (j < n_cur[:, None].to(torch.float32))             # [P, K]
    cols = torch.arange(K, dtype=torch.int32, device=dev)
    dummy = (cols[None, :] == (cols[:, None] - 1)).to(A.dtype)
    live = row_live[..., None].to(A.dtype)
    A = A * live + dummy[None] * (1.0 - live)
    b = control * live

    AtA = (torch.einsum("prk,prl->pkl", A, A)
           + ridge * torch.eye(K, dtype=A.dtype, device=dev)[None])
    Atb = torch.einsum("prk,prc->pkc", A, b)
    sol = torch.linalg.solve_ex(AtA, Atb)[0]                      # [P, K, C]
    col_live = (cols[None, :] < n_new[:, None]).to(sol.dtype)
    return sol * col_live[..., None]
