"""The initial training state, made by the benchmark from the seed points
and the seed, and handed to the program and to the reference alike.

The parameters follow the system's initialisation laws (a copy of the
program's ``create_state``, ``init_sandwich`` and ``init_blce``): log scales
from the root mean squared distance to the 3 nearest seeds, identity
rotations, opacity logits at sigmoid^-1(0.1), features [SH(rgb) | SH(rgb)],
static knots drawn around the cloud, dynamic knots the least-squares fit of
the tracks; decoder and BLCE weights uniform in +-1/sqrt(fan_in), BLCE's
decoders a tiny Xavier law, zero embeddings, exposure scale 0.4. The draws
come from one generator on the run's device, in one call per law.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from harness import refmodel as R

CONTROL_NUM = 12


def _knn_scale(points, k=3, block=2048):
    sq = (points * points).sum(-1)
    out = []
    for s in range(0, points.shape[0], block):
        q = points[s:s + block]
        d2 = (q * q).sum(-1)[:, None] + sq[None] - 2.0 * (q @ points.T)
        d2 = torch.topk(d2, k + 1, dim=-1, largest=False).values[:, 1:]
        out.append(torch.clamp(d2, min=0.0).mean(-1))
    d2 = torch.clamp(torch.cat(out), min=1e-7)
    return torch.log(torch.sqrt(d2))[:, None].repeat(1, 3)


def _pool(points, colors, capacity, control, dev):
    N = points.shape[0]
    f32 = torch.float32
    sh = (colors - 0.5) / R.SH_C0

    def pad(x):
        z = torch.zeros((capacity - N,) + tuple(x.shape[1:]), dtype=x.dtype, device=dev)
        return torch.cat([x, z])
    rot = torch.zeros((N, 4), dtype=f32, device=dev)
    rot[:, 0] = 1.0
    fields = dict(
        xyz=points, control_xyz=control, features_dc=torch.cat([sh, sh], 1),
        features_rest=torch.zeros((N, 16, 3), dtype=f32, device=dev),
        features_t=torch.zeros((N, 3), dtype=f32, device=dev),
        scaling=_knn_scale(points), rotation=rot,
        opacity=torch.full((N, 1), math.log(0.1 / 0.9), dtype=f32, device=dev),
        omega=torch.zeros((N, 4), dtype=f32, device=dev),
        motion=torch.zeros((N, 9), dtype=f32, device=dev),
        zeta=torch.zeros((N, 1), dtype=f32, device=dev),
        trbf_center=torch.zeros((N, 1), dtype=f32, device=dev),
        trbf_scale=torch.zeros((N, 1), dtype=f32, device=dev))
    fields = {k: pad(v.to(f32)) for k, v in fields.items()}
    live = torch.arange(capacity, device=dev) < N
    return fields, live


def initial_params(scene, clouds, caps, num_views, view_dim, num_warp, seed, dev):
    """The reference's parameter dict (see ``refmodel.leaves``)."""
    s_pts, s_cols, d_traj = clouds
    gen = torch.Generator(device=dev).manual_seed(seed)
    on = lambda x: torch.as_tensor(np.asarray(x), dtype=torch.float32, device=dev)  # noqa: E731
    s_pts, s_cols, d_traj = on(s_pts), on(s_cols), on(d_traj)
    # static knots: normal around the cloud (they never move a static splat)
    noise = torch.randn((s_pts.shape[0], CONTROL_NUM, 3), generator=gen, device=dev)
    s_ctrl = noise * s_pts.std(0, correction=0) + s_pts.mean(0)
    d_ctrl = R.spline_fit(d_traj / R.SPLINE_SCALE, on(scene["time"]), CONTROL_NUM)
    stat, stat_live = _pool(s_pts, s_cols, caps[0], s_ctrl, dev)
    dyn, dyn_live = _pool(d_traj[:, 0], torch.full_like(d_traj[:, 0], 0.5), caps[1], d_ctrl, dev)

    V, D, E = num_views, view_dim, num_warp
    Hh = D // 2
    lin = [("bf_w0", "bf_b0", 2 * R.NUM_FREQS + 1, D), ("bf_w1", "bf_b1", D, D),
           ("bf_w2", "bf_b2", D, D), ("rt_w", "rt_b", 12, D), ("venc_w", "venc_b", 2 * D, D),
           ("w_lin_w", "w_lin_b", Hh + 8 + D, Hh), ("v_lin_w", "v_lin_b", Hh + 8 + D, Hh)]
    tiny = [("rot_w", "rot_b", Hh, 3), ("trans_w", "trans_b", Hh, 3), ("theta_w", "theta_b", Hh, 1)]
    shapes, bounds = [(12, 6), (6, 3)], [1 / math.sqrt(12), 1 / math.sqrt(6)]
    for w, b, fi, fo in lin:
        shapes += [(V, fi, fo), (V, fo)]
        bounds += [1 / math.sqrt(fi)] * 2
    gain = 1e-5 / math.sqrt((Hh + 3) / 6.0)
    for w, b, fi, fo in tiny:
        shapes.append((V, fi, fo))
        bounds.append(gain * math.sqrt(6.0 / (fi + fo)))
    sizes = [math.prod(s) for s in shapes]
    u = torch.rand(sum(sizes), generator=gen, device=dev)
    parts = [(x.reshape(s) * 2 - 1) * bd for x, s, bd in
             zip(torch.split(u, sizes), shapes, bounds)]
    sandwich = dict(w1=parts[0], w2=parts[1])
    blce, i = {}, 2
    for w, b, fi, fo in lin:
        blce[w], blce[b] = parts[i], parts[i + 1]
        i += 2
    for w, b, fi, fo in tiny:
        blce[w] = parts[i]
        blce[b] = torch.zeros((V, fo), dtype=torch.float32, device=dev)
        i += 1
    blce["view_embed"] = torch.zeros((V, D), dtype=torch.float32, device=dev)
    blce["time_embed"] = torch.zeros((V, E, 8), dtype=torch.float32, device=dev)
    return dict(stat=stat, dyn=dyn, stat_live=stat_live.float(), dyn_live=dyn_live.float(),
                stat_control_num=torch.where(stat_live, CONTROL_NUM, 4),
                dyn_control_num=torch.where(dyn_live, CONTROL_NUM, 4),
                sandwich=sandwich, blce=blce,
                exposure=torch.full((V,), 0.4, dtype=torch.float32, device=dev))


def copy_params(P, device):
    """A deep copy of a parameter dict on ``device``."""
    if isinstance(P, dict):
        return {k: copy_params(v, device) for k, v in P.items()}
    return P.detach().to(device, copy=True)


def to_program(P, step):
    """The program's TrainState over copies of the parameters, its Adam
    moments zero, its iteration counter at ``step``."""
    from mobgs_tpu_torch.models import blce as B
    from mobgs_tpu_torch.models import gaussians as G
    from mobgs_tpu_torch.models.sandwich import SandwichParams
    from mobgs_tpu_torch.train.step import init_train_state

    def pool(name):
        f = {k: v.clone() for k, v in P[name].items()}
        return G.GaussianState(control_num=P[f"{name}_control_num"].clone(),
                               live=P[f"{name}_live"] > 0, **f)
    sw = SandwichParams(P["sandwich"]["w1"].clone(), P["sandwich"]["w2"].clone())
    bl = B.BLCEState(B.BLCEParams(**{k: v.clone() for k, v in P["blce"].items()}),
                     P["exposure"].clone())
    return init_train_state(pool("stat"), pool("dyn"), sw, bl)._replace(step=step)


def from_program(ts):
    """The program's current state as a parameter dict (shared tensors,
    detached), for the benchmark's own work counts."""
    from mobgs_tpu_torch.models import gaussians as G

    def pool(st):
        return {k: getattr(st, k).detach() for k in G.DIFF_FIELDS}
    return dict(stat=pool(ts.stat), dyn=pool(ts.dyn),
                stat_live=ts.stat.live.float(), dyn_live=ts.dyn.live.float(),
                stat_control_num=ts.stat.control_num, dyn_control_num=ts.dyn.control_num,
                sandwich=dict(w1=ts.sandwich.w1.detach(), w2=ts.sandwich.w2.detach()),
                blce={k: v.detach() for k, v in zip(R.BLCE_FIELDS, ts.blce.params.leaves())},
                exposure=ts.blce.exposure_expo.detach())


def program_leaves(ts):
    """(name, tensor) of the program's optimised leaves, in
    ``refmodel.leaves``' order, with their Adam first moments."""
    from mobgs_tpu_torch.models import gaussians as G
    names = ([f"stat.{k}" for k in G.DIFF_FIELDS] + [f"dyn.{k}" for k in G.DIFF_FIELDS]
             + ["sandwich.w1", "sandwich.w2"] + [f"blce.{k}" for k in R.BLCE_FIELDS])
    params = (list(G.split_diff(ts.stat)[0]) + list(G.split_diff(ts.dyn)[0])
              + [ts.sandwich.w1, ts.sandwich.w2] + list(ts.blce.params.leaves()))
    mus = (list(ts.stat_opt.mu) + list(ts.dyn_opt.mu) + list(ts.sandwich_opt.mu)
           + list(ts.blce_opt.mu))
    return names, params, mus


def program_snapshot(ts):
    """Copies of the program's current parameters (a parameter dict) and of
    its Adam state (``refmodel.train_step``'s ``adam``: the update count and
    each leaf's moments), from which the reference takes the step the
    program takes next."""
    names, _, mus = program_leaves(ts)
    nus = (list(ts.stat_opt.nu) + list(ts.dyn_opt.nu) + list(ts.sandwich_opt.nu)
           + list(ts.blce_opt.nu))
    steps = {o.step for o in (ts.stat_opt, ts.dyn_opt, ts.sandwich_opt, ts.blce_opt)}
    if len(steps) != 1:
        raise ValueError(f"the optimiser groups disagree on their update count: {steps}")
    adam = dict(t=steps.pop(), m={n: m.detach().clone() for n, m in zip(names, mus)},
                v={n: v.detach().clone() for n, v in zip(names, nus)})
    return copy_params(from_program(ts), ts.stat.xyz.device), adam
