"""The compositor's multi-view launch on the card against one launch per
view, at the seesaw protocol shape (``chip_smoke.protocol_scene``: 512x288,
20,000 + 10,000 seeds in 60,000 slots), for one training view (E = 9) of
view 0: its eight latent cameras, image only (CE = 9, ``latent``), and its
eight exposure-flow passes at the view's own camera, the nine features and
the two exp→mid flow columns with the dynamic-alpha chain (CE = 11 + sub,
``flow``). Each view or pass is binned at max_per_tile K; forward and
backward, timed by CUDA events over ITERS calls, with each launch's bound,
blocks, blocks per SM and waves.

    python3 scripts/torch_view_launch.py [--case latent flow] [--k 1536 2048] [--out FILE]

Prints one JSON object: the card, and per case and K the forward's and the
backward's milliseconds for the eight one-view launches (summed) and for
the one eight-view launch, the operations and bytes the work needs
(``chip_smoke.raster_fwd_cost`` / ``raster_bwd_cost`` summed over the
views), the share of the bound, and whether the eight-view forward (and its
alpha map) equals the eight launches' to the bit. The backward's timings
hold its zeroed gradient tables. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from chip_smoke import (FRAMES, H, W, bound, card_line, cuda_ms, protocol_scene,  # noqa: E402
                        raster_bwd_cost, raster_fwd_cost)

ITERS = 20
E = 9


def latent_views(dev):
    """Records, colours and projected splats of the eight latent cameras of
    view 0 at a fresh BLCE state ([V, N, ...]), and the box budget the
    train CLI's validation would pick from view 0's radii."""
    from mobgs_tpu_torch.core import se3
    from mobgs_tpu_torch.models import blce as B
    from mobgs_tpu_torch.models import render as R
    from mobgs_tpu_torch.ops import cuda_raster, projection, tiles

    _, data, _, stat, dyn = protocol_scene(dev)
    blce = B.init_blce(torch.Generator(device=dev).manual_seed(0), num_views=FRAMES,
                       num_warp=E, device=dev)
    w2c = torch.as_tensor(data.w2c[0], device=dev)
    K = torch.as_tensor(data.K[0], device=dev)
    time = torch.tensor(float(data.time[0]), device=dev)
    with torch.no_grad():
        lat_c2w, expo = B.latent_poses(blce, se3.view_to_world(w2c),
                                       torch.as_tensor(data.blur_feats[0], device=dev),
                                       torch.tensor(0, device=dev), E)
        lat_w2c = se3.view_to_world(lat_c2w)
        recs, cols, splats = [], [], []
        for e in [e for e in range(E) if e != E // 2]:
            g = R.assemble(stat, dyn, time, data.max_time, expo[e])
            sp = projection.project(g.means, g.quats, g.scales, lat_w2c[e], K, W, H)
            recs.append(cuda_raster.pack_records(sp, g.opacity))
            cols.append(g.colors.contiguous())
            splats.append(sp)
    stacked = projection.ProjectedSplats(*(torch.stack(x) for x in zip(*splats)))
    return recs, cols, stacked, tiles.suggest_tiles_per_gauss(splats[0].radii)


def flow_passes(dev):
    """Records (with the dynamic rows' opacities in the sub chain's column),
    colours (features ‖ exp→mid flow) and projected splats of the eight
    exposure-flow passes of view 0 at its own camera ([V, N, ...]), at the
    train step's shifts (e − 4) / 4, and the box budget the train CLI's
    validation would pick from the first pass's radii."""
    from mobgs_tpu_torch.models import render as R
    from mobgs_tpu_torch.ops import cuda_raster, projection, tiles

    _, data, _, stat, dyn = protocol_scene(dev)
    w2c = torch.as_tensor(data.w2c[0], device=dev)
    K = torch.as_tensor(data.K[0], device=dev)
    time = torch.tensor(float(data.time[0]), device=dev)
    half = E // 2
    with torch.no_grad():
        mid = R.assemble(stat, dyn, time, data.max_time)
        mid2d = projection.project(mid.means, mid.quats, mid.scales, w2c, K, W, H).means2d
        recs, cols, splats = [], [], []
        for e in [e for e in range(E) if e != half]:
            g = R.assemble(stat, dyn, time, data.max_time, (e - half) / half)
            sp = projection.project(g.means, g.quats, g.scales, w2c, K, W, H)
            recs.append(cuda_raster.pack_records(sp, g.opacity, g.opacity * g.dyn_mask))
            cols.append(torch.cat([g.colors, mid2d - sp.means2d], dim=1).contiguous())
            splats.append(sp)
    stacked = projection.ProjectedSplats(*(torch.stack(x) for x in zip(*splats)))
    return recs, cols, stacked, tiles.suggest_tiles_per_gauss(splats[0].radii)


def launch_rows(recs, cols, splats, tpg, sub, ks, n_sm, dev, rng):
    """Per K: the eight one-view launches against the one eight-view launch,
    forward and backward."""
    from mobgs_tpu_torch.ops import cuda_raster, tiles

    V, N = splats.means2d.shape[:2]
    CE = cols[0].shape[1]
    rec_s, col_s = torch.cat(recs), torch.cat(cols)
    rows = {}
    for K in ks:
        bins = tiles.bin_views(splats, W, H, tiles_per_gauss=tpg, max_per_tile=K)
        ntx, T = bins.n_tiles_x, bins.counts.shape[0] // V
        ids_s, cnt_s = bins.gauss_ids.contiguous(), bins.counts.contiguous()
        per = [((ids_s[v * T:(v + 1) * T] - v * N).contiguous(), cnt_s[v * T:(v + 1) * T],
                recs[v], cols[v]) for v in range(V)]
        with torch.no_grad():
            outs = [cuda_raster.composite_fwd(*p, ntx, sub) for p in per]
            out_s, out2_s = cuda_raster.composite_fwd(ids_s, cnt_s, rec_s, col_s, ntx, sub,
                                                      tpv=T)
        torch.cuda.synchronize()
        g = torch.as_tensor(rng.normal(size=out_s.shape).astype(np.float32), device=dev)
        g2 = (torch.as_tensor(rng.normal(size=out2_s.shape).astype(np.float32), device=dev)
              if sub else None)

        def part(x, v):
            return None if x is None else x[v * T:(v + 1) * T].contiguous()

        equal = torch.equal(out_s, torch.cat([o[0] for o in outs]))
        if sub:
            equal = equal and torch.equal(out2_s, torch.cat([o[1] for o in outs]))
        row = {"T_per_view": T, "entries_max": int(cnt_s.max()), "forward_bit_equal": equal}
        fwd = [raster_fwd_cost(*p, sub, ntx) for p in per]
        bwd = [raster_bwd_cost(*p, sub, ntx) for p in per]
        for name, cost, occ, one, many in (
                ("forward", fwd, cuda_raster.fwd_occupancy(CE, K, sub),
                 lambda: [cuda_raster.composite_fwd(*p, ntx, sub) for p in per],
                 lambda: cuda_raster.composite_fwd(ids_s, cnt_s, rec_s, col_s, ntx, sub,
                                                   tpv=T)),
                ("backward", bwd, cuda_raster.bwd_occupancy(CE, K, sub),
                 lambda: [cuda_raster.composite_bwd(*p, *o, part(g, v), part(g2, v), ntx, sub)
                          for v, (p, o) in enumerate(zip(per, outs))],
                 lambda: cuda_raster.composite_bwd(ids_s, cnt_s, rec_s, col_s, out_s, out2_s,
                                                   g, g2, ntx, sub, tpv=T))):
            ops, bytes_ = sum(c[0] for c in cost), sum(c[1] for c in cost)
            b = bound(ops, bytes_)
            with torch.no_grad():
                ms_one, ms_many = cuda_ms(one, ITERS), cuda_ms(many, ITERS)
            bps = occ["blocks_per_sm"]
            row[name] = {
                "bound_ms": b, "gop": ops / 1e9, "mb": bytes_ / 1e6,
                "blocks_per_sm": bps,
                "one_view": {"ms_8_launches": ms_one, "pct_of_bound": 100 * b / ms_one,
                             "blocks": T, "waves": T / (bps * n_sm)},
                "eight_views": {"ms": ms_many, "pct_of_bound": 100 * b / ms_many,
                                "blocks": V * T, "waves": V * T / (bps * n_sm)}}
        rows[K] = row
    return rows


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--case", nargs="+", choices=("latent", "flow"), default=["latent", "flow"])
    ap.add_argument("--k", type=int, nargs="+", default=[1536, 2048])
    ap.add_argument("--out", type=Path)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_view_launch: no CUDA card", file=sys.stderr)
        return 2

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    rng = np.random.default_rng(0)
    res = {"card": card_line(), "iters": ITERS, "cases": {}}
    for case in a.case:
        recs, cols, splats, tpg = (latent_views if case == "latent" else flow_passes)(dev)
        res["cases"][case] = {
            "views": splats.means2d.shape[0], "N": splats.means2d.shape[1],
            "CE": cols[0].shape[1], "sub": case == "flow", "tiles_per_gauss": tpg,
            "K": launch_rows(recs, cols, splats, tpg, case == "flow", a.k, n_sm, dev, rng)}
    line = json.dumps(res)
    print(line)
    if a.out:
        a.out.write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
