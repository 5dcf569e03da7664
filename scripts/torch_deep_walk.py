#!/usr/bin/env python3
"""Repeat ``chip_smoke.py`` phase 15's deep-walk check on one CUDA card and
count how often it fails.

    python3 scripts/torch_deep_walk.py [--runs N] [--csrc DIR] [--out FILE]

Each run does what phase 15 does up to its check: a fresh protocol state
(``chip_smoke.protocol_train_state``), ``train/loop.py::train`` for
``LOOP_ITERS`` iterations with phase 15's schedule
(``chip_smoke.loop_settings``), two steps at the grown capacity and the
last iteration's budgets, then ``chip_smoke.check_step_vs_plain(...,
deep=True)``: the step's gradients through the kernels, through the plain
route and with the compositor in float64, the kernels held within
max(``STEP_REL``, ``DEEP_PLAIN_X`` x the plain route's distance) of
float64. The backward's atomics add in an order that changes from run to
run, so the state the loop reaches, and the check's margin, differ between
runs.

``--attribute`` adds two mixed routes to each run, the kernel forward with
the plain backward and the plain forward with the kernel backward, and
their distances to float64 by group, to tell which half of the kernels'
route carries its distance.

``--csrc`` builds the kernels from another directory of sources (an
earlier design extracted with ``git show <commit>:<path>`` under
``build/``), which must take the same arguments as the tree's. Prints one
line per run (pass or fail, the worst distance to float64 of each route by
group, the walk's budget), the card's name and power limit, and one JSON
object last.
"""

import argparse
import json
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402


def mixed_composites():
    """{route: a stand-in for ``cuda_raster.composite_plain``}: the kernel
    forward with the plain backward, and the plain forward with the kernel
    backward."""
    from mobgs_tpu_torch.ops import cuda_raster as cr

    def make(fwd, bwd):
        class Mixed(torch.autograd.Function):
            @staticmethod
            def forward(ctx, ids, counts, rec, col, ntx, sub, tile0=0, tpv=None):
                out, out2 = fwd(ids, counts, rec, col, ntx, sub, tile0, tpv)
                ctx.save_for_backward(ids, counts, rec, col, out, out2)
                ctx.ntx, ctx.sub, ctx.tile0, ctx.tpv = ntx, sub, tile0, tpv
                return (out, out2) if sub else out

            @staticmethod
            def backward(ctx, g, g2=None):
                ids, counts, rec, col, out, out2 = ctx.saved_tensors
                gr, gc = bwd(ids, counts, rec, col, out, out2, g.contiguous(),
                             None if g2 is None else g2.contiguous(), ctx.ntx, ctx.sub,
                             ctx.tile0, ctx.tpv)
                return None, None, gr, gc, None, None, None, None

        def composite(ids, counts, rec, col, ntx, sub=False, tile0=0, tpv=None):
            res = Mixed.apply(ids, counts, rec, col, ntx, sub, tile0, tpv)
            return res if sub else (res, None)
        return composite

    def plain_fwd(ids, counts, rec, col, ntx, sub, tile0, tpv):
        return cr.composite_tiles_plain(ids, counts, rec, col, ntx, sub, tile0=tile0, tpv=tpv)

    return {"kernel forward, plain backward": make(cr._launch, cr.composite_bwd_plain),
            "plain forward, kernel backward": make(plain_fwd, cr._launch_bwd)}


def route_grads(opt, ts, batch, data, rcfg, composite):
    """The step's gradient leaves (``chip_smoke.param_groups`` order, then
    the offsets) with ``composite`` as the plain route's compositor."""
    from mobgs_tpu_torch.ops import cuda_raster
    from mobgs_tpu_torch.train import step as S
    fwd = S.make_forward(opt, cs.W, cs.H, data.max_time, cs.E_WARP,
                         rcfg._replace(backend="plain"))
    off = torch.zeros((batch.view_idx.shape[0], ts.stat.capacity + ts.dyn.capacity, 2),
                      device=ts.stat.xyz.device, requires_grad=True)
    leaves = [p for grp in cs.param_groups(ts).values() for p in grp] + [off]
    with cs.replaced((cuda_raster, "composite_plain", composite)):
        total, _ = fwd(ts.stat, ts.dyn, ts.sandwich, ts.blce, off, batch)
        grads = torch.autograd.grad(total, leaves, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]


def distances(grads, ref, ts):
    """Worst max|x - r| / max|r| by group of leaves."""
    groups = list(cs.param_groups(ts).items()) + [("offsets", (None,))]
    out, i = {}, 0
    for grp, leaves in groups:
        for _ in leaves:
            scale = float(ref[i].abs().max())
            if scale:
                out[grp] = max(out.get(grp, 0.0),
                               float((grads[i] - ref[i]).abs().max()) / scale)
            i += 1
    return {g: float(f"{v:.3g}") for g, v in out.items()}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--runs", type=int, default=10)
    ap.add_argument("--csrc", type=Path, help="kernel sources to build instead of the tree's")
    ap.add_argument("--attribute", action="store_true",
                    help="also the two mixed routes' distances to float64")
    ap.add_argument("--out", type=Path, help="also write the JSON object here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_deep_walk: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    from mobgs_tpu_torch.ops import cuda_raster
    from mobgs_tpu_torch.train import loop as L
    from mobgs_tpu_torch.train import step as S

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.csrc is not None:
        cuda_raster.CSRC = args.csrc.resolve()
    for name in cuda_raster.build_kernels():
        cuda_raster._library(name)
    dev = torch.device("cuda")
    card = cs.card_line()
    cfg, data, clouds, _, _ = cs.protocol_scene(dev)
    loop_opt, loop_blce = cs.loop_settings()
    extent = L.scene_extent_from_cameras(data.w2c)
    runs = []
    for run in range(args.runs):
        t0 = time.time()
        ts, hist = L.train(cs.protocol_train_state(data, clouds, dev), data, loop_opt,
                           loop_blce, cs.LOOP_ITERS, raster_cfg=cfg, scene_extent=extent,
                           seed=0, base_raster_cfg=cfg, deescalate_every=12,
                           max_capacity=cs.LOOP_MAX_CAP, device=dev)
        last_cfg = cfg._replace(max_per_tile=hist[-1]["max_per_tile"],
                                tiles_per_gauss=hist[-1]["tiles_per_gauss"])
        step = S.make_train_step(loop_opt, cs.W, cs.H, data.max_time, cs.E_WARP, last_cfg,
                                 spatial_lr_scale=extent)
        batch = L.make_batch(data, L.BatchSampler(cs.FRAMES, cs.B_VIEWS, seed=5).next_ids(),
                             dev)
        for _ in range(2):
            ts, _ = step(ts, batch)
        report = {}
        try:
            cs.check_step_vs_plain(loop_opt, ts, batch, data, last_cfg, deep=True,
                                   report=report)
            ok = True
        except RuntimeError as e:
            ok = False
            report.setdefault("error", str(e))
        grads = report.pop("grads", None)
        if args.attribute and grads is not None:
            report["mixed"] = {
                name: distances(route_grads(loop_opt, ts, batch, data, last_cfg, fn),
                                grads["plain64"], ts)
                for name, fn in mixed_composites().items()}
        del grads
        rec = {"run": run, "pass": ok, "max_per_tile": last_cfg.max_per_tile,
               "slots": [ts.stat.capacity, ts.dyn.capacity],
               "seconds": round(time.time() - t0, 2), **report}
        runs.append(rec)
        print(f"run {run}: {'pass' if ok else 'FAIL'} {json.dumps(rec)}", flush=True)
        del ts, step
    n_fail = sum(not r["pass"] for r in runs)
    # each route's worst distance to float64 over every run and group
    worst = {route: max((v for r in runs for v in r.get("worst", {}).get(route, {}).values()),
                        default=None) for route in ("kernels", "plain")}
    summary = {"runs": len(runs), "failed": n_fail, "csrc": str(cuda_raster.CSRC),
               "worst_to_float64": worst, "card": card, "per_run": runs}
    print(card)
    print(json.dumps(summary))
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(summary, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
