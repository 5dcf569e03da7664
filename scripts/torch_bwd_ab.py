#!/usr/bin/env python3
"""Time the port's backward compositor built from other ``raster_bwd.cu``
sources beside the tree's, on one CUDA card, at the seesaw protocol view
(the scene of ``chip_smoke.py`` phases 3-4: 512x288, 40k + 20k slots,
tiles_per_gauss=9, K=256, so 576 tiles and chunk 128).

    python3 scripts/torch_bwd_ab.py [--source LABEL=PATH ...] [--variants]

Every source must export the tree's C entry point ``raster_bwd(...)``; an
earlier design is extracted with ``git show <commit>:<path>`` into a
directory that ``.gitignore`` lists (``build/``). Each is compiled with the
port's nvcc flags and ``mobgs_tpu_torch/csrc`` on the include path, all
``nvcc`` started together, into ``build/ab/``. ``--variants`` adds two
attribution builds made from the tree's source: ``no_atomics`` (phase B
sums as before, its ``atomicAdd``s replaced by a store that never fires)
and ``no_phase_b`` (phase B removed). Their gradients are wrong by design.

Every build runs on the same inputs (the latent render, CE=9, and the mid
render, CE=11 with the sub chain; ``--ce29`` adds the flow-on mid render's
CE=29 with the sub chain), in turns: the tree, the others, the others in
reverse, the tree. Each turn is the mean of 50 launches by CUDA events,
zeroing the two gradient tables included, as ``chip_smoke.py`` times them.
Prints each build's ``-Xptxas -v`` lines, one line per case, the card's
name and power limit, and one JSON object last.
"""

import argparse
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from chip_smoke import H, W, cuda_ms, protocol_scene  # noqa: E402

ITERS = 50
PHASE_B_START = "      // ---- phase B: the sums over pixels, 8 / S warps per slot ----\n"
PHASE_B_END = "      bank ^= 1;\n"
# phase B's atomicAdd(ptr, r) calls; the no_atomics build keeps the sums
# alive with a store that never fires
ATOMIC = re.compile(r"atomicAdd\(([^;]*), r\);")
N_ATOMICS = 2


def variants(tree_src: str) -> dict[str, str]:
    """The attribution builds, made from the tree's source by exact edits."""
    no_atomics, n = ATOMIC.subn(r"if (r == 1.5e-38f) *(\1) = r;", tree_src)
    if n != N_ATOMICS:
        raise RuntimeError(f"variant no_atomics: {n} atomicAdd calls, expected {N_ATOMICS}")
    i, j = tree_src.find(PHASE_B_START), tree_src.find(PHASE_B_END)
    if i < 0 or j < i:
        raise RuntimeError("variant no_phase_b: phase B markers not found")
    return {"no_atomics": no_atomics, "no_phase_b": tree_src[:i] + tree_src[j:]}


def build(sources: dict[str, Path], out_dir: Path) -> dict[str, tuple[Path, str]]:
    from mobgs_tpu_torch.ops import cuda_raster
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for label, src in sources.items():
        so = out_dir / f"libraster_bwd_{label}.so"
        procs[label] = (so, subprocess.Popen(
            [cuda_raster._nvcc(), *cuda_raster.NVCC_FLAGS, "-I", str(cuda_raster.CSRC),
             "-o", str(so), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    built, failed = {}, []
    for label, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc {label} failed ({proc.returncode}):\n{log}")
        built[label] = (so, log)
    if failed:
        raise RuntimeError("\n".join(failed))
    return built


def bind(so: Path):
    import ctypes
    lib = ctypes.CDLL(str(so))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.raster_bwd.argtypes = [vp] * 10 + [ci] * 6 + [vp]
    lib.raster_bwd.restype = ci
    return lib


def launcher(lib, args):
    """A zero-argument call of ``lib``'s raster_bwd on ``args`` (the
    operands of ``composite_bwd``), allocating its zeroed outputs as
    ``_launch_bwd`` does; returns (grad_rec, grad_col)."""
    from mobgs_tpu_torch.ops import cuda_raster
    ids, cnt, rec, col, out, out2, g, g2, ntx, sub = args
    T, K = ids.shape
    N, CE = col.shape
    ch = cuda_raster._pick_chunk(K)
    stream = torch.cuda.current_stream().cuda_stream

    def run():
        gr = torch.zeros((N, cuda_raster.R), dtype=torch.float32, device=rec.device)
        gc = torch.zeros((N, CE), dtype=torch.float32, device=rec.device)
        err = lib.raster_bwd(ids.data_ptr(), cnt.data_ptr(), rec.data_ptr(),
                             col.data_ptr(), out.data_ptr(),
                             out2.data_ptr() if sub else None, g.data_ptr(),
                             g2.data_ptr() if sub else None, gr.data_ptr(),
                             gc.data_ptr(), T, K, CE, ntx, ch, int(sub), stream)
        if err != 0:
            raise RuntimeError(f"raster_bwd launch failed: CUDA error {err}")
        return gr, gc
    return run


def protocol_cases(dev, with_ce29: bool):
    """The protocol view's backward operands, built as chip_smoke.py
    builds them (same seeds)."""
    from mobgs_tpu_torch.data.cameras import Camera
    from mobgs_tpu_torch.models import render as R
    from mobgs_tpu_torch.ops import cuda_raster, tiles

    cfg, data, _, stat, dyn = protocol_scene(dev)
    cam = Camera(w2c=torch.as_tensor(data.w2c[0], device=dev),
                 K=torch.as_tensor(data.K[0], device=dev),
                 time=torch.tensor(float(data.time[0]), device=dev))
    with torch.no_grad():
        geom, splats = R.assemble_project(stat, dyn, cam, W, H, data.max_time, config=cfg)
        bins = tiles.bin_gaussians(splats, W, H, tiles_per_gauss=cfg.tiles_per_gauss,
                                   max_per_tile=cfg.max_per_tile)
    N = geom.means.shape[0]
    ids, cnt, ntx = bins.gauss_ids.contiguous(), bins.counts.contiguous(), bins.n_tiles_x
    ones = torch.ones(N, 1, device=dev)
    rng = np.random.default_rng(7)
    cols = {"latent_ce9": (geom.colors, False),
            "mid_ce11_sub": (torch.cat([geom.colors, splats.depths[:, None], ones], 1), True)}
    if with_ce29:
        flow = torch.as_tensor(rng.normal(size=(N, 18)).astype(np.float32), device=dev)
        cols["flow_mid_ce29_sub"] = (
            torch.cat([geom.colors, flow, splats.depths[:, None], ones], 1), True)
    cases = {}
    for name, (col, sub) in cols.items():
        col = col.detach().contiguous()
        rec = cuda_raster.pack_records(splats, geom.opacity,
                                       geom.opacity * geom.dyn_mask if sub else None).detach()
        with torch.no_grad():
            out, out2 = cuda_raster.composite_fwd(ids, cnt, rec, col, ntx, sub)
        g = torch.as_tensor(rng.normal(size=out.shape).astype(np.float32), device=dev)
        g2 = (torch.as_tensor(rng.normal(size=out2.shape).astype(np.float32), device=dev)
              if sub else None)
        cases[name] = (ids, cnt, rec, col, out, out2, g, g2, ntx, sub)
    return cases


def rel_errs(k, p, sub):
    rows = 7 if sub else 6
    errs = [float((k[0][:, j] - p[0][:, j]).abs().max()) / max(float(p[0][:, j].abs().max()), 1e-30)
            for j in range(rows)]
    errs.append(float((k[1] - p[1]).abs().max()) / max(float(p[1].abs().max()), 1e-30))
    return max(errs)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--source", action="append", default=[], metavar="LABEL=PATH")
    ap.add_argument("--variants", action="store_true")
    ap.add_argument("--ce29", action="store_true")
    ap.add_argument("--out", type=Path, help="also write the JSON object here")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_bwd_ab: no CUDA card", file=sys.stderr)
        return 2
    from mobgs_tpu_torch.ops import cuda_raster
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]
    ab_dir = ROOT / "build" / "ab"
    ab_dir.mkdir(parents=True, exist_ok=True)
    sources = {"tree": cuda_raster.CSRC / "raster_bwd.cu"}
    for spec in a.source:
        label, _, path = spec.partition("=")
        if not label or not path or label in sources:
            raise SystemExit(f"bad --source {spec!r}")
        sources[label] = Path(path)
    if a.variants:
        for label, text in variants(sources["tree"].read_text()).items():
            path = ab_dir / f"raster_bwd_{label}.cu"
            path.write_text(text)
            sources[label] = path
    t0 = time.time()
    built = build(sources, ab_dir)
    print(f"built {len(built)} libraries in {time.time() - t0:.1f} s")
    for label, (_, log) in built.items():
        for line in log.splitlines():
            if any(k in line for k in ("Compiling entry", "registers", "spill")):
                print(f"  ptxas {label}:", line.split("info    :")[-1].strip())
    libs = {label: bind(so) for label, (so, _) in built.items()}
    cases = protocol_cases(dev, a.ce29)
    others = [lb for lb in libs if lb != "tree"]
    order = ["tree", *others, *reversed(others), "tree"]
    result = {"card": card, "iters": ITERS, "order": order, "cases": {}}
    for name, args in cases.items():
        plain = cuda_raster.composite_bwd_plain(*args)
        runs = {lb: launcher(lib, args) for lb, lib in libs.items()}
        times = {lb: [] for lb in libs}
        for lb in order:
            times[lb].append(cuda_ms(runs[lb], ITERS))
        errs = {lb: rel_errs(runs[lb](), plain, args[-1]) for lb in libs}
        torch.cuda.synchronize()
        result["cases"][name] = {"ms": times, "max_rel_err": errs,
                                 "CE": int(args[3].shape[1]), "sub": bool(args[-1])}
        print(f"{name}: " + ", ".join(
            f"{lb} {' / '.join(f'{t:.4f}' for t in times[lb])} ms (err {errs[lb]:.3g})"
            for lb in libs))
    print(card)
    line = json.dumps(result)
    if a.out:
        a.out.parent.mkdir(parents=True, exist_ok=True)
        a.out.write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
