#!/usr/bin/env python3
"""Time the port's forward or backward compositor built from other sources
beside the tree's, on one CUDA card, at the seesaw protocol view (the scene
of ``chip_smoke.py`` phases 3-4: 512x288, 40k + 20k slots,
tiles_per_gauss=9, K=256, so 576 tiles and chunk 128).

    python3 scripts/torch_raster_ab.py --kernel fwd|bwd [--source LABEL=PATH ...]
                                       [--variants] [--ce29] [--k K] [--out FILE]

Every source must export the C entry point ``raster_fwd(...)`` or
``raster_bwd(...)``, either the tree's (with ``tile0`` and ``tpv``) or one
before it (bound as its source declares it, :func:`bind`); an earlier design is
extracted with ``git show
<commit>:<path>`` into a directory that ``.gitignore`` lists (``build/``).
Each is compiled with the port's nvcc flags and ``mobgs_tpu_torch/csrc`` on
the include path, all ``nvcc`` started together, into ``build/ab/``.
``--variants`` adds attribution builds made from the tree's source by exact
edits whose markers must each occur once (:func:`variants`); the outputs
of ``no_colour``, ``stage_only`` and ``block_times`` are wrong by design.
Forward: ``no_colour`` (the colour sums removed; the transmittance chains
and the exit stay), ``stage_only`` (the walk removed, so every live chunk
is staged), ``one_slot`` (one slot a step, where the tree takes two),
``other_ppt`` (up to CE = 12, four pixels a thread with the sub chain and
two without: the other choice on each side), ``no_exact`` (CE = 9 and
11 through the instances for any width up to 12) and ``block_times`` (each
block writes its start and end ``%globaltimer`` and its SM into its first
output words: the one-wave tail). Backward:
``no_atomics`` (phase B's ``atomicAdd``s replaced by a store that never
fires) and ``no_phase_b`` (phase B removed).

The cases are the main path's instances on the same inputs. Forward: the
latent render (CE=9, image only), the default render (CE=11), the mid
render (CE=11 with the sub chain); backward: the latent and mid renders.
``--ce29`` adds the flow-on mid render's CE=29 with the sub chain. ``--k
K`` takes ``chip_smoke.py`` phase 14's K-ladder view at max_per_tile K
(128x128, 64 tiles, opacities x0.1: walks thousands of entries deep). Builds
run in turns: the tree, the others, the others in reverse, the tree; each
turn is the mean of 50 launches by CUDA events, output allocation (and for
the backward the zeroing of its two gradient tables) included, as
``chip_smoke.py`` times them. Each build's result is compared: forward, max
abs difference to the tree's output (0 where the per-pixel order of
operations is the same) and the tree's to the plain version; backward, max
|k - p| / max |p| over the gradient columns against the plain version.
Prints each build's ``-Xptxas -v`` lines, one line per case, the card's
name and power limit, and one JSON object last.
"""

import argparse
import ctypes
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

from chip_smoke import H, K_VIEW, W, card_line, cuda_ms, protocol_scene  # noqa: E402

ITERS = 50

# ---- the backward's attribution edits ----
PHASE_B_START = "      // ---- phase B: the sums over pixels, 8 / S warps per slot ----\n"
PHASE_B_END = "      bank ^= 1;\n"
# phase B's atomicAdd(ptr, r) calls; the no_atomics build keeps the sums
# alive with a store that never fires
ATOMIC = re.compile(r"atomicAdd\(([^;]*), r\);")
N_ATOMICS = 2

# ---- the forward's attribution edits ----
COLOUR_CALL = "    colour_sums<CEM, EXACT>(colour, ce, w, g.keep, acc);\n"
SLOTS_LINE = "  static constexpr int SLOTS = CEM > 12 ? 1 : 2;\n"
WALK_START = "    // ---- walk the chunk ----\n"
WALK_END = "    // ---- end of the walk ----\n"
EXACT_PICKS = ("  if (CE == 9) {\n", "  if (CE == 11) {\n")
PPT_LINE = "static constexpr int PPT = CEM > 12 || SUB ? 2 : 4;"
TILE_LINE = "  const int tile = blockIdx.x;     // this launch's tile: its operands' row\n"
WRITE_START = "  // ---- write the tile's sums ----\n"
WRITE_END = "    if (SUB) out2[p] = done > 1 ? out2[p] + acc2[k] : acc2[k];\n  }\n"
TIMER = '  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ab_t{0}));\n'

VARIANTS = {"fwd": ("no_colour", "stage_only", "one_slot", "other_ppt", "no_exact",
                    "block_times"),
            "bwd": ("no_atomics", "no_phase_b")}


def _replace(src: str, old: str, new: str, label: str) -> str:
    n = src.count(old)
    if n != 1:
        raise RuntimeError(f"variant {label}: {n} copies of {old!r}, expected 1")
    return src.replace(old, new)


def _cut(src: str, start: str, end: str, label: str, keep: str = "") -> str:
    """``src`` with [start, end) replaced by ``keep``; each marker once."""
    for marker in (start, end):
        n = src.count(marker)
        if n != 1:
            raise RuntimeError(f"variant {label}: {n} copies of {marker!r}, expected 1")
    i, j = src.index(start), src.index(end)
    if j < i:
        raise RuntimeError(f"variant {label}: {end!r} before {start!r}")
    return src[:i] + keep + src[j:]


def variants(kernel: str, tree_src: str) -> dict[str, str]:
    """The attribution builds of ``kernel`` ("fwd" or "bwd"), made from the
    tree's source by exact edits; raises if a marker is not found exactly
    once (so no build silently equals the tree)."""
    if kernel == "bwd":
        no_atomics, n = ATOMIC.subn(r"if (r == 1.5e-38f) *(\1) = r;", tree_src)
        if n != N_ATOMICS:
            raise RuntimeError(f"variant no_atomics: {n} atomicAdd calls, expected {N_ATOMICS}")
        return {"no_atomics": no_atomics,
                "no_phase_b": _cut(tree_src, PHASE_B_START, PHASE_B_END, "no_phase_b")}
    timed = _replace(tree_src, TILE_LINE, TILE_LINE + "  unsigned long long ab_t0;\n"
                     + TIMER.format(0), "block_times")
    timed = _replace(timed, WRITE_START, "  unsigned long long ab_t1;\n" + TIMER.format(1)
                     + "  unsigned ab_sm;\n"
                     + '  asm volatile("mov.u32 %0, %%smid;" : "=r"(ab_sm));\n'
                     + WRITE_START, "block_times")
    # thread 0 owns pixel 0, whose first three words it wrote just before
    timed = _replace(timed, WRITE_END, WRITE_END
                     + "  if (tid == 0) {\n"
                     + "    int* o = reinterpret_cast<int*>(out + (size_t)tile * P * ce);\n"
                     + "    o[0] = (int)ab_t0;\n    o[1] = (int)ab_t1;\n    o[2] = (int)ab_sm;\n"
                     + "  }\n", "block_times")
    return {
        "no_colour": _replace(tree_src, COLOUR_CALL, "    ;\n", "no_colour"),
        "stage_only": _cut(tree_src, WALK_START, WALK_END, "stage_only",
                           keep="    const bool more = true;\n"),
        "one_slot": _replace(tree_src, SLOTS_LINE, "  static constexpr int SLOTS = 1;\n",
                             "one_slot"),
        "other_ppt": _replace(tree_src, PPT_LINE,
                              "static constexpr int PPT = CEM > 12 ? 2 : SUB ? 4 : 2;",
                              "other_ppt"),
        "no_exact": _replace(_replace(tree_src, EXACT_PICKS[0], "  if (false) {\n", "no_exact"),
                             EXACT_PICKS[1], "  if (false) {\n", "no_exact"),
        "block_times": timed,
    }


def build(name: str, sources: dict[str, Path], out_dir: Path):
    """{label: (library, nvcc log)}, one nvcc per source, all together."""
    from mobgs_tpu_torch.ops import cuda_raster
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for label, src in sources.items():
        so = out_dir / f"lib{name}_{label}.so"
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


def range_args(src: Path) -> tuple[str, ...]:
    """The tile-range arguments a source's entry point takes after ``ntx``:
    ``tile0`` (since the tile-axis shard) and ``tpv`` (since the multi-view
    launch, the tree's); an earlier design's takes neither."""
    text = src.read_text()
    return tuple(a for a in ("tile0", "tpv") if f"int {a}" in text)


def bind(so: Path, name: str, ranges: tuple[str, ...]):
    """The entry point ``name`` of a library, bound as its source declares it."""
    lib = ctypes.CDLL(str(so))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn = getattr(lib, name)
    n_ptr = 6 if name == "raster_fwd" else 10
    fn.argtypes = [vp] * n_ptr + [ci] * (6 + len(ranges)) + [vp]
    fn.restype = ci
    fn.ranges = ranges
    return fn


def _shape(fn, T, K, CE, ntx):
    """The shape arguments of a one-view launch over all its T tiles."""
    return (T, K, CE, ntx) + tuple({"tile0": 0, "tpv": T}[a] for a in fn.ranges)


def fwd_launcher(fn, args):
    """A zero-argument call of a ``raster_fwd`` on ``args`` (ids, counts,
    rec, col, ntx, sub), allocating its outputs as ``_launch`` does;
    returns (out, out2|None)."""
    from mobgs_tpu_torch.ops import cuda_raster
    ids, cnt, rec, col, ntx, sub = args
    T, K = ids.shape
    CE = col.shape[1]
    ch = cuda_raster._pick_chunk(K)
    stream = torch.cuda.current_stream().cuda_stream

    def run():
        out = torch.empty((T, cuda_raster.P, CE), dtype=torch.float32, device=rec.device)
        out2 = (torch.empty((T, cuda_raster.P), dtype=torch.float32, device=rec.device)
                if sub else None)
        shape = _shape(fn, T, K, CE, ntx)
        err = fn(ids.data_ptr(), cnt.data_ptr(), rec.data_ptr(), col.data_ptr(),
                 out.data_ptr(), out2.data_ptr() if sub else None, *shape, ch,
                 int(sub), stream)
        if err != 0:
            raise RuntimeError(f"raster_fwd launch failed: CUDA error {err}")
        return out, out2
    return run


def bwd_launcher(fn, args):
    """A zero-argument call of a ``raster_bwd`` on ``args`` (the operands of
    ``composite_bwd``), allocating its zeroed outputs as ``_launch_bwd``
    does; returns (grad_rec, grad_col)."""
    from mobgs_tpu_torch.ops import cuda_raster
    ids, cnt, rec, col, out, out2, g, g2, ntx, sub = args
    T, K = ids.shape
    N, CE = col.shape
    ch = cuda_raster._pick_chunk(K)
    stream = torch.cuda.current_stream().cuda_stream

    def run():
        gr = torch.zeros((N, cuda_raster.R), dtype=torch.float32, device=rec.device)
        gc = torch.zeros((N, CE), dtype=torch.float32, device=rec.device)
        shape = _shape(fn, T, K, CE, ntx)
        err = fn(ids.data_ptr(), cnt.data_ptr(), rec.data_ptr(), col.data_ptr(),
                 out.data_ptr(), out2.data_ptr() if sub else None, g.data_ptr(),
                 g2.data_ptr() if sub else None, gr.data_ptr(), gc.data_ptr(),
                 *shape, ch, int(sub), stream)
        if err != 0:
            raise RuntimeError(f"raster_bwd launch failed: CUDA error {err}")
        return gr, gc
    return run


def protocol_cases(kernel: str, dev, with_ce29: bool, k_view: int = 0):
    """The protocol view's operands of ``kernel``, built as chip_smoke.py
    builds them (same seeds); with ``k_view`` K, phase 14's K-ladder view
    instead (128x128 at a quarter of the focal length, opacities x0.1,
    max_per_tile K). Forward: {case: (ids, counts, rec, col, ntx, sub)};
    backward: {case: (ids, counts, rec, col, out, out2, g, g2, ntx, sub)},
    with the forward kernel's outputs and seeded upstream gradients."""
    from mobgs_tpu_torch.data.cameras import Camera
    from mobgs_tpu_torch.models import render as R
    from mobgs_tpu_torch.ops import cuda_raster, projection, tiles

    cfg, data, _, stat, dyn = protocol_scene(dev)
    k_mat = np.array(data.K[0], np.float32)
    w, h, budget, opac_x = W, H, cfg.max_per_tile, 1.0
    if k_view:
        k_mat[0, 0] *= 0.25
        k_mat[1, 1] *= 0.25
        k_mat[0, 2] = k_mat[1, 2] = K_VIEW / 2
        w, h, budget, opac_x = K_VIEW, K_VIEW, k_view, 0.1
    cam = Camera(w2c=torch.as_tensor(data.w2c[0], device=dev),
                 K=torch.as_tensor(k_mat, device=dev),
                 time=torch.tensor(float(data.time[0]), device=dev))
    with torch.no_grad():
        geom = R.assemble(stat, dyn, cam.time, data.max_time)
        splats = projection.project(geom.means, geom.quats, geom.scales, cam.w2c, cam.K, w, h,
                                    eps2d=cfg.eps2d, near=cfg.near, sigma_cut=cfg.sigma_cut)
        geom = geom._replace(opacity=opac_x * geom.opacity)
        bins = tiles.bin_gaussians(splats, w, h, tiles_per_gauss=cfg.tiles_per_gauss,
                                   max_per_tile=budget)
    N = geom.means.shape[0]
    ids, cnt, ntx = bins.gauss_ids.contiguous(), bins.counts.contiguous(), bins.n_tiles_x
    ext = torch.cat([geom.colors, splats.depths[:, None], torch.ones(N, 1, device=dev)], 1)
    rng = np.random.default_rng(7)
    cols = {"latent_ce9": (geom.colors, False)}
    if kernel == "fwd":
        cols["render_ce11"] = (ext, False)
    cols["mid_ce11_sub"] = (ext, True)
    if with_ce29:
        flow = torch.as_tensor(rng.normal(size=(N, 18)).astype(np.float32), device=dev)
        cols["flow_mid_ce29_sub"] = (
            torch.cat([geom.colors, flow, splats.depths[:, None], ext[:, -1:]], 1), True)
    cases = {}
    for name, (col, sub) in cols.items():
        col = col.detach().contiguous()
        rec = cuda_raster.pack_records(splats, geom.opacity,
                                       geom.opacity * geom.dyn_mask if sub else None).detach()
        if kernel == "fwd":
            cases[name] = (ids, cnt, rec, col, ntx, sub)
            continue
        with torch.no_grad():
            out, out2 = cuda_raster.composite_fwd(ids, cnt, rec, col, ntx, sub)
        g = torch.as_tensor(rng.normal(size=out.shape).astype(np.float32), device=dev)
        g2 = (torch.as_tensor(rng.normal(size=out2.shape).astype(np.float32), device=dev)
              if sub else None)
        cases[name] = (ids, cnt, rec, col, out, out2, g, g2, ntx, sub)
    return cases


def max_abs_diff(a, b):
    """Largest |a - b| over a forward's outputs (out, out2|None)."""
    d = float((a[0] - b[0]).abs().max())
    if a[1] is not None:
        d = max(d, float((a[1] - b[1]).abs().max()))
    return d


def rel_errs(k, p, sub):
    rows = 7 if sub else 6
    errs = [float((k[0][:, j] - p[0][:, j]).abs().max()) / max(float(p[0][:, j].abs().max()), 1e-30)
            for j in range(rows)]
    errs.append(float((k[1] - p[1]).abs().max()) / max(float(p[1].abs().max()), 1e-30))
    return max(errs)


def block_times(out, n_sm: int, counts):
    """The one-wave tail, from a ``block_times`` build's output: per block
    its start and end ``%globaltimer`` (low 32 bits, ns) and its SM, with
    the correlation of a block's time with its tile's count."""
    raw = out[:, 0, :3].contiguous().view(torch.int32).cpu().numpy().astype(np.int64)
    t0, t1, sm = raw[:, 0], raw[:, 1], raw[:, 2]
    ref = t0[0]
    t0 = (t0 - ref + 2 ** 31) % 2 ** 32 - 2 ** 31  # offsets within +-2 s
    t1 = (t1 - ref + 2 ** 31) % 2 ** 32 - 2 ** 31
    start = t0.min()
    t0, t1 = t0 - start, t1 - start
    span = float(t1.max())
    tiles = np.bincount(sm, minlength=n_sm)
    finish = np.zeros(n_sm)
    np.maximum.at(finish, sm, t1)
    dur = (t1 - t0) / 1e3
    cnt = counts.cpu().numpy()
    res = {"span_us": span / 1e3, "block_us_mean": float(dur.mean()),
           "slowest_tile": int(dur.argmax()), "slowest_tile_count": int(cnt[dur.argmax()]),
           "corr_block_us_count": float(np.corrcoef(dur, cnt)[0, 1]),
           "block_us_min": float(dur.min()), "block_us_max": float(dur.max()),
           # the share of SM-time between the kernel's first start and last
           # end in which an SM had no block left
           "idle_share": float(1.0 - finish.mean() / span),
           "tiles_per_sm": {int(n): int((tiles == n).sum()) for n in np.unique(tiles)}}
    for n in np.unique(tiles):
        if n:
            res[f"finish_us_sm_with_{int(n)}"] = float(finish[tiles == n].mean() / 1e3)
    return res


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernel", choices=("fwd", "bwd"), required=True)
    ap.add_argument("--source", action="append", default=[], metavar="LABEL=PATH")
    ap.add_argument("--variants", action="store_true")
    ap.add_argument("--ce29", action="store_true")
    ap.add_argument("--k", type=int, default=0, metavar="K",
                    help="the K-ladder view at max_per_tile K instead of the protocol view")
    ap.add_argument("--out", type=Path, help="also write the JSON object here")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_raster_ab: no CUDA card", file=sys.stderr)
        return 2
    from mobgs_tpu_torch.ops import cuda_raster
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    name = f"raster_{a.kernel}"
    ab_dir = ROOT / "build" / "ab"
    ab_dir.mkdir(parents=True, exist_ok=True)
    sources = {"tree": cuda_raster.CSRC / f"{name}.cu"}
    for spec in a.source:
        label, _, path = spec.partition("=")
        if not label or not path or label in sources:
            raise SystemExit(f"bad --source {spec!r}")
        sources[label] = Path(path)
    if a.variants:
        for label, text in variants(a.kernel, sources["tree"].read_text()).items():
            path = ab_dir / f"{name}_{label}.cu"
            path.write_text(text)
            sources[label] = path
    t0 = time.time()
    built = build(name, sources, ab_dir)
    print(f"built {len(built)} libraries in {time.time() - t0:.1f} s")
    for label, (_, log) in built.items():
        for line in log.splitlines():
            if any(k in line for k in ("Compiling entry", "registers", "spill")):
                print(f"  ptxas {label}:", line.split("info    :")[-1].strip())
    fns = {label: bind(so, name, range_args(sources[label]))
           for label, (so, _) in built.items()}
    cases = protocol_cases(a.kernel, dev, a.ce29, a.k)
    others = [lb for lb in fns if lb != "tree"]
    order = ["tree", *others, *reversed(others), "tree"]
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    result = {"kernel": a.kernel, "card": card, "iters": ITERS, "order": order,
              "k_view": a.k, "cases": {}}
    launcher = fwd_launcher if a.kernel == "fwd" else bwd_launcher
    for case, args in cases.items():
        sub = args[-1]
        runs = {lb: launcher(fn, args) for lb, fn in fns.items()}
        times = {lb: [] for lb in fns}
        for lb in order:
            times[lb].append(cuda_ms(runs[lb], ITERS))
        res = {"ms": times, "CE": int(args[3].shape[1]), "sub": bool(sub)}
        if a.kernel == "fwd":
            with torch.no_grad():
                tree = runs["tree"]()
                plain = cuda_raster.composite_tiles_plain(*args)
                errs = {lb: max_abs_diff(runs[lb](), tree) for lb in fns}
                res["tree_vs_plain_max_abs"] = max_abs_diff(tree, plain)
                if "block_times" in fns:
                    bt = block_times(runs["block_times"]()[0], n_sm, args[1])
                    # the slowest tile alone on the card: every other count 0
                    alone = torch.zeros_like(args[1])
                    alone[bt["slowest_tile"]] = args[1][bt["slowest_tile"]]
                    bt["slowest_tile_alone_us"] = 1e3 * cuda_ms(
                        launcher(fns["tree"], (args[0], alone, *args[2:])), ITERS)
                    res["block_times"] = bt
            res["max_abs_diff_to_tree"] = errs
        else:
            plain = cuda_raster.composite_bwd_plain(*args)
            errs = {lb: rel_errs(runs[lb](), plain, sub) for lb in fns}
            res["max_rel_err"] = errs
        torch.cuda.synchronize()
        result["cases"][case] = res
        print(f"{case}: " + ", ".join(
            f"{lb} {' / '.join(f'{t:.4f}' for t in times[lb])} ms (err {errs[lb]:.3g})"
            for lb in fns))
        if "block_times" in res:
            print(f"  block times: {json.dumps(res['block_times'])}")
        if "tree_vs_plain_max_abs" in res:
            print(f"  tree vs plain: max abs {res['tree_vs_plain_max_abs']:.3g}")
    print(card)
    line = json.dumps(result)
    if a.out:
        a.out.parent.mkdir(parents=True, exist_ok=True)
        a.out.write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
