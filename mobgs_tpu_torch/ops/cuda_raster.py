"""Tile compositing on the card (counterpart of
``mobgs_tpu/ops/pallas_raster.py``): the hand-written CUDA forward and
backward kernels, their plain PyTorch versions, and the epilogue.

What it replaces. ``csrc/raster_fwd.cu`` is one kernel with a template
flag. Without it, it computes what ``_fwd_kernel``
(``pallas_raster.py:118-148``, ``pallas_call`` at :441) computes; with it,
``_fwd_kernel_sub`` (:151-200, ``pallas_call`` at :506): a second
transmittance chain over the subset opacities, giving an alpha-only map,
where the tile stops only once both chains have saturated.
``csrc/raster_bwd.cu`` is the backward, one kernel with the same flag:
``_bwd_kernel`` (:203-282, ``pallas_call`` at :468) and
``_bwd_kernel_sub`` (:285-383, :540), with the gather of
``_gather_records`` and the scatter-add of its VJP done inside the kernel
(per-Gaussian gradients by ``atomicAdd``). Both include
``csrc/raster_common.cuh``, which holds the σ/α and transmittance
arithmetic whose rounding decides the gates, so the backward's replay keeps
and drops the same pairs as the forward and stops at the same chunk.

What bounds them on an H100. Per (slot, pixel) pair the forward does about
``16 + 2·CE`` float32 operations and one ``expf``, the backward about twice
that plus the reduction over pixels, and per chunk they read ``(7 + CE)·4``
bytes per slot; at the seesaw protocol shape (576 tiles, K=256, CE=11) the
operations outweigh the bytes by far, so the bound is the card's float32
rate. Both read each chunk's records once per tile, gathered by
``gauss_id`` straight into shared memory: no ``[T, NC, R+CE]`` record
table in device memory, which is what ``_gather_records``
(``pallas_raster.py:398-428``) builds for the TPU's block specs. The
forward gives each thread several pixels of one column and reads each
record as two 16-byte shared loads that feed all of them, in a
straight-line walk of two slots a step; each pixel's order of operations
does not depend on how many pixels a thread owns, and its colour sums are
chunked as the plain version's (``raster_fwd.cu``'s note). The backward
replays a few slots at a time per pixel into shared memory, then sums each
slot over the tile's pixels with one atomic per slot and term
(``raster_bwd.cu``'s note). :func:`fwd_occupancy` and
:func:`bwd_occupancy` report what the card gives each instance. No tensor
cores or TMA.

The plain versions (:func:`composite_tiles_plain`,
:func:`composite_bwd_plain`) keep the Pallas semantics exactly — chunks of
``ch``, the exclusive prefix product inside each chunk, T carried between
chunks, the chunk-level early exit per tile — and process all tiles at
once. They serve CPU tensors (and ``backend="plain"``);
:func:`composite_fwd` and :func:`composite_bwd` launch the kernels for CUDA
tensors or raise; past 32 colour columns they launch them once per column
group (:func:`column_groups`). One launch may composite several views of
one size, their tiles stacked along the rows (``tpv`` tiles a view): the
train step's latent renders of a view go as one launch of E-1 views, and
so do its exposure-flow passes (CE=11 + sub). Gradients reach ``rec`` and
``col`` through one ``torch.autograd.Function`` per route: the kernels' for
CUDA tensors, the plain backward's for the plain route, never autograd
through the plain forward's ops.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

from mobgs_tpu_torch.ops.projection import ProjectedSplats
from mobgs_tpu_torch.ops.tiles import TILE, TileBins

P = TILE * TILE  # 256 pixels per tile
CH = 64          # minimum chunk unit; max_per_tile must divide by this
CH_MAX = 128     # preferred chunk size
R = 8            # record row: mx, my, conic a, b, c, opacity, subset opacity, pad
CE_GROUP = 32    # widest instance of the kernels; wider composites run in column groups
ALPHA_MAX = 0.99
ALPHA_MIN = 1.0 / 255.0
TRANS_EPS = 1e-4

# Launch counts of the kernels, by name, and of their instances, by name and
# channel count ("raster_fwd_sub CE=29"). The wrappers add one to each per
# launch and nowhere else; a run reads them to show its path went through
# the kernels.
launches = {"raster_fwd": 0, "raster_fwd_sub": 0,
            "raster_bwd": 0, "raster_bwd_sub": 0}
instance_launches: dict[str, int] = {}


def _count(name: str, CE: int):
    launches[name] += 1
    key = f"{name} CE={CE}"
    instance_launches[key] = instance_launches.get(key, 0) + 1


def reset_launches():
    """Set every launch count to 0."""
    for key in launches:
        launches[key] = 0
    instance_launches.clear()

CSRC = Path(__file__).resolve().parent.parent / "csrc"
_vp, _ci = ctypes.c_void_p, ctypes.c_int
# csrc/<name>.cu for each library, and the argument types of its entry
# points (each returns a CUDA error code); ``warp`` is the flow-warp loss's
# pair (``ops/cuda_warp.py``), built and bound the same way
ENTRY_POINTS = {
    "raster_fwd": {"raster_fwd": [_vp] * 6 + [_ci] * 8 + [_vp],
                   "raster_fwd_occupancy": [_ci, _ci, _ci, _vp]},
    "raster_bwd": {"raster_bwd": [_vp] * 10 + [_ci] * 8 + [_vp],
                   "raster_bwd_occupancy": [_ci, _ci, _ci, _vp]},
    "warp": {"warp_fwd": [_vp] * 3 + [_ci] * 4 + [_vp],
             "warp_bwd": [_vp] * 5 + [_ci] * 4 + [_vp]},
}
KERNELS = tuple(ENTRY_POINTS)
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
_libs: dict[str, ctypes.CDLL] = {}


def _pick_chunk(K: int) -> int:
    """Largest chunk size <= CH_MAX that divides max_per_tile."""
    for c in (CH_MAX, CH):
        if K % c == 0:
            return c
    raise ValueError(f"max_per_tile={K} must be a multiple of {CH}")


# ---------------------------------------------------------------------------
# build and bind

def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def _source(name: str) -> Path:
    return CSRC / f"{name}.cu"


def _library_path(name: str) -> Path:
    """``build/kernels/lib<name>_<hash>.so``, the hash taken over the source,
    every header of ``csrc/`` (names and contents) and the flags, so an
    edited source or header is rebuilt and an unchanged one reused."""
    sha = hashlib.sha1(_source(name).read_bytes())
    for h in sorted(CSRC.glob("*.cuh")):
        sha.update(h.name.encode() + b"\0" + h.read_bytes())
    sha.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{sha.hexdigest()[:12]}.so"


def build_kernels(names=KERNELS) -> dict[str, tuple[Path, str]]:
    """Compile ``csrc/<name>.cu`` for sm_90a into ``build/kernels/``, one
    ``nvcc`` per library, all started together.

    Returns {name: (library path, the compiler's ``-Xptxas -v`` report:
    registers, shared memory and spills of each kernel instance)}."""
    procs = {}
    for name in names:
        so = _library_path(name)
        if so.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        procs[name] = (so, tmp, subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(_source(name))],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (so, tmp, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc {name} failed ({proc.returncode}):\n{log}")
            continue
        so.with_suffix(".log").write_text(log)
        os.replace(tmp, so)
    if failed:
        raise RuntimeError("\n".join(failed))
    built = {}
    for name in names:
        so = _library_path(name)
        log = so.with_suffix(".log")
        built[name] = (so, log.read_text() if log.exists() else "")
    return built


def _library(name: str) -> ctypes.CDLL:
    if name not in _libs:
        so, _ = build_kernels((name,))[name]
        lib = ctypes.CDLL(str(so))
        for entry, argtypes in ENTRY_POINTS[name].items():
            fn = getattr(lib, entry)
            fn.argtypes = argtypes
            fn.restype = _ci
        _libs[name] = lib
    return _libs[name]


def _check_operands(kernel: str, ids, counts, rec, col, pixel=()):
    """Device, type, contiguity and shape of the operands; ``pixel`` holds
    (name, tensor, shape) of the per-pixel operands of the backward."""
    named = [("ids", ids, torch.int32), ("counts", counts, torch.int32),
             ("rec", rec, torch.float32), ("col", col, torch.float32)]
    named += [(n, x, torch.float32) for n, x, _ in pixel]
    for name, t, dt in named:
        if t.device.type != "cuda":
            raise ValueError(f"{kernel}: {name} is on {t.device}, not CUDA")
        if t.dtype != dt:
            raise ValueError(f"{kernel}: {name} is {t.dtype}, expected {dt}")
        if not t.is_contiguous():
            raise ValueError(f"{kernel}: {name} is not contiguous")
        if t.device != rec.device:
            raise ValueError(f"{kernel}: operands on different devices")
    T, K = ids.shape
    CE = col.shape[1]
    if K % CH != 0:
        raise ValueError(f"{kernel}: K={K} is not a multiple of {CH}")
    if CE < 1:
        raise ValueError(f"{kernel}: CE={CE} is not positive")
    if counts.shape != (T,) or rec.shape[1] != R or col.shape[0] != rec.shape[0]:
        raise ValueError(f"{kernel}: operand shapes disagree: "
                         f"ids {tuple(ids.shape)} counts {tuple(counts.shape)} "
                         f"rec {tuple(rec.shape)} col {tuple(col.shape)}")
    for name, t, shape in pixel:
        if tuple(t.shape) != shape:
            raise ValueError(f"{kernel}: {name} is {tuple(t.shape)}, "
                             f"expected {shape}")


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def column_groups(CE: int) -> list[tuple[int, int]]:
    """The column ranges ``[a, b)`` a composite of CE channels launches as:
    one range up to CE_GROUP, else ceil(CE / CE_GROUP) ranges of near-equal
    width (CE=33: 17 + 16; CE=65: 22 + 22 + 21).

    Splitting by columns is exact: the colour sums are independent per
    column, and the transmittance, the gates and the per-tile exit depend
    on the records alone. With the sub chain every group launches the
    ``SUB=true`` instance, so that each group's tiles exit where the one
    launch's would (on both chains, not on the first alone); the backward
    hands ``g2`` to the first group only and zeros to the others, whose sub
    chain then adds exact zeros, so its row-6 and σ terms count once. The
    per-slot gradients of the records are sums over columns of per-column
    terms, so the groups' ``grad_rec`` tables add up to the one launch's.
    """
    n = -(-CE // CE_GROUP)
    width, extra = divmod(CE, n)
    bounds, a = [], 0
    for i in range(n):
        b = a + width + (1 if i < extra else 0)
        bounds.append((a, b))
        a = b
    return bounds


def _tiles_per_view(T: int, tile0: int, tpv: int | None) -> int:
    """The tile count of one view a launch takes: ``tpv``, or for a launch
    over (a range of) one view's tiles, one past its last tile."""
    return tile0 + T if tpv is None else tpv


def _launch(ids, counts, rec, col, ntx: int, sub: bool, tile0: int = 0,
            tpv: int | None = None):
    """Launch the forward kernel on the current stream, once per column
    group (:func:`column_groups`), over the tiles [tile0, tile0 + T) of the
    image (``ids`` and ``counts`` hold those rows), or over views of ``tpv``
    tiles each stacked along the rows; returns (out, out2|None)."""
    _check_operands("raster_fwd", ids, counts, rec, col)
    if rec.data_ptr() % 16:
        raise ValueError("raster_fwd: rec is not 16-byte aligned (records "
                         "are copied 16 bytes at a time)")
    outs, out2 = [], None
    for a, b in column_groups(col.shape[1]):
        o, o2 = _launch_group(ids, counts, rec, col[:, a:b].contiguous(), ntx, sub, tile0,
                              tpv)
        outs.append(o)
        out2 = o2 if out2 is None else out2
    return (outs[0] if len(outs) == 1 else torch.cat(outs, dim=-1)), out2


def _launch_group(ids, counts, rec, col, ntx: int, sub: bool, tile0: int = 0,
                  tpv: int | None = None):
    T, K = ids.shape
    CE = col.shape[1]
    dev = rec.device
    out = torch.empty((T, P, CE), dtype=torch.float32, device=dev)
    out2 = torch.empty((T, P), dtype=torch.float32, device=dev) if sub else None
    lib = _library("raster_fwd")
    with torch.cuda.device(dev):
        err = lib.raster_fwd(ids.data_ptr(), counts.data_ptr(),
                             rec.data_ptr(), col.data_ptr(), out.data_ptr(),
                             out2.data_ptr() if sub else None,
                             T, K, CE, ntx, tile0, _tiles_per_view(T, tile0, tpv),
                             _pick_chunk(K), int(sub), _stream(dev))
    if err != 0:
        raise RuntimeError(f"raster_fwd launch failed: CUDA error {err}")
    _count("raster_fwd_sub" if sub else "raster_fwd", CE)
    return out, out2


def _launch_bwd(ids, counts, rec, col, out, out2, g, g2, ntx: int, sub: bool,
                tile0: int = 0, tpv: int | None = None):
    """Launch the backward kernel on the current stream, once per column
    group (:func:`column_groups`), over the tiles [tile0, tile0 + T) of the
    image, or over views of ``tpv`` tiles each; returns (grad_rec [N, R],
    grad_col [N, CE])."""
    T, K = ids.shape
    N, CE = col.shape
    pixel = [("out", out, (T, P, CE)), ("g", g, (T, P, CE))]
    if sub:
        pixel += [("out2", out2, (T, P)), ("g2", g2, (T, P))]
    _check_operands("raster_bwd", ids, counts, rec, col, pixel)
    grad_rec, grad_cols = None, []
    for i, (a, b) in enumerate(column_groups(CE)):
        gr, gc = _launch_bwd_group(
            ids, counts, rec, col[:, a:b].contiguous(), out[..., a:b].contiguous(),
            out2, g[..., a:b].contiguous(),
            g2 if i == 0 or g2 is None else torch.zeros_like(g2), ntx, sub, tile0, tpv)
        grad_rec = gr if grad_rec is None else grad_rec + gr
        grad_cols.append(gc)
    return grad_rec, grad_cols[0] if len(grad_cols) == 1 else torch.cat(grad_cols, dim=1)


def _launch_bwd_group(ids, counts, rec, col, out, out2, g, g2, ntx: int, sub: bool,
                      tile0: int = 0, tpv: int | None = None):
    T, K = ids.shape
    N, CE = col.shape
    dev = rec.device
    grad_rec = torch.zeros((N, R), dtype=torch.float32, device=dev)
    grad_col = torch.zeros((N, CE), dtype=torch.float32, device=dev)
    lib = _library("raster_bwd")
    with torch.cuda.device(dev):
        err = lib.raster_bwd(ids.data_ptr(), counts.data_ptr(), rec.data_ptr(),
                             col.data_ptr(), out.data_ptr(),
                             out2.data_ptr() if sub else None, g.data_ptr(),
                             g2.data_ptr() if sub else None,
                             grad_rec.data_ptr(), grad_col.data_ptr(),
                             T, K, CE, ntx, tile0, _tiles_per_view(T, tile0, tpv),
                             _pick_chunk(K), int(sub), _stream(dev))
    if err != 0:
        raise RuntimeError(f"raster_bwd launch failed: CUDA error {err}")
    _count("raster_bwd_sub" if sub else "raster_bwd", CE)
    return grad_rec, grad_col


def _occupancy(name: str, n: int, CE: int, K: int, sub: bool, device):
    info = (ctypes.c_int * n)()
    lib = _library(name)
    with torch.cuda.device(device if device is not None else torch.cuda.current_device()):
        err = getattr(lib, f"{name}_occupancy")(CE, _pick_chunk(K), int(sub),
                                               ctypes.addressof(info))
    if err != 0:
        raise RuntimeError(f"{name}_occupancy failed: CUDA error {err}")
    return dict(zip(("blocks_per_sm", "smem_bytes", "registers", "local_bytes",
                     "threads"), info))


def bwd_occupancy(CE: int, K: int, sub: bool, device=None) -> dict[str, int]:
    """What the card gives the backward kernel instance that a launch with
    CE channels and max_per_tile K takes: resident ``blocks_per_sm``,
    ``smem_bytes`` per block, ``registers`` per thread and ``local_bytes``
    per thread (spills), from the CUDA occupancy API."""
    return _occupancy("raster_bwd", 4, CE, K, sub, device)


def fwd_occupancy(CE: int, K: int, sub: bool, device=None) -> dict[str, int]:
    """As :func:`bwd_occupancy`, for the forward kernel's instance, with its
    block size (``threads``: it owns several pixels per thread)."""
    return _occupancy("raster_fwd", 5, CE, K, sub, device)


class _CompositeCuda(torch.autograd.Function):
    """The kernels' route: forward kernel, backward kernel."""

    @staticmethod
    def forward(ctx, ids, counts, rec, col, ntx, sub, tile0=0, tpv=None):
        out, out2 = _launch(ids, counts, rec, col, ntx, sub, tile0, tpv)
        ctx.save_for_backward(ids, counts, rec, col, out, out2)
        ctx.ntx, ctx.sub, ctx.tile0, ctx.tpv = ntx, sub, tile0, tpv
        return (out, out2) if sub else out

    @staticmethod
    def backward(ctx, g, g2=None):
        ids, counts, rec, col, out, out2 = ctx.saved_tensors
        g2 = g2.contiguous() if ctx.sub else None
        grad_rec, grad_col = _launch_bwd(ids, counts, rec, col, out, out2,
                                         g.contiguous(), g2, ctx.ntx, ctx.sub, ctx.tile0,
                                         ctx.tpv)
        return None, None, grad_rec, grad_col, None, None, None, None


class _CompositePlain(torch.autograd.Function):
    """The plain route: :func:`composite_tiles_plain` forward,
    :func:`composite_bwd_plain` backward (what the kernels are held
    against), on any device."""

    @staticmethod
    def forward(ctx, ids, counts, rec, col, ntx, sub, tile0=0, tpv=None):
        out, out2 = composite_tiles_plain(ids, counts, rec, col, ntx, sub, tile0=tile0,
                                          tpv=tpv)
        ctx.save_for_backward(ids, counts, rec, col, out, out2)
        ctx.ntx, ctx.sub, ctx.tile0, ctx.tpv = ntx, sub, tile0, tpv
        return (out, out2) if sub else out

    @staticmethod
    def backward(ctx, g, g2=None):
        ids, counts, rec, col, out, out2 = ctx.saved_tensors
        grad_rec, grad_col = composite_bwd_plain(ids, counts, rec, col, out,
                                                 out2, g, g2, ctx.ntx, ctx.sub,
                                                 ctx.tile0, ctx.tpv)
        return None, None, grad_rec, grad_col, None, None, None, None


# ---------------------------------------------------------------------------
# the plain version

def _tile_pixels(T: int, ntx: int, tile0: int, dt, dev, tpv: int | None = None):
    """Pixel centres (px, py), each [T, 1, P], of the image tiles
    [tile0, tile0 + T), or of the rows of views of ``tpv`` tiles each."""
    lin = torch.arange(P, device=dev)
    tile = torch.arange(tile0, tile0 + T, device=dev) % _tiles_per_view(T, tile0, tpv)
    px = ((lin % TILE).to(dt) + 0.5)[None, None, :] \
        + ((tile % ntx) * TILE).to(dt)[:, None, None]
    py = ((lin // TILE).to(dt) + 0.5)[None, None, :] \
        + ((tile // ntx) * TILE).to(dt)[:, None, None]
    return px, py


def composite_tiles_plain(ids: torch.Tensor, counts: torch.Tensor,
                          rec: torch.Tensor, col: torch.Tensor, ntx: int,
                          sub: bool = False, work: dict | None = None,
                          tile0: int = 0, tpv: int | None = None):
    """Plain PyTorch version of the kernel, with the Pallas semantics.

    Args:
      ids: [T, K] int32 Gaussian ids in depth order (garbage past count).
      counts: [T] int32 live entries per tile.
      rec: [N, R] records (mx, my, a, b, c, opacity, subset opacity, pad).
        The sums run in its dtype: float32 on every path, float64 for a
        reference of higher precision.
      col: [N, CE] colour columns, of ``rec``'s dtype.
      ntx: tiles per image row (pixel origin of tile t).
      sub: also run the subset-opacity chain (record column 6).
      tile0: the image tile of row 0: ``ids`` and ``counts`` hold the
        tiles [tile0, tile0 + T) of the image (a shard of the tile axis).
      tpv: the tile count of one view, where the rows hold several views
        of one size in turn (view v's tile t at row v * tpv + t, its ids
        pointing at its own rows of ``rec`` and ``col``); None for one view.
      work: when a dict, receives what this input needed: ``slots`` [T],
        the live slots each tile composited before its early exit;
        ``valid`` / ``valid_sub``, the (slot, pixel) pairs whose alpha
        passed the gates in each chain; ``n_ref``, the distinct Gaussians
        those slots read.

    Returns:
      (out [T, P, CE], out2 [T, P] or None).
    """
    T, K = ids.shape
    ch = _pick_chunk(K)
    dev = rec.device
    dt = rec.dtype
    px, py = _tile_pixels(T, ntx, tile0, dt, dev, tpv)
    counts = counts.to(torch.int64)

    acc = torch.zeros((T, P, col.shape[1]), dtype=dt, device=dev)
    trans = torch.ones((T, P), dtype=dt, device=dev)
    acc2 = torch.zeros((T, P), dtype=dt, device=dev) if sub else None
    trans2 = torch.ones((T, P), dtype=dt, device=dev) if sub else None
    slots = torch.zeros(T, dtype=torch.int64, device=dev)
    valid = [torch.zeros((), dtype=torch.int64, device=dev) for _ in range(2)]
    used = torch.zeros(rec.shape[0], dtype=torch.bool, device=dev)
    active = torch.ones(T, dtype=torch.bool, device=dev)
    slot = torch.arange(ch, device=dev)
    zero = torch.zeros((), dtype=dt, device=dev)

    for j in range(K // ch):
        s0 = j * ch
        active = active & (s0 < counts)
        if not bool(active.any()):
            break
        live = (s0 + slot)[None, :] < counts[:, None]               # [T, ch]
        idj = torch.where(live, ids[:, s0:s0 + ch].to(torch.int64), 0)
        r = rec[idj]                                                  # [T, ch, R]
        c = col[idj]                                                  # [T, ch, CE]
        dx = px - r[..., 0:1]                                         # [T, ch, P]
        dy = py - r[..., 1:2]
        sigma = (0.5 * (r[..., 2:3] * dx * dx + r[..., 4:5] * dy * dy)
                 + r[..., 3:4] * dx * dy)
        expneg = torch.exp(-sigma)
        keep = (sigma >= 0) & live[..., None] & active[:, None, None]

        def chain(op, T_carry):
            alpha = torch.clamp(op * expneg, max=ALPHA_MAX)
            alpha = torch.where(keep & (alpha > ALPHA_MIN), alpha, zero)
            incl = torch.cumprod(1.0 - alpha, dim=1)
            prefix = torch.cat([torch.ones_like(incl[:, :1]), incl[:, :-1]], 1)
            w = alpha * prefix * T_carry[:, None, :]
            return w, T_carry * incl[:, -1], alpha

        w, trans, alpha = chain(r[..., 5:6], trans)
        acc = acc + torch.einsum("tkp,tkc->tpc", w, c)
        tmax = trans.amax(dim=1)
        if sub:
            w2, trans2, alpha2 = chain(r[..., 6:7], trans2)
            acc2 = acc2 + w2.sum(dim=1)
            tmax = torch.maximum(tmax, trans2.amax(dim=1))
        if work is not None:
            slots += torch.where(active, torch.clamp(counts - s0, max=ch), 0)
            valid[0] += torch.count_nonzero(alpha)
            if sub:
                valid[1] += torch.count_nonzero(alpha2)
            used[idj[live & active[:, None]]] = True
        active = active & (tmax > TRANS_EPS)

    if work is not None:
        work.update(slots=slots, valid=valid[0], valid_sub=valid[1],
                    n_ref=torch.count_nonzero(used))
    return acc, acc2


def composite_bwd_plain(ids: torch.Tensor, counts: torch.Tensor,
                        rec: torch.Tensor, col: torch.Tensor,
                        out: torch.Tensor, out2: torch.Tensor | None,
                        g: torch.Tensor, g2: torch.Tensor | None, ntx: int,
                        sub: bool = False, tile0: int = 0, tpv: int | None = None):
    """Plain PyTorch version of the backward kernel, with the Pallas
    semantics (``_bwd_kernel`` / ``_bwd_kernel_sub``).

    Replays :func:`composite_tiles_plain` chunk by chunk over all tiles at
    once, with ``out`` (and ``out2``) from the forward as the suffix anchor:
    per chunk the inclusive prefix sum of ``w·(c·g)`` plus its carry gives
    ``gα = T_i·(c·g) − (g·C_total − Σ_{j≤i} w_j (c_j·g)) / max(1−α, 1e-6)``,
    gated by the forward's gates and ``raw α < 0.99``; ``gσ = −α·gα``. The
    per-(tile, slot) sums over pixels go onto the Gaussian axis with
    ``index_add_``; the mean columns carry dL/dmx, dL/dmy directly.

    Args:
      out, out2: the forward's outputs [T, P, CE], [T, P] (SUB).
      g, g2: upstream gradients of the same shapes.
      Others as :func:`composite_tiles_plain`.

    Returns:
      (grad_rec [N, R], grad_col [N, CE]).
    """
    T, K = ids.shape
    N, CE = col.shape
    ch = _pick_chunk(K)
    dev = rec.device
    dt = rec.dtype
    px, py = _tile_pixels(T, ntx, tile0, dt, dev, tpv)
    counts = counts.to(torch.int64)

    grad_rec = torch.zeros((N, R), dtype=dt, device=dev)
    grad_col = torch.zeros((N, CE), dtype=dt, device=dev)
    gdt = torch.sum(g * out, dim=-1)                                 # [T, P]
    trans = torch.ones((T, P), dtype=dt, device=dev)
    gacc = torch.zeros((T, P), dtype=dt, device=dev)
    if sub:
        g2 = g2.reshape(T, P)
        gdt2 = g2 * out2.reshape(T, P)
        trans2 = torch.ones((T, P), dtype=dt, device=dev)
        gacc2 = torch.zeros((T, P), dtype=dt, device=dev)
    active = torch.ones(T, dtype=torch.bool, device=dev)
    slot = torch.arange(ch, device=dev)
    zero = torch.zeros((), dtype=dt, device=dev)

    for j in range(K // ch):
        s0 = j * ch
        active = active & (s0 < counts)
        if not bool(active.any()):
            break
        live = (s0 + slot)[None, :] < counts[:, None]               # [T, ch]
        idj = torch.where(live, ids[:, s0:s0 + ch].to(torch.int64), 0)
        r = rec[idj]                                                  # [T, ch, R]
        c = col[idj]                                                  # [T, ch, CE]
        dx = px - r[..., 0:1]                                         # [T, ch, P]
        dy = py - r[..., 1:2]
        sigma = (0.5 * (r[..., 2:3] * dx * dx + r[..., 4:5] * dy * dy)
                 + r[..., 3:4] * dx * dy)
        expneg = torch.exp(-sigma)
        keep = (sigma >= 0) & live[..., None] & active[:, None, None]

        def chain(op, T_carry, cg, gdt_, gacc_):
            raw = op * expneg
            alpha = torch.clamp(raw, max=ALPHA_MAX)
            valid = keep & (alpha > ALPHA_MIN)
            alpha = torch.where(valid, alpha, zero)
            incl = torch.cumprod(1.0 - alpha, dim=1)
            prefix = torch.cat([torch.ones_like(incl[:, :1]), incl[:, :-1]], 1)
            t_i = prefix * T_carry[:, None, :]
            w = alpha * t_i
            gacc_incl = torch.cumsum(w * cg, dim=1) + gacc_[:, None, :]
            s_term = (gdt_[:, None, :] - gacc_incl) \
                / torch.clamp(1.0 - alpha, min=1e-6)
            gate = valid & (raw < ALPHA_MAX)
            g_alpha = torch.where(gate, t_i * cg - s_term, zero)
            g_op = torch.where(gate, expneg * g_alpha, zero)
            return (w, -alpha * g_alpha, g_op,
                    T_carry * incl[:, -1], gacc_incl[:, -1])

        cg = torch.einsum("tkc,tpc->tkp", c, g)
        w, g_sigma, g_op, trans, gacc = chain(r[..., 5:6], trans, cg, gdt, gacc)
        tmax = trans.amax(dim=1)
        cols = [None] * 7
        if sub:
            _, g_sigma2, cols[6], trans2, gacc2 = chain(
                r[..., 6:7], trans2, g2[:, None, :], gdt2, gacc2)
            g_sigma = g_sigma + g_sigma2
            tmax = torch.maximum(tmax, trans2.amax(dim=1))
        ca, cb, cc = r[..., 2:3], r[..., 3:4], r[..., 4:5]
        cols[0] = -g_sigma * (ca * dx + cb * dy)
        cols[1] = -g_sigma * (cc * dy + cb * dx)
        cols[2] = g_sigma * 0.5 * dx * dx
        cols[3] = g_sigma * dx * dy
        cols[4] = g_sigma * 0.5 * dy * dy
        cols[5] = g_op
        n_rows = 7 if sub else 6
        grec = torch.stack([x.sum(dim=-1) for x in cols[:n_rows]], dim=-1)
        flat = idj.reshape(-1)
        grad_rec[:, :n_rows].index_add_(0, flat, grec.reshape(-1, n_rows))
        grad_col.index_add_(0, flat,
                            torch.einsum("tkp,tpc->tkc", w, g).reshape(-1, CE))
        active = active & (tmax > TRANS_EPS)
    return grad_rec, grad_col


def composite_fwd(ids: torch.Tensor, counts: torch.Tensor, rec: torch.Tensor,
                  col: torch.Tensor, ntx: int, sub: bool = False, tile0: int = 0,
                  tpv: int | None = None):
    """The forward kernel's wrapper: launches it for CUDA tensors (its
    backward launches the backward kernel), and takes the plain route only
    for tensors on the CPU. ``ids`` and ``counts`` hold the image tiles
    [tile0, tile0 + T), or the tiles of views of ``tpv`` tiles each in turn
    (:func:`composite_tiles_plain`). Returns (out, out2|None)."""
    fn = _CompositePlain if rec.device.type == "cpu" else _CompositeCuda
    res = fn.apply(ids, counts, rec, col, ntx, sub, tile0, tpv)
    return res if sub else (res, None)


def composite_plain(ids: torch.Tensor, counts: torch.Tensor, rec: torch.Tensor,
                    col: torch.Tensor, ntx: int, sub: bool = False, tile0: int = 0,
                    tpv: int | None = None):
    """The plain route on any device (``backend="plain"``), differentiable
    through :func:`composite_bwd_plain`. Returns (out, out2|None)."""
    res = _CompositePlain.apply(ids, counts, rec, col, ntx, sub, tile0, tpv)
    return res if sub else (res, None)


def composite_bwd(ids, counts, rec, col, out, out2, g, g2, ntx: int,
                  sub: bool = False, tile0: int = 0, tpv: int | None = None):
    """The backward kernel's wrapper: launches it for CUDA tensors, and
    takes :func:`composite_bwd_plain` only for tensors on the CPU. Returns
    (grad_rec [N, R], grad_col [N, CE])."""
    if rec.device.type == "cpu":
        return composite_bwd_plain(ids, counts, rec, col, out, out2, g, g2,
                                   ntx, sub, tile0, tpv)
    return _launch_bwd(ids, counts, rec, col, out, out2, g, g2, ntx, sub, tile0, tpv)


# ---------------------------------------------------------------------------
# operands and epilogue

def pack_records(splats: ProjectedSplats, opacities: torch.Tensor,
                 sub_opacities: torch.Tensor | None = None) -> torch.Tensor:
    """[N, R] per-Gaussian records, or [V, N, R] for splats with a leading
    view axis; column 6 carries the fused subset pass's opacities when
    given (``pallas_raster.py:415-421``)."""
    zeros = torch.zeros_like(opacities)
    return torch.stack([
        splats.means2d[..., 0], splats.means2d[..., 1],
        splats.conics[..., 0], splats.conics[..., 1], splats.conics[..., 2],
        opacities,
        zeros if sub_opacities is None else sub_opacities,
        zeros,
    ], dim=-1).to(torch.float32).contiguous()


def _untile(x: torch.Tensor, ntx: int, nty: int, width: int, height: int,
            views: tuple[int, ...] = ()):
    """[T, P, C] tiles → [H, W, C] image; [V·T, P, C] → [V, H, W, C] with
    ``views`` (V,)."""
    C = x.shape[-1]
    x = x.reshape(views + (nty, ntx, TILE, TILE, C)).transpose(-4, -3)
    return x.reshape(views + (nty * TILE, ntx * TILE, C))[..., :height, :width, :]


def composite_rows(bins: TileBins, splats: ProjectedSplats,
                   colors: torch.Tensor, opacities: torch.Tensor,
                   sub_opacities: torch.Tensor | None = None,
                   want_depth: bool = True, want_alpha: bool = True,
                   backend: str = "auto", tile0: int = 0):
    """The composite's launch, before the epilogue: the operands packed
    from ``splats``, ``colors`` (with the depth and weight columns of
    ``want_depth`` / ``want_alpha``), ``opacities`` and ``sub_opacities``,
    and one launch per column group over the tile rows ``bins`` holds.

    The rows of a launch are its views' tiles in turn, ``ntx·nty`` a view
    (``ops/tiles.py::bin_views``); ``bins`` may hold a contiguous range of
    them, the first at row ``tile0``, and the kernels place each row's
    pixels by its row modulo the view's tile count. The outputs of ranges
    that cover the launch, concatenated, are the whole launch's: each
    tile's arithmetic is its own. ``splats``, ``colors``, ``opacities``
    (and ``sub_opacities``) carry a leading view axis [V, N, ...] where
    the launch has several views, each view's ids pointing at its rows of
    the flattened [V·N] records. ``backend`` as in :func:`composite_tiles`.

    Returns (out [T, P, CE], out2 [T, P] with ``sub_opacities``, else
    None) for the T rows of ``bins``.
    """
    if backend not in ("auto", "cuda", "plain"):
        raise ValueError(f"unknown backend {backend!r}")
    if backend == "cuda" and colors.device.type != "cuda":
        raise ValueError(f"backend='cuda' needs CUDA tensors, got {colors.device}")
    views = tuple(colors.shape[:-2])
    N = colors.shape[-2]
    ext = [colors.to(torch.float32)]
    if want_depth:
        ext.append(splats.depths[..., None].to(torch.float32))
    if want_alpha:
        ext.append(torch.ones(views + (N, 1), dtype=torch.float32, device=colors.device))
    col = torch.cat(ext, dim=-1)
    rec = pack_records(splats, opacities, sub_opacities)
    if views:
        col, rec = col.reshape(-1, col.shape[-1]), rec.reshape(-1, R)
    fn = composite_plain if backend == "plain" else composite_fwd
    return fn(bins.gauss_ids.to(torch.int32).contiguous(),
              bins.counts.to(torch.int32).contiguous(), rec, col.contiguous(),
              int(bins.n_tiles_x), sub=sub_opacities is not None, tile0=tile0,
              tpv=int(bins.n_tiles_x) * int(bins.n_tiles_y))


def composite_tiles(bins: TileBins, splats: ProjectedSplats,
                    colors: torch.Tensor, opacities: torch.Tensor,
                    width: int, height: int,
                    background: torch.Tensor | None = None,
                    sub_opacities: torch.Tensor | None = None,
                    want_depth: bool = True, want_alpha: bool = True,
                    backend: str = "auto", tile0: int = 0, gather=None):
    """Counterpart of ``composite_tiles_pallas`` (``pallas_raster.py:571-679``):
    :func:`composite_rows`, then the epilogue.

    ``sub_opacities`` [N] runs the fused second transmittance chain; its
    alpha map comes back as a fourth output. ``want_depth`` /
    ``want_alpha`` drop the extended depth / weight columns (depth needs
    the weight column, and so does a background). ``backend`` is
    ``"auto"`` (the wrapper: kernel for CUDA tensors, plain version for
    CPU tensors), ``"cuda"`` (the kernel; raises for CPU tensors) or
    ``"plain"``.

    Several views of one size composite in one launch per column group:
    ``splats``, ``colors``, ``opacities`` (and ``sub_opacities``) then carry
    a leading view axis [V, N, ...], and ``bins`` holds the views' tiles in
    turn (:func:`composite_rows`); the outputs carry the view axis too.

    A share of the launch (the tile-axis shard, ``pallas_raster.py:631-656``):
    ``bins`` holds the rows from ``tile0`` on, and ``gather`` maps their
    outputs, each [rows, P, ...], to all the launch's rows before the
    epilogue (the caller's all-gather of the ranges).

    Epilogue (``pallas_raster.py:657-679``): untile, clamp alpha with
    ``min(α, 1)``, blend the background as ``bg·(1−α)``, divide depth by
    ``max(α, 1e-10)``.

    Returns image [H, W, C], alpha [H, W], expected depth [H, W]
    (+ subset alpha [H, W] with ``sub_opacities``).
    """
    if want_depth and not want_alpha:
        raise ValueError("depth needs the weight column")
    if background is not None and not want_alpha:
        raise ValueError("background blending needs alpha")
    ntx, nty = int(bins.n_tiles_x), int(bins.n_tiles_y)
    views = tuple(colors.shape[:-2])
    C = colors.shape[-1]
    has_sub = sub_opacities is not None
    out, out2 = composite_rows(bins, splats, colors, opacities, sub_opacities, want_depth,
                               want_alpha, backend, tile0)
    if gather is not None:
        out = gather(out)
        out2 = gather(out2) if has_sub else None

    full = _untile(out, ntx, nty, width, height, views)
    image = full[..., :C]
    zeros_hw = torch.zeros(image.shape[:-1], dtype=torch.float32,
                           device=image.device)
    if want_alpha:
        alpha = torch.clamp(full[..., C + int(want_depth)], max=1.0)
    else:
        alpha = zeros_hw
    if background is not None:
        image = image + background[None, None, :] * (1.0 - alpha[..., None])
    if want_depth:
        exp_depth = full[..., C] / torch.clamp(alpha, min=1e-10)
    else:
        exp_depth = zeros_hw
    if has_sub:
        sub_alpha = torch.clamp(
            _untile(out2[..., None], ntx, nty, width, height, views)[..., 0], max=1.0)
        return image, alpha, exp_depth, sub_alpha
    return image, alpha, exp_depth
