"""The port's train CLI (``mobgs_tpu_torch/cli/train.py``) end to end
against the JAX package's (``mobgs_tpu/cli/train.py``), on the CPU.

Inputs: a small overlay of ``configs/stereo/seesaw.py`` (flow off, a
narrow deformation net: 4 output channels, ``multires [1]``) on a
48x32x6 synthetic scene at E=3, which seeds 208 static + 104 dynamic
Gaussians. The JAX CLI composites with its Pallas kernels in interpret
mode: it builds its ``RasterConfig`` inside ``main``
(``cli/train.py:71,78``), and on the CPU ``backend="auto"`` would pick the
XLA compositor, whose semantics differ from Pallas's, so the test gives
that name a ``backend="pallas"`` default. The port composites with the
plain forward and backward on the CPU.

1. The JAX CLI trains 2 iterations and writes its checkpoint directory.
2. Both CLIs resume from that directory's ``train_state.npz`` (each in a
   copy of the directory) to iteration 6, with an eval every 3. The
   resumed runs see the same data: the port's run gets the JAX
   generator's scene (the generators themselves are held against each
   other in ``tests/test_torch_render.py``, within 1e-4).
3. A fresh port run of 2 iterations writes the same files as step 1.

Tolerances, and why: the history's loss rtol 1e-5 per iteration and the
live counts and budgets exactly, as the loop's (``tests/test_torch_loop.py``);
the eval curve's PSNR atol 1e-3 dB (renders at the suite's forward
tolerance, 2e-5 per pixel, move a PSNR near 13 dB by ~1e-4 dB); the final
state as the train step's after one step (``tests/test_torch_train.py``):
the Adam moments and densify statistics relative to each leaf's largest
magnitude at NPZ_TOL, its gradient tolerances (twice for the second
moments), and the parameters at atol/rtol 1e-5 where their gradient is not
tiny (|mu| > 1e-3·max|mu|), since with eps=1e-15 Adam moves a parameter by
±lr on a gradient that rounds to either sign (the Adam trap); ``deform/*`` bit-equal, since
both carry it verbatim from the file; each run's PLYs and ``blce.pth``
exactly as its own final state.
"""

import json
import os
import shutil

import jax
import numpy as np
import pytest
import torch

import mobgs_tpu.ops.rasterize as jrasterize
from mobgs_tpu.cli import train as jcli
from mobgs_tpu.config import ModelHiddenParams as JHidden
from mobgs_tpu.data import synthetic as jsyn
from mobgs_tpu.io import checkpoint as jckpt
from mobgs_tpu.io import ply as jply
from mobgs_tpu.io import torch_ckpt as jTC

from mobgs_tpu_torch.cli import train as pcli
from mobgs_tpu_torch.config import load_scene_config
from mobgs_tpu_torch.data import synthetic as psyn
from mobgs_tpu_torch.io import checkpoint as pckpt
from mobgs_tpu_torch.io import ply as pply
from mobgs_tpu_torch.io import torch_ckpt as pTC
from mobgs_tpu_torch.models.blce import BLCE_FIELDS
from mobgs_tpu_torch.train import loop as pL
from mobgs_tpu_torch.train import optim as poptim

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OVERLAY = f"""_base_ = {os.path.join(ROOT, 'configs', 'stereo', 'seesaw.py')!r}
ModelHiddenParams = dict(
    kplanes_config={{'grid_dimensions': 2, 'input_coordinate_dim': 4,
                    'output_coordinate_dim': 4, 'resolution': [8, 8, 8, 4]}},
    multires=[1], net_width=16, timenet_width=8, timenet_output=8,
)
"""
COMMON = ["--synthetic", "--synthetic_size", "48x32x6", "--num_warp", "3", "--quiet"]
START_ITERS, END_ITERS, EVAL_EVERY = 2, 6, 3
# per leaf group, max|port - jax| / max|jax| of the final state's moments
# and statistics
NPZ_TOL = {"stat": 2e-3, "dyn": 2e-3, "sandwich": 1e-4, "blce": 1e-3, "step": 0}
# parameters off atol/rtol 1e-5 (within the Adam trap's bound), per leaf
TRAP_SHARE = 0.01
CKPT_FILES = ("point_cloud.ply", "point_cloud.pt", "point_cloud_static.ply", "blce.pth",
              "deformation.pth", "deformation_table.pth", "deformation_accum.pth",
              "train_state.npz")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's side runs on one CPU thread (as in test_torch_loop.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pallas_raster_config(*args, **kw):
    kw.setdefault("backend", "pallas")
    return _JRASTER_CONFIG(*args, **kw)


_JRASTER_CONFIG = jrasterize.RasterConfig


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cli")
    overlay = tmp / "small.py"
    overlay.write_text(OVERLAY)
    args = ["--configs", str(overlay), *COMMON]
    jstart, jres, pres, pfresh = (str(tmp / d) for d in ("jstart", "jres", "pres", "pfresh"))
    out = {"overlay": str(overlay), "dirs": dict(jstart=jstart, jres=jres, pres=pres,
                                                  pfresh=pfresh)}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jrasterize, "RasterConfig", _pallas_raster_config)
        out["jstart_ts"], _ = jcli.main(args + ["--iterations", str(START_ITERS),
                                                "--test_iterations", "100", "-m", jstart])
        ckpt = os.path.join(jstart, "point_cloud", f"iteration_{START_ITERS}",
                            "train_state.npz")
        shutil.copytree(jstart, jres)
        shutil.copytree(jstart, pres)
        resume = ["--iterations", str(END_ITERS), "--test_iterations", str(EVAL_EVERY),
                  "--start_checkpoint", ckpt]
        out["jres_ts"], out["jres_hist"] = jcli.main(args + resume + ["-m", jres])

    # the resumed port run trains on the JAX generator's scene
    def jax_scene(**kw):
        kw.pop("device")
        jd, traj = jsyn.generate(**kw)
        out["scene"] = jd
        return psyn.SceneData(**jd._asdict()), traj

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(psyn, "generate", jax_scene)
        out["pres_ts"], out["pres_hist"] = pcli.main(args + resume + ["-m", pres],
                                                     device="cpu")
    out["pfresh_ts"], _ = pcli.main(args + ["--iterations", str(START_ITERS),
                                            "--test_iterations", "100", "-m", pfresh],
                                    device="cpu")
    return out


def _load_json(d, name):
    with open(os.path.join(d, name)) as f:
        return json.load(f)


def test_resumed_history_matches(runs):
    d = runs["dirs"]
    jh, ph = _load_json(d["jres"], "history.json"), _load_json(d["pres"], "history.json")
    # the splice: the start run's entry, then the resumed run's
    assert [h["iter"] for h in jh] == [h["iter"] for h in ph] == [START_ITERS, END_ITERS]
    assert ph[0] == jh[0]  # carried over from the start run's history.json
    for a, b in zip(ph, jh):
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=1e-5, err_msg=f"iter {a['iter']}")
        for k in ("n_stat", "n_dyn", "max_per_tile", "tile_max"):
            assert a[k] == b[k], (a["iter"], k)
    assert [h["iter"] for h in runs["pres_hist"]] == [START_ITERS, END_ITERS]


def test_resumed_eval_curve_matches(runs):
    d = runs["dirs"]
    je, pe = _load_json(d["jres"], "eval_curve.json"), _load_json(d["pres"], "eval_curve.json")
    assert [e["iter"] for e in je] == [e["iter"] for e in pe] == [3, 6]
    for a, b in zip(pe, je):
        for k in ("test_psnr", "test_psnr_raw"):
            np.testing.assert_allclose(a[k], b[k], atol=1e-3, err_msg=f"{k} @ {a['iter']}")


def _npz(d, tag):
    with np.load(os.path.join(d, "point_cloud", f"iteration_{tag}",
                              "train_state.npz")) as z:
        return {k: z[k] for k in z.files}


def _moment_key(k):
    """The Adam first-moment key of a parameter leaf, or None."""
    pool, _, field = k.partition("/")
    if pool in ("stat", "dyn", "sandwich"):
        return f"{pool}_opt/mu/{field}"
    if k.startswith("blce/params/"):
        return f"blce_opt/mu/{k.rsplit('/', 1)[1]}"
    return None


def _lr(k, runs):
    """The largest learning rate of a parameter leaf over the resumed
    steps (``train/step.py``: the Gaussian fields' schedule, the decoder's
    rgb_lr, BLCE's 1e-4 decayed)."""
    opt = load_scene_config(runs["overlay"]).opt
    pool, _, field = k.partition("/")
    if pool in ("stat", "dyn"):
        extent = pL.scene_extent_from_cameras(runs["scene"].w2c)
        return float(getattr(poptim.gaussian_lrs(opt, START_ITERS + 1, extent), field))
    return opt.rgb_lr if pool == "sandwich" else 1e-4


def test_resumed_train_state_matches(runs):
    d = runs["dirs"]
    for tag in (END_ITERS, "best"):
        jz, pz = _npz(d["jres"], tag), _npz(d["pres"], tag)
        assert pz.keys() == jz.keys(), sorted(set(pz) ^ set(jz))
        assert any(k.startswith("deform/") for k in jz)
        for k in jz:
            a, b = pz[k], jz[k]
            assert a.dtype == b.dtype and a.shape == b.shape, k
            group = k.split("/")[0].replace("_opt", "").replace("_stats", "")
            if group == "deform" or a.dtype in (np.bool_, np.int32):
                np.testing.assert_array_equal(a, b, err_msg=k)
                continue
            mu = jz.get(_moment_key(k))
            if mu is not None:
                # parameters where their gradient is not tiny; over the resumed
                # steps a gradient may have been tiny at one step and rounded to
                # either sign there: a few elements within that step's ±lr
                keep = np.abs(mu) > 1e-3 * np.abs(mu).max()
                a, b = a[keep], b[keep]
                off = np.abs(a - b) > 1e-5 + 1e-5 * np.abs(b)
                assert off.sum() <= TRAP_SHARE * a.size, (k, int(off.sum()), a.size)
                trap = 2 * _lr(k, runs) * (END_ITERS - START_ITERS)
                assert np.all(np.abs(a - b)[off] <= trap), (k, np.abs(a - b)[off].max(), trap)
                continue
            tol = NPZ_TOL[group] * (2 if "/nu/" in k else 1)
            err = float(np.abs(a - b).max()) / max(float(np.abs(b).max()), 1e-30)
            assert err <= tol, (k, err)


def test_resumed_ply_and_blce_match(runs):
    """Each run's PLYs and ``blce.pth`` hold exactly its final state (the
    npz, whose cross-package parity the test above holds): the PLYs' rows
    are the live slots, read by the JAX package's loader, and the two
    ``blce.pth`` have one key layout."""
    d = runs["dirs"]
    ck = f"iteration_{END_ITERS}"
    layouts = []
    for side in ("jres", "pres"):
        z = _npz(d[side], END_ITERS)
        for name, pool in (("point_cloud.ply", "dyn"), ("point_cloud_static.ply", "stat")):
            path = os.path.join(d[side], "point_cloud", ck, name)
            assert list(jply.read_ply(path)) == pply.attribute_names()
            st = jply.load_gaussians(path)
            live = z[f"{pool}/live"]
            for f in st._fields:
                if f != "live":
                    np.testing.assert_array_equal(np.asarray(getattr(st, f)),
                                                  z[f"{pool}/{f}"][live], err_msg=f"{side} {f}")
        path = os.path.join(d[side], "point_cloud", ck, "blce.pth")
        sd = torch.load(path, weights_only=True)
        layouts.append({k: (tuple(v.shape), v.dtype) for k, v in sd.items()})
        b = pTC.load_blce_pth(path, device="cpu")
        for f, leaf in zip(BLCE_FIELDS, b.params.leaves()):
            np.testing.assert_array_equal(leaf.detach().numpy(), z[f"blce/params/{f}"],
                                          err_msg=f"{side} {f}")
        np.testing.assert_array_equal(b.exposure_expo.numpy(), z["blce/exposure_expo"])
    assert list(layouts[0].items()) == list(layouts[1].items())


def test_fresh_port_run_writes_the_jax_file_set(runs):
    d = runs["dirs"]
    assert _files(d["pfresh"]) == _files(d["jstart"])
    assert "fine_debug/iter_000001.png" in _files(d["pfresh"])
    assert _load_json(d["pfresh"], "cfg_args.json") == {
        **_load_json(d["jstart"], "cfg_args.json"), "expname": "default"}
    jz, pz = _npz(d["jstart"], START_ITERS), _npz(d["pfresh"], START_ITERS)
    assert pz.keys() == jz.keys()
    for k in jz:
        assert (pz[k].shape, pz[k].dtype) == (jz[k].shape, jz[k].dtype), k
    h = _load_json(d["pfresh"], "history.json")
    assert [e["iter"] for e in h] == [START_ITERS] and np.isfinite(h[0]["loss"])


@pytest.mark.parametrize("name", CKPT_FILES)
def test_jax_loads_the_ports_artifacts(runs, name):
    """Every artifact of the fresh port run, read by the JAX package."""
    d = os.path.join(runs["dirs"]["pfresh"], "point_cloud", f"iteration_{START_ITERS}")
    pts = runs["pfresh_ts"]
    path = os.path.join(d, name)
    if name.endswith(".ply"):
        pool = pts.dyn if name == "point_cloud.ply" else pts.stat
        st = jply.load_gaussians(path)
        live = pool.live.numpy()
        for f in ("xyz", "control_xyz", "features_rest", "opacity", "rotation"):
            np.testing.assert_array_equal(np.asarray(getattr(st, f)),
                                          getattr(pool, f).detach().numpy()[live], err_msg=f)
        np.testing.assert_array_equal(np.asarray(st.control_num), pool.control_num.numpy()[live])
    elif name == "point_cloud.pt":
        sw = jply.load_sandwich_pt(path)
        np.testing.assert_array_equal(np.asarray(sw.w1), pts.sandwich.w1.detach().numpy())
        np.testing.assert_array_equal(np.asarray(sw.w2), pts.sandwich.w2.detach().numpy())
    elif name == "blce.pth":
        b = jTC.load_blce_pth(path)
        for f, leaf in zip(b.params._fields, pts.blce.params.leaves()):
            np.testing.assert_array_equal(np.asarray(getattr(b.params, f)),
                                          leaf.detach().numpy(), err_msg=f)
        np.testing.assert_array_equal(np.asarray(b.exposure_expo),
                                      pts.blce.exposure_expo.numpy())
    elif name == "deformation.pth":
        hidden = load_scene_config(runs["overlay"]).hidden
        jhidden = JHidden(**{f: getattr(hidden, f) for f in JHidden.__dataclass_fields__})
        dp = jTC.load_deformation_pth(path, jhidden)
        got = jax.tree.leaves(dp)
        want = jax.tree.leaves(pts.deform)
        assert len(got) == len(want)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
    elif name in ("deformation_table.pth", "deformation_accum.pth"):
        x = torch.load(path, weights_only=True)
        n = int(pts.dyn.num_live())
        assert x.shape == ((n,) if "table" in name else (n, 3))
    else:
        tmpl = runs["jstart_ts"]
        loaded = jckpt.load_train_state(path, tmpl)
        got = {k: np.asarray(v) for k, v in jckpt._flatten_with_paths(loaded)[0].items()}
        want = pckpt.flatten_train_state(pts)
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_port_loads_the_jax_artifacts(runs):
    """The JAX start run's PLYs, decoder, blce.pth and deformation.pth
    through the port's loaders (its train_state.npz is what both resumed
    runs loaded)."""
    d = os.path.join(runs["dirs"]["jstart"], "point_cloud", f"iteration_{START_ITERS}")
    jts = runs["jstart_ts"]
    st = pply.load_gaussians(os.path.join(d, "point_cloud_static.ply"), device="cpu")
    live = np.asarray(jts.stat.live)
    np.testing.assert_array_equal(st.xyz.detach().numpy(), np.asarray(jts.stat.xyz)[live])
    sw = pply.load_sandwich_pt(os.path.join(d, "point_cloud.pt"), device="cpu")
    np.testing.assert_array_equal(sw.w1.detach().numpy(), np.asarray(jts.sandwich.w1))
    b = pTC.load_blce_pth(os.path.join(d, "blce.pth"), device="cpu")
    for f, leaf in zip(jts.blce.params._fields, b.params.leaves()):
        np.testing.assert_array_equal(leaf.detach().numpy(),
                                      np.asarray(getattr(jts.blce.params, f)), err_msg=f)
    hidden = load_scene_config(runs["overlay"]).hidden
    dp = pTC.load_deformation_pth(os.path.join(d, "deformation.pth"), hidden, device="cpu")
    for a, b in zip(jax.tree.leaves(jts.deform), jax.tree.leaves(dp)):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def test_port_cli_check_seed_and_viewer(tmp_path, monkeypatch):
    """The seed-sweep mode appends the best eval PSNR to ./seed.txt in the
    JAX CLI's format, and ``--port`` serves the SIBR bridge during the run
    and closes it after."""
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    overlay = tmp_path / "small.py"
    overlay.write_text(OVERLAY)
    monkeypatch.chdir(tmp_path)
    pcli.main(["--configs", str(overlay), *COMMON, "--iterations", "2",
               "--test_iterations", "1", "--check_seed", "--port", str(port),
               "-m", str(tmp_path / "out")], device="cpu")
    curve = _load_json(tmp_path / "out", "eval_curve.json")
    best = max(curve, key=lambda e: e["test_psnr"])
    assert (tmp_path / "seed.txt").read_text() == (
        f"seed 6666: best_psnr {best['test_psnr']:.4f} @ {best['iter']}\n")
    with socket.socket() as s:  # the listener was closed
        s.bind(("127.0.0.1", port))
