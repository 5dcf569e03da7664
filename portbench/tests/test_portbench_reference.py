"""The reference against the program's plain route (CPU tensors) on a tiny
scene: a whole train step, flow off and on, and a viewer image."""

import dataclasses

import numpy as np
import pytest
import torch

from harness import compare, refmodel as R, scene as S, state as ST


@pytest.fixture(scope="module")
def world():
    dev = torch.device("cpu")
    W, H, F = 64, 48, 6
    scene, traj = S.generate(W, H, F, seed=123, device=dev)
    clouds = S.init_point_clouds(scene, traj, 400, 120, seed=123)
    P = ST.initial_params(scene, clouds, (800, 240), F, 32, 9, 123, dev)
    return scene, P


@pytest.mark.parametrize("flow", [0.0, 0.01])
def test_train_step_matches_the_plain_route(world, flow):
    from mobgs_tpu_torch.config import OptimizationParams
    from mobgs_tpu_torch.ops.rasterize import RasterConfig
    from mobgs_tpu_torch.train.step import Batch, make_train_step
    from conftest import load
    scene, P = world
    W, H = scene["width"], scene["height"]
    opt = OptimizationParams(**{**load("portbench/configs/seesaw.json")["OptimizationParams"],
                                "lambda_flow_loss": flow})
    extent = S.extent_from_cameras(scene["w2c"])
    step = make_train_step(opt, W, H, scene["max_time"], 9,
                           RasterConfig(tiles_per_gauss=64, max_per_tile=512),
                           spatial_lr_scale=extent)
    ids = np.array([2, 4])

    def on(x, dt=torch.float32):
        return torch.as_tensor(np.asarray(x), dtype=dt)
    b = dict(view=on(ids, torch.int64), w2c=on(scene["w2c"][ids]), K=on(scene["K"][ids]),
             time=on(scene["time"][ids]), image=on(scene["images"][ids]),
             depth=on(scene["depths"][ids]), blur=on(scene["blur_feats"][ids]))
    ts, m = step(ST.to_program(P, 0), Batch(b["view"], b["w2c"], b["K"], b["time"], b["image"],
                                            b["depth"], b["blur"]))
    names, params, mus = ST.program_leaves(ts)
    Pr = ST.copy_params(P, "cpu")
    cfg = dict(width=W, height=H, num_warp=9, max_time=scene["max_time"], lambda_flow_loss=flow,
               lambda_dssim=0.2, opt=dataclasses.asdict(opt), extent=extent)
    loss, grads = R.train_step(Pr, dict(t=0, m={}, v={}), b, cfg, (64, 512), 1)
    p0 = dict(R.leaves(P))
    prog = dict(losses=[float(m.loss)] * 3, grad=compare.norms({n: u / 0.1 for n, u in zip(names, mus)}),
                change=compare.norms({n: x.detach() - p0[n] for n, x in zip(names, params)}))
    ref = dict(losses=[loss] * 3, grad=compare.norms(grads),
               change=compare.norms({n: x - p0[n] for n, x in R.leaves(Pr)}))
    got = compare.train_numbers(prog, ref)
    assert got["loss_gap"] < 1e-6 and got["grad_gap"] < 1e-5 and got["change_gap"] < 1e-5, got


def test_viewer_image_matches_the_plain_route(world):
    from mobgs_tpu_torch.ops.rasterize import RasterConfig
    from mobgs_tpu_torch.viewer import make_viewer_render
    scene, P = world
    W, H = scene["width"], scene["height"]
    ts = ST.to_program(P, 0)
    render = make_viewer_render(ts.stat, ts.dyn, ts.sandwich, scene["K"][0], W, H,
                                scene["max_time"], config=RasterConfig(tiles_per_gauss=64,
                                                                       max_per_tile=512))
    w2c = scene["w2c"][3]
    img = render({"resolution_x": W, "resolution_y": H, "_w2c": w2c})
    ref = R.view_render(P, torch.as_tensor(w2c), torch.as_tensor(scene["K"][0]), W, H,
                        scene["max_time"], (64, 512)).numpy()
    assert compare.image_gap([img], [ref]) < 1e-6
