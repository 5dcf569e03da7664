"""Evaluation CLI — test-time pose optimization + refined renders (port of
``mobgs_tpu/cli/eval_cli.py`` with its flags, defaults and files).

  python -m mobgs_tpu_torch.cli.eval_cli -s data/stereo/seesaw/dense \\
      -m output/seesaw --iteration best

Reference ``eval.py``: load a checkpoint, freeze the scene, optimize each
test camera's pose against −PSNR, write ``test_refined/img_%05d.png.png``
(the reference's double suffix) and ``solved_poses.npy``; plus
``test_gt/%05d.png`` (the ground truth, so ``metrics_cli`` runs without
``-s``), the mean PSNR and the pose ATE / RPE after a Sim(3) alignment.
It runs on the card (``main(device="cpu")`` runs it on the CPU, as the
tests do); on the card TTO's renders run the CE=11 forward kernel and its
pose gradient the CE=11 backward kernel.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from mobgs_tpu_torch import resolve_device


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="mobgs_tpu_torch eval (TTO)")
    p.add_argument("-m", "--model_path", type=str, required=True)
    p.add_argument("-s", "--source_path", type=str, default="")
    p.add_argument("--iteration", type=str, default="best")
    # shipped reference protocol (eval.py:258-263): 100 steps, decay 30,
    # lr 3e-4 -> 1e-6, no previous-camera init
    p.add_argument("--tto_steps", type=int, default=100)
    p.add_argument("--tto_decay_start", type=int, default=30)
    p.add_argument("--tto_lr", type=float, default=3e-4)
    p.add_argument("--tto_lr_final", type=float, default=1e-6)
    p.add_argument("--fast", action="store_true",
                   help="cheap TTO (25 steps, lr 3e-3; the reference "
                        "function-default setting, not the shipped one)")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--synthetic_size", type=str, default="128x72x12")
    return p


def _load_blce(ck: str, dev: torch.device):
    """The checkpoint's BLCE state: ``blce.pth``, else the legacy
    ``blce.npz``, else None."""
    if os.path.exists(os.path.join(ck, "blce.pth")):
        from mobgs_tpu_torch.io.torch_ckpt import load_blce_pth
        return load_blce_pth(os.path.join(ck, "blce.pth"), device=dev)
    if os.path.exists(os.path.join(ck, "blce.npz")):  # legacy format
        from mobgs_tpu_torch.models.blce import BLCE_FIELDS, BLCEParams, BLCEState
        with np.load(os.path.join(ck, "blce.npz")) as z:
            params = BLCEParams(**{f: torch.as_tensor(z[f]) for f in BLCE_FIELDS})
            return BLCEState(params, torch.as_tensor(z["exposure_expo"])).to(dev)
    return None


def main(argv=None, device=None):
    """Run the CLI with ``argv`` (``sys.argv[1:]`` when None) on ``device``
    (the card unless ``"cpu"``). Returns the TTO result."""
    args = _parser().parse_args(argv)
    dev = resolve_device(device)

    from mobgs_tpu_torch.data import synthetic
    from mobgs_tpu_torch.data.scene import checkpoint_dir, find_latest_iteration
    from mobgs_tpu_torch.eval.tto import make_tto
    from mobgs_tpu_torch.io.ply import load_gaussians, load_sandwich_pt

    if args.synthetic:
        W, H, F = map(int, args.synthetic_size.split("x"))
        data, _ = synthetic.generate(width=W, height=H, num_frames=F, device=dev)
    else:
        from mobgs_tpu_torch.data.stereo import load_stereo_scene
        data = load_stereo_scene(args.source_path).data

    ck = checkpoint_dir(args.model_path, args.iteration)
    if not os.path.isdir(ck):
        # no best-PSNR checkpoint (e.g. trained with test eval off) —
        # fall back to the latest numbered iteration
        latest = find_latest_iteration(args.model_path)
        if latest is None:
            raise FileNotFoundError(f"no checkpoints under "
                                    f"{args.model_path}/point_cloud")
        print(f"iteration_{args.iteration} not found; using "
              f"iteration_{latest}")
        ck = checkpoint_dir(args.model_path, latest)
    dyn = load_gaussians(os.path.join(ck, "point_cloud.ply"), device=dev)
    stat = load_gaussians(os.path.join(ck, "point_cloud_static.ply"), device=dev)
    sandwich = load_sandwich_pt(os.path.join(ck, "point_cloud.pt"), device=dev)

    def on(x):
        return torch.as_tensor(np.asarray(x), dtype=torch.float32, device=dev)

    # align test poses through the BLCE-refined train poses
    # (reference train.py:746-764) when a BLCE checkpoint is present
    test_w2c = on(data.test_w2c)
    blce_state = _load_blce(ck, dev)
    if blce_state is not None:
        from mobgs_tpu_torch.eval.align import align_test_poses
        test_w2c = align_test_poses(blce_state, on(data.w2c), test_w2c,
                                    on(data.blur_feats))
        print("aligned test poses through BLCE mid-exposure cameras")

    if args.fast:
        steps, decay, lr, lr_final = 25, 15, 3e-3, 1e-4
    else:
        steps, decay = args.tto_steps, args.tto_decay_start
        lr, lr_final = args.tto_lr, args.tto_lr_final
    tto = make_tto(stat, dyn, sandwich, data.width, data.height,
                   data.max_time, steps=steps, decay_start=decay,
                   lr_q=lr, lr_p=lr, lr_final=lr_final)
    V = data.test_w2c.shape[0]
    # shipped call: initialize_from_previous_camera=False => every
    # camera optimizes with lr factor 1.0 (eval.py:62-68,269-271)
    lr_scale = torch.ones(V, device=dev)
    # test-split intrinsics/times when the loader provides them (the same
    # fallback as cli/train.py's in-training eval)
    t_K = data.test_K if data.test_K is not None else data.K
    t_t = data.test_time if data.test_time is not None else data.time
    res = tto(test_w2c, on(t_K), on(t_t), on(data.test_images), lr_scale)

    out = os.path.join(args.model_path, "test_refined")
    os.makedirs(out, exist_ok=True)
    from PIL import Image
    renders = res.renders.cpu().numpy()
    for i in range(V):
        Image.fromarray((np.clip(renders[i], 0, 1) * 255).astype(np.uint8)
                        ).save(os.path.join(out, f"img_{i:05d}.png.png"))
    solved = res.w2c.cpu().numpy()
    np.save(os.path.join(args.model_path, "solved_poses.npy"), solved)
    # stage GT next to the renders so metrics_cli works without -s
    # (the synthetic protocol has no inference_images/ dir; reference
    # metrics.py reads GT from the scene's source path)
    gt_dir = os.path.join(args.model_path, "test_gt")
    os.makedirs(gt_dir, exist_ok=True)
    gt_images = np.asarray(data.test_images)
    for i in range(V):
        Image.fromarray((np.clip(gt_images[i], 0, 1) * 255).astype(np.uint8)
                        ).save(os.path.join(gt_dir, f"{i:05d}.png"))
    print(f"TTO done: mean PSNR {float(np.mean(res.psnr.cpu().numpy())):.2f}; "
          f"renders in {out}")

    # pose-accuracy report (utils_poses ATE/RPE, SplineGS-style)
    from mobgs_tpu_torch.eval.pose_metrics import evaluate_poses
    gt_c2w = np.linalg.inv(np.asarray(data.test_w2c))
    solved_c2w = np.linalg.inv(solved)
    pm = evaluate_poses(gt_c2w, solved_c2w, align="sim3")
    print(f"pose ATE {pm['ate']:.4f}  RPE-t {pm['rpe_trans']:.4f}  "
          f"RPE-r {pm['rpe_rot_deg']:.3f}°")
    return res


if __name__ == "__main__":
    main()
