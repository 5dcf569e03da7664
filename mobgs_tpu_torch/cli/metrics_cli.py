"""Metrics CLI — PSNR/SSIM/LPIPS/tOF over refined renders (port of
``mobgs_tpu/cli/metrics_cli.py`` with its flags and files).

  python -m mobgs_tpu_torch.cli.metrics_cli -s data/stereo/seesaw/dense \\
      -m output/seesaw

Reference ``metrics.py:81-162``: reads ``test_refined/img_%05d.png.png``
against ``<source>/inference_images/%05d.png`` (or ``test_gt/`` without
``-s``), prints the frame means and writes ``results.json``. LPIPS uses
the lin weights and the AlexNet backbone found on local paths
(``eval/lpips.py``: ``MOBGS_LPIPS_WEIGHTS``, ``MOBGS_ALEXNET_WEIGHTS``);
without a backbone it is reported as ``lpips_randfeat``. It runs on the
card (``main(device="cpu")`` runs it on the CPU).
"""

from __future__ import annotations

import argparse
import glob
import json
import os

import numpy as np

from mobgs_tpu_torch import resolve_device


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="mobgs_tpu_torch metrics")
    p.add_argument("-m", "--model_path", type=str, required=True)
    p.add_argument("-s", "--source_path", type=str, default="",
                   help="scene dir with inference_images/ (GT)")
    p.add_argument("--lpips_weights", type=str, default="",
                   help="LPIPS v0.1 alex.pth lin weights")
    p.add_argument("--alexnet_weights", type=str, default="",
                   help="torchvision alexnet state_dict (optional)")
    p.add_argument("--no_tof", action="store_true")
    return p


def main(argv=None, device=None):
    """Run the CLI with ``argv`` (``sys.argv[1:]`` when None) on ``device``
    (the card unless ``"cpu"``). Returns the metrics dict."""
    args = _parser().parse_args(argv)
    dev = resolve_device(device)

    from PIL import Image
    pred_dir = os.path.join(args.model_path, "test_refined")
    pred_paths = sorted(glob.glob(os.path.join(pred_dir, "img_*.png*")))
    # GT: the scene's inference_images/ when -s is given (reference
    # metrics.py:81-162), else the test_gt/ staging dir eval_cli writes
    gt_dir = (os.path.join(args.source_path, "inference_images")
              if args.source_path
              else os.path.join(args.model_path, "test_gt"))
    preds, gts = [], []
    for i, pp in enumerate(pred_paths):
        pred = np.asarray(Image.open(pp))[..., :3] / 255.0
        gp = os.path.join(gt_dir, f"{i:05d}.png")
        if not os.path.exists(gp):
            continue
        gt = np.asarray(Image.open(gp))[..., :3] / 255.0
        if gt.shape != pred.shape:
            gt = np.asarray(Image.fromarray(
                (gt * 255).astype(np.uint8)).resize(
                    (pred.shape[1], pred.shape[0]))) / 255.0
        preds.append(pred.astype(np.float32))
        gts.append(gt.astype(np.float32))
    if not preds:
        raise SystemExit(f"no aligned (pred, gt) pairs under {pred_dir}")

    from mobgs_tpu_torch.eval.lpips import (find_default_backbone,
                                            find_default_lpips_weights, load_lpips)
    from mobgs_tpu_torch.eval.metrics import evaluate_sequence
    lin = args.lpips_weights or find_default_lpips_weights(args.model_path)
    backbone = args.alexnet_weights or find_default_backbone(args.model_path)
    if lin:
        print(f"# LPIPS lin weights: {lin}")
    if not backbone:
        print("# LPIPS backbone: fixed-seed random (no torchvision "
              "alexnet weights found; set MOBGS_ALEXNET_WEIGHTS for "
              "published-comparable LPIPS)")
    lp = load_lpips(lin, backbone, device=dev)
    out = evaluate_sequence(np.stack(preds), np.stack(gts), lpips_params=lp,
                            compute_tof=not args.no_tof, device=dev)
    print(f"PSNR: {out['psnr']:.4f}")
    print(f"SSIM: {out['ssim']:.4f}")
    for k in ("lpips", "lpips_randfeat"):
        if k in out:
            print(f"{k.upper()}: {out[k]:.4f}")
    if out.get("tof") is not None:
        print(f"tOF: {out['tof']:.4f}")
    # persist the report next to the checkpoint (the reference saves its
    # per-scene results to JSON too, metrics.py:150-162)
    report = {k: (float(v) if isinstance(v, (int, float)) else v)
              for k, v in out.items()}
    report["n_frames"] = len(preds)
    with open(os.path.join(args.model_path, "results.json"), "w") as f:
        json.dump(report, f, indent=1)
    return out


if __name__ == "__main__":
    main()
