"""One-shot "bring your own point cloud" inference entry point
(counterpart of point_sam_tpu/evalsuite/inference.py).

Equivalent of the reference's evaluation/inference.py (the documented BYO
entry): load config + checkpoint, normalize a point cloud into the unit
sphere, run the eval click-simulation loop against provided ground-truth
masks, print per-click IoU. Input is a .ply (+ ``.masks.npy``) or an .npz
with coords/features/gt_masks arrays.

    python -m point_sam_tpu_torch.evalsuite.inference --input scene.npz \\
        [--ckpt_path model.safetensors] [--device cpu]
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from .eval_interactive import (
    InteractiveEvaluator,
    add_model_args,
    filter_masks,
    load_model,
    normalize_scene,
)


def run_inference(model, coords, features, gt_masks, num_clicks: int = 3, *, device=None):
    """Normalized inputs -> per-click IoUs [M, num_clicks]."""
    ev = InteractiveEvaluator(model, device=device, num_clicks=num_clicks)
    return ev.evaluate_scene(coords, features, gt_masks)


def main(argv=None):
    parser = argparse.ArgumentParser(prog="point_sam_tpu_torch.evalsuite.inference")
    add_model_args(parser)
    parser.add_argument("--input", required=True,
                        help=".ply (+.masks.npy) or .npz with coords/"
                             "features/gt_masks")
    parser.add_argument("--num_clicks", type=int, default=3)
    args = parser.parse_args(argv)

    model, device, _ = load_model(args)
    if args.input.endswith(".npz"):
        data = np.load(args.input)
        xyz, rgb, gt = data["coords"], data["features"], data["gt_masks"]
    else:
        from ..utils.ply import load_ply

        xyz, rgb = load_ply(args.input)
        gt = np.load(Path(args.input).with_suffix(".masks.npy"))

    gt = gt[filter_masks(gt)]
    xyz, rgb = normalize_scene(xyz, rgb)
    ious = run_inference(model, xyz, rgb, gt, num_clicks=args.num_clicks, device=device)
    for k in range(args.num_clicks):
        print(f"mean IoU @ click {k + 1}: {ious[:, k].mean():.4f}")
    return ious


if __name__ == "__main__":
    main()
