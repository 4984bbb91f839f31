"""Generate demo point-cloud assets: synthetic stand-ins for the
reference's bundled demo PLYs, each with a ``.masks.npy`` sidecar of its
parts, the layout the demo server and the evaluator read (counterpart of
point_sam_tpu/serving/make_assets.py).

    python -m point_sam_tpu_torch.serving.make_assets --out demo_models

then point the demo server's ``--model_dir`` (or the evaluator's
``--scene_dir``) at it.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np


def main(argv=None):
    parser = argparse.ArgumentParser(prog="point_sam_tpu_torch.serving.make_assets")
    parser.add_argument("--out", default="demo_models")
    parser.add_argument("--num", type=int, default=3)
    parser.add_argument("--points", type=int, default=20000)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)

    from ..datasets.synthetic import generate_scene
    from ..utils.ply import save_ply

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    for i in range(args.num):
        ex = generate_scene(args.seed * 100 + i, num_points=args.points)
        name = out / f"object{i}.ply"
        save_ply(name, ex["coords"].astype(np.float32),
                 np.clip(ex["features"], 0, 255).astype(np.uint8))
        np.save(name.with_suffix(".masks.npy"), ex["gt_masks"])
        print(f"wrote {name} ({args.points} pts, "
              f"{len(ex['gt_masks'])} instances)")


if __name__ == "__main__":
    main()
