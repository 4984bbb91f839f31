"""Convert KITTI-360 / AGILE3D evaluation crops to the evaluator layout
(counterpart of point_sam_tpu/evalsuite/prepare_kitti.py; numpy only).

The reference evaluates on per-object KITTI-360 crops: binary PLYs with
x/y/z, R/G/B and a per-vertex binary ``label`` marking the object, one
object per file named ``<category>_<id>.ply``, with a fixed coordinate
rotation xyz-euler(-90, 180, 0) degrees applied before normalization
(reference evaluation/eval_kitti.py:19,335-346,96-115).

This tool rewrites such crops into the layout
``point_sam_tpu_torch.evalsuite.eval_interactive`` consumes: a (rotated)
.ply plus a ``<name>.masks.npy`` bool array [M, N] sidecar. The category
is recoverable from the filename prefix (pass
``category_from_name=lambda n: n.split("_")[0]`` to evaluate_directory to
reproduce the reference's per-object means).

    python -m point_sam_tpu_torch.evalsuite.prepare_kitti --src_dir crops --out_dir scenes
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from ..datasets.transforms import _euler_matrix
from ..utils.ply import load_ply, save_ply

# Fixed KITTI-360 orientation fix (reference eval_kitti.py:19).
KITTI_ROTATION = _euler_matrix("xyz", np.array([-90.0, 180.0, 0.0]))


def _read_crop(path: Path):
    """Read a crop PLY including its per-vertex label column."""
    xyz, rgb, extras = load_ply(
        path, extra_props=("label", "instance", "scalar_label")
    )
    label = next((v for v in extras.values() if v is not None), None)
    return xyz, rgb, label


def prepare_crop(src: Path, out_dir: Path, *, rotate: bool = True) -> Path:
    xyz, rgb, label = _read_crop(src)
    if label is None:
        raise ValueError(f"{src}: no per-vertex label property")
    if rotate:
        xyz = (xyz @ KITTI_ROTATION.T).astype(np.float32)
    # One binary object mask per crop (reference transform_fn,
    # eval_kitti.py:96-115); files with multi-instance labels produce one
    # mask per positive id.
    ids = np.unique(label[label > 0])
    if len(ids) <= 1:
        masks = (label > 0)[None]
    else:
        masks = np.stack([label == i for i in ids])
    out_dir.mkdir(parents=True, exist_ok=True)
    out_ply = out_dir / src.name
    save_ply(out_ply, xyz,
             None if rgb is None else np.clip(rgb, 0, 255).astype(np.uint8))
    np.save(out_ply.with_suffix(".masks.npy"), masks.astype(bool))
    return out_ply


def main(argv=None):
    parser = argparse.ArgumentParser(prog="point_sam_tpu_torch.evalsuite.prepare_kitti")
    parser.add_argument("--src_dir", required=True,
                        help="directory (tree) of AGILE3D KITTI-360 crops")
    parser.add_argument("--out_dir", required=True)
    parser.add_argument("--no_rotate", action="store_true")
    args = parser.parse_args(argv)

    crops = sorted(Path(args.src_dir).rglob("*.ply"))
    ok = 0
    for crop in crops:
        try:
            prepare_crop(crop, Path(args.out_dir), rotate=not args.no_rotate)
            ok += 1
        except (OSError, ValueError, NotImplementedError, KeyError) as e:
            print(f"skip {crop}: {e}")
    print(f"converted {ok}/{len(crops)} crops -> {args.out_dir}")


if __name__ == "__main__":
    main()
