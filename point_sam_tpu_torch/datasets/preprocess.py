"""Dataset preprocessing tools (the port's own copy of
point_sam_tpu/datasets/preprocess.py, numpy only).

Equivalents of the reference's pc_sam/datasets/preprocess/ scripts:
PartNet ins_seg h5 -> per-instance gt_mask scenes
(preprocess_partnet.py:78-119), the ScanObjectNN binary parse
(preprocess_scanobjectnn.py:31-58), the deterministic validation
(scene, mask) index (preprocess_mapping.py), and mesh surface sampling
for GLB / OBJ assets (preprocess_objaverse.py; needs trimesh).

h5py and trimesh are imported inside the functions that need them.
"""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np


def partnet_h5_to_masks(h5_path: str, out_path: str | None = None,
                        min_points: int = 1) -> dict:
    """Convert a PartNet ins_seg h5 (pts + per-point instance labels) to the
    framework schema: coords [N,3], features(rgb or ones), gt_masks [M,N].

    PartNet ins_seg files carry datasets ``pts`` [B, N, 3], optional
    ``rgb``, and either ``label``/``ins_label`` integer instance ids or a
    stacked ``gt_mask`` [B, M, N].
    """
    import h5py

    out = []
    with h5py.File(h5_path, "r") as f:
        pts = np.asarray(f["pts"])
        rgb = np.asarray(f["rgb"]) if "rgb" in f else None
        if "gt_mask" in f:
            masks_all = np.asarray(f["gt_mask"]).astype(bool)
            labels_all = None
        else:
            lab_key = "ins_label" if "ins_label" in f else "label"
            labels_all = np.asarray(f[lab_key])
            masks_all = None
    for b in range(len(pts)):
        if masks_all is not None:
            gm = masks_all[b]
        else:
            labels = labels_all[b]
            ids = np.unique(labels)
            ids = ids[ids >= 0]
            gm = np.stack([labels == i for i in ids]) if len(ids) else (
                np.zeros((0, len(labels)), bool))
        keep = gm.sum(1) >= min_points
        gm = gm[keep]
        out.append(
            dict(
                coords=pts[b].astype(np.float32),
                features=(rgb[b] if rgb is not None else
                          np.full_like(pts[b], 127.0)).astype(np.float32),
                gt_masks=gm,
            )
        )
    if out_path:
        np.savez_compressed(
            out_path,
            **{
                f"scene{i}_{k}": v
                for i, ex in enumerate(out)
                for k, v in ex.items()
            },
        )
    return {"num_scenes": len(out), "scenes": out}


def read_scanobjectnn_bin(path: str) -> dict:
    """Parse a ScanObjectNN ``*_indices.bin``-style object file: little-endian
    float32 records of [x, y, z, nx, ny, nz, r, g, b, instance, semantic]
    prefixed with an int32 point count (reference
    preprocess_scanobjectnn.py:31-58 layout)."""
    raw = Path(path).read_bytes()
    (n,) = struct.unpack_from("<i", raw, 0)
    rec = np.frombuffer(raw, dtype="<f4", count=n * 11, offset=4)
    rec = rec.reshape(n, 11)
    xyz = rec[:, :3].astype(np.float32)
    rgb = rec[:, 6:9].astype(np.float32)
    inst = rec[:, 9].astype(np.int64)
    ids = np.unique(inst)
    gt = np.stack([inst == i for i in ids]) if len(ids) else (
        np.zeros((0, n), bool))
    return dict(coords=xyz, features=rgb, gt_masks=gt)


def build_val_mapping(dataset, *, seed: int = 0,
                      out_path: str | None = None) -> np.ndarray:
    """Precompute a deterministic (scene_idx, mask_idx) flat index over a
    dataset so validation iterates one (cloud, mask) pair per row
    (reference preprocess_mapping.py / FuseDatasetVal semantics)."""
    rows = []
    for i in range(len(dataset)):
        ex = dataset[i]
        for m in range(len(ex["gt_masks"])):
            rows.append((i, m))
    mapping = np.asarray(rows, np.int64)
    if out_path:
        np.save(out_path, mapping)
    return mapping


def sample_mesh_surface(mesh_path: str, num_points: int, seed: int = 0):
    """Uniform surface sampling of a GLB/OBJ mesh (reference
    preprocess_objaverse.py uses trimesh; gated since trimesh is optional)."""
    try:
        import trimesh
    except ImportError as e:
        raise ImportError(
            "trimesh is required for mesh sampling; install it or convert "
            "meshes to PLY point clouds offline"
        ) from e
    mesh = trimesh.load(mesh_path, force="mesh")
    pts, face_idx = trimesh.sample.sample_surface(
        mesh, num_points, seed=seed
    )
    colors = None
    if mesh.visual is not None and hasattr(mesh.visual, "face_colors"):
        colors = np.asarray(mesh.visual.face_colors)[face_idx][:, :3]
    return np.asarray(pts, np.float32), colors
