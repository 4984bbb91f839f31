"""PLY point-cloud IO (ascii + binary little-endian) and debug writers
(counterpart of point_sam_tpu/utils/ply.py, a numpy-only copy).

Own implementation covering both reference paths: the ascii loader/saver in
pc_sam/ply_utils.py:5-54 and the binary parser in
evaluation/eval_kitti.py:117-241, plus the prompt/mask visualization writers
(ply_utils.py:57-100). Uses numpy structured arrays for the binary path.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

_PLY_TO_NP = {
    "char": "i1", "int8": "i1",
    "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2",
    "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4",
    "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4",
    "double": "f8", "float64": "f8",
}


def load_ply(path: str | Path, *, extra_props: tuple[str, ...] = ()):
    """Load vertex positions (+ colors if present) from a PLY file.

    Returns (xyz [N,3] float32, rgb [N,3] uint8 or None); with
    ``extra_props`` also returns a dict of those per-vertex columns (missing
    names map to None) as a third element.
    """
    path = Path(path)
    with open(path, "rb") as f:
        header_lines = []
        while True:
            line = f.readline().decode("ascii", errors="replace").strip()
            header_lines.append(line)
            if line == "end_header":
                break
            if len(header_lines) > 1000:
                raise ValueError("malformed PLY header")
        fmt = None
        elements = []  # list of (name, count, [(prop_name, np_type)])
        cur = None
        for line in header_lines:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "format":
                fmt = parts[1]
            elif parts[0] == "element":
                cur = (parts[1], int(parts[2]), [])
                elements.append(cur)
            elif parts[0] == "property" and cur is not None:
                if parts[1] == "list":
                    cur[2].append((parts[-1], ("list", parts[2], parts[3])))
                else:
                    cur[2].append((parts[-1], _PLY_TO_NP[parts[1]]))

        if fmt is None:
            raise ValueError("PLY missing format line")

        vertex = next((e for e in elements if e[0] == "vertex"), None)
        if vertex is None:
            raise ValueError("PLY has no vertex element")
        if elements[0][0] != "vertex":
            raise NotImplementedError(
                "vertex must be the first element for this reader"
            )
        _, count, props = vertex
        if any(isinstance(t, tuple) for _, t in props):
            raise NotImplementedError("list properties on vertex unsupported")

        if fmt == "ascii":
            rows = []
            for _ in range(count):
                rows.append(f.readline().split())
            data = np.asarray(rows, dtype=np.float64)
            arr = {name: data[:, i] for i, (name, _) in enumerate(props)}
        elif fmt in ("binary_little_endian", "binary_big_endian"):
            endian = "<" if fmt == "binary_little_endian" else ">"
            dtype = np.dtype([(n, endian + t) for n, t in props])
            raw = f.read(dtype.itemsize * count)
            rec = np.frombuffer(raw, dtype=dtype, count=count)
            arr = {n: rec[n] for n, _ in props}
        else:
            raise ValueError(f"unknown PLY format {fmt}")

    xyz = np.stack(
        [arr["x"], arr["y"], arr["z"]], axis=1
    ).astype(np.float32)
    rgb = None
    for keys in (("red", "green", "blue"), ("R", "G", "B")):
        if all(k in arr for k in keys):
            rgb = np.stack([arr[k] for k in keys], axis=1)
            if rgb.dtype != np.uint8:
                rgb = np.clip(rgb, 0, 255).astype(np.uint8)
            break
    if extra_props:
        extras = {k: (np.asarray(arr[k]) if k in arr else None)
                  for k in extra_props}
        return xyz, rgb, extras
    return xyz, rgb


def save_ply(path: str | Path, xyz: np.ndarray, rgb: np.ndarray | None = None,
             *, binary: bool = True) -> None:
    """Write a point cloud as PLY (binary little-endian by default)."""
    xyz = np.asarray(xyz, np.float32)
    n = len(xyz)
    props = ["property float x", "property float y", "property float z"]
    if rgb is not None:
        rgb = np.clip(np.asarray(rgb), 0, 255).astype(np.uint8)
        props += [
            "property uchar red", "property uchar green", "property uchar blue"
        ]
    fmt = "binary_little_endian 1.0" if binary else "ascii 1.0"
    header = (
        "ply\n"
        f"format {fmt}\n"
        f"element vertex {n}\n" + "\n".join(props) + "\nend_header\n"
    )
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        if binary:
            fields = [("x", "<f4"), ("y", "<f4"), ("z", "<f4")]
            if rgb is not None:
                fields += [("red", "u1"), ("green", "u1"), ("blue", "u1")]
            rec = np.empty(n, dtype=np.dtype(fields))
            rec["x"], rec["y"], rec["z"] = xyz[:, 0], xyz[:, 1], xyz[:, 2]
            if rgb is not None:
                rec["red"], rec["green"], rec["blue"] = (
                    rgb[:, 0], rgb[:, 1], rgb[:, 2]
                )
            f.write(rec.tobytes())
        else:
            for i in range(n):
                row = f"{xyz[i,0]} {xyz[i,1]} {xyz[i,2]}"
                if rgb is not None:
                    row += f" {rgb[i,0]} {rgb[i,1]} {rgb[i,2]}"
                f.write((row + "\n").encode("ascii"))


def mask_colors(xyz, mask, rgb=None, color=(255, 0, 0),
                alpha=0.6) -> np.ndarray:
    """Per-point colors with mask points alpha-blended toward ``color``
    (the recoloring of reference ply_utils.py:57-100 / train.py:314-327,
    shared by the PLY writers and the wandb.Object3D panels)."""
    base = (np.full((len(xyz), 3), 128, np.float64)
            if rgb is None else np.asarray(rgb, np.float64))
    out = base.copy()
    out[np.asarray(mask, bool)] = (
        (1 - alpha) * base[np.asarray(mask, bool)] + alpha * np.asarray(color)
    )
    return out


def prompt_colors(xyz, prompt_coords, prompt_labels, rgb=None,
                  radius: float = 0.02) -> np.ndarray:
    """Per-point colors with points near each prompt painted green
    (positive) / red (negative)."""
    base = (np.full((len(xyz), 3), 128, np.float64)
            if rgb is None else np.asarray(rgb, np.float64))
    out = base.copy()
    for p, lab in zip(np.asarray(prompt_coords), np.asarray(prompt_labels)):
        d = np.linalg.norm(xyz - p, axis=1)
        out[d < radius] = (0, 255, 0) if lab else (255, 0, 0)
    return out


def visualize_mask(path, xyz, mask, rgb=None,
                   color=(255, 0, 0), alpha=0.6) -> None:
    """Write a cloud with mask points alpha-blended toward ``color``
    (debug writer in the spirit of reference ply_utils.py:57-100)."""
    save_ply(path, xyz, mask_colors(xyz, mask, rgb, color, alpha))


def visualize_prompts(path, xyz, prompt_coords, prompt_labels, rgb=None,
                      radius: float = 0.02) -> None:
    """Color points near each prompt green (positive) / red (negative)."""
    save_ply(path, xyz, prompt_colors(xyz, prompt_coords, prompt_labels,
                                      rgb, radius))
