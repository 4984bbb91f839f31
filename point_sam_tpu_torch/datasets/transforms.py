"""NumPy data transforms (host-side preprocessing; the port's own copy of
point_sam_tpu/datasets/transforms.py, numpy only).

Same transform semantics as the reference's HF-`set_transform` chain
(reference: pc_sam/datasets/transforms.py), reimplemented as pure NumPy
per-example callables composed by ``Compose``. Key behavioral contracts
preserved:

- ``NormalizePoints``: center at centroid, scale into the unit sphere
  (reference :56-68).
- ``NormalizeColor``: /255, -mean, /std (reference :71-83).
- ``RandomSample``: subsample to N points; if no foreground point of any
  mask survives, resample with a guaranteed foreground fraction; empty
  masks are replaced by the first non-empty one (reference :86-118).
- ``RandomSampleMask``: choose M masks, padding by resampling when fewer
  exist (reference :160-179).
- rotations/scale match the reference's scipy-based augmentations
  (reference :182-217).

Output example dict: coords [N,3] float32, features [N,C] float32,
gt_masks [M,N] bool — the fixed-shape device batch contract.

Randomness: each random transform draws from ``ex["_rng"]`` when the loader
injects one (a per-example ``np.random.Generator`` seeded from
``SeedSequence([seed, epoch, index])`` — the thread-safe, schedule-
independent equivalent of the reference's 128-bit per-worker seeding,
pc_sam/utils/torch_utils.py:8-25), falling back to the generator bound at
construction for direct single-threaded use.
"""

from __future__ import annotations

import inspect
from typing import Callable, Dict, List

import numpy as np

Example = Dict[str, np.ndarray]


class Compose:
    def __init__(self, transforms: List[Callable[[Example], Example]]):
        self.transforms = list(transforms)

    def __call__(self, example: Example) -> Example:
        for t in self.transforms:
            example = t(example)
        return example

    def __repr__(self):
        inner = "\n".join(f"    {t}" for t in self.transforms)
        return f"{type(self).__name__}(\n{inner}\n)"


def normalize_points(points: np.ndarray) -> np.ndarray:
    """Center + scale into the unit sphere (reference :56-62)."""
    assert points.ndim == 2 and points.shape[1] == 3, points.shape
    centered = points - points.mean(axis=0)
    norm = np.max(np.linalg.norm(centered, axis=1))
    return centered / max(norm, 1e-12)


class NormalizePoints:
    def __call__(self, ex: Example) -> Example:
        ex["coords"] = normalize_points(np.asarray(ex["coords"], np.float64))
        return ex


class NormalizeColor:
    def __init__(self, mean=None, std=None):
        self.mean, self.std = mean, std

    def __call__(self, ex: Example) -> Example:
        f = np.asarray(ex["features"], np.float64) / 255.0
        if self.mean is not None:
            f = f - self.mean
        if self.std is not None:
            f = f / self.std
        ex["features"] = f
        return ex


class RandomSample:
    """Subsample with foreground guarantee (reference :86-118)."""

    def __init__(self, num_samples: int, replace: bool = False, rng=None):
        self.num_samples = num_samples
        self.replace = replace
        self.rng = rng or np.random.default_rng()

    def __call__(self, ex: Example) -> Example:
        rng = ex.get("_rng") or self.rng
        coords = np.asarray(ex["coords"])
        gt = np.asarray(ex["gt_masks"])  # [M, N]
        n = len(coords)
        replace = self.replace or n < self.num_samples
        idx = rng.choice(n, self.num_samples, replace=replace)
        if not (gt[:, idx] == 1).any():
            fg = np.nonzero((gt == 1).any(axis=0))[0]
            bg = np.nonzero((gt == 0).all(axis=0))[0]
            n_fg = int(np.ceil(self.num_samples / n * len(fg)))
            n_fg = min(n_fg, len(fg), self.num_samples)
            fg_idx = rng.choice(fg, n_fg)
            bg_idx = rng.choice(bg, self.num_samples - n_fg)
            idx = rng.permutation(np.concatenate([fg_idx, bg_idx]))
        ex["coords"] = coords[idx]
        ex["features"] = np.asarray(ex["features"])[idx]
        gt = gt[:, idx]
        empty = (gt == 0).all(axis=1)
        if empty.any():
            if empty.all():
                raise ValueError("all masks empty after subsampling")
            gt[empty] = gt[~empty][0]
        ex["gt_masks"] = gt
        return ex


class SamplePoints:
    """Deterministic subsample with a fixed index table (reference :120-147).
    Out-of-range indices clamp to 0, matching the reference's behavior."""

    _cache: dict[tuple[int, int], np.ndarray] = {}

    def __init__(self, num_samples: int, table_size: int = 32768, seed: int = 0):
        key = (table_size, num_samples)
        if key not in self._cache:
            self._cache[key] = np.random.default_rng(seed).choice(
                table_size, num_samples, replace=False
            )
        self.indices = self._cache[key]

    def __call__(self, ex: Example) -> Example:
        coords = np.asarray(ex["coords"])
        gt = np.asarray(ex["gt_masks"])
        idx = self.indices.copy()
        idx[idx >= len(coords)] = 0
        ex["coords"] = coords[idx]
        ex["features"] = np.asarray(ex["features"])[idx]
        gt = gt[:, idx]
        empty = (gt == 0).all(axis=1)
        if empty.any():
            assert not empty.all(), "all masks empty after subsampling"
            gt[empty] = gt[~empty][0]
        ex["gt_masks"] = gt
        return ex


class SampleSingleMask:
    """(reference :149-158)."""

    def __init__(self, mask_id: int):
        self.mask_id = mask_id

    def __call__(self, ex: Example) -> Example:
        ex["gt_masks"] = np.asarray(ex["gt_masks"])[self.mask_id : self.mask_id + 1]
        return ex


class RandomSampleMask:
    """Pick a fixed number of masks, padding by resampling (reference :160-179)."""

    def __init__(self, num_samples: int, rng=None):
        self.num_samples = num_samples
        self.rng = rng or np.random.default_rng()

    def __call__(self, ex: Example) -> Example:
        rng = ex.get("_rng") or self.rng
        gt = np.asarray(ex["gt_masks"])
        m = len(gt)
        if m < self.num_samples:
            extra = rng.choice(m, self.num_samples - m, replace=True)
            sel = np.concatenate([np.arange(m), extra])
        elif m > self.num_samples:
            sel = rng.choice(m, self.num_samples, replace=False)
        else:
            sel = np.arange(m)
        ex["gt_masks"] = gt[sel]
        return ex


def _euler_matrix(order: str, angles_deg: np.ndarray) -> np.ndarray:
    """Rotation matrix from euler angles (replaces scipy.spatial.transform).

    Upper-case order = intrinsic, lower-case = extrinsic, matching scipy's
    convention used by the reference (transforms.py:188,204)."""
    mats = {
        "x": lambda a: np.array(
            [[1, 0, 0], [0, np.cos(a), -np.sin(a)], [0, np.sin(a), np.cos(a)]]
        ),
        "y": lambda a: np.array(
            [[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]]
        ),
        "z": lambda a: np.array(
            [[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0], [0, 0, 1]]
        ),
    }
    rads = np.deg2rad(np.atleast_1d(angles_deg).astype(np.float64))
    axes = list(order.lower())
    intrinsic = order.isupper()
    R = np.eye(3)
    for ax, a in zip(axes, rads):
        R = R @ mats[ax](a) if intrinsic else mats[ax](a) @ R
    return R


class RandomRotateAlongAxis:
    """Full-turn rotation about one axis (reference :182-190, default y)."""

    def __init__(self, axis: str = "y", rng=None):
        assert axis in ("x", "y", "z")
        self.axis = axis
        self.rng = rng or np.random.default_rng()

    def __call__(self, ex: Example) -> Example:
        rng = ex.get("_rng") or self.rng
        R = _euler_matrix(self.axis, rng.uniform(-180, 180))
        ex["coords"] = np.asarray(ex["coords"]) @ R.T
        return ex


class RandomRotatePerturb:
    """Small gaussian XYZ euler perturbation (reference :193-206)."""

    def __init__(self, angle_sigma: float = 0.06, angle_clip: float = 0.18,
                 rng=None):
        self.angle_sigma = angle_sigma
        self.angle_clip = angle_clip
        self.rng = rng or np.random.default_rng()

    def __call__(self, ex: Example) -> Example:
        rng = ex.get("_rng") or self.rng
        angles = np.clip(
            rng.normal(0, self.angle_sigma, 3),
            -self.angle_clip, self.angle_clip,
        )
        R = _euler_matrix("XYZ", np.rad2deg(angles))
        ex["coords"] = np.asarray(ex["coords"]) @ R.T
        return ex


class RandomScale:
    def __init__(self, low: float, high: float, rng=None):
        self.low, self.high = low, high
        self.rng = rng or np.random.default_rng()

    def __call__(self, ex: Example) -> Example:
        rng = ex.get("_rng") or self.rng
        ex["coords"] = np.asarray(ex["coords"]) * rng.uniform(
            self.low, self.high
        )
        return ex


class ToArrays:
    """Final dtype fix-up (the reference's ToTensor, :47-53)."""

    def __call__(self, ex: Example) -> Example:
        ex["coords"] = np.asarray(ex["coords"], np.float32)
        ex["features"] = np.asarray(ex["features"], np.float32)
        ex["gt_masks"] = np.asarray(ex["gt_masks"], bool)
        return ex


_TRANSFORM_REGISTRY = {
    "normalize_points": NormalizePoints,
    "normalize_color": NormalizeColor,
    "random_sample": RandomSample,
    "sample_points": SamplePoints,
    "sample_single_mask": SampleSingleMask,
    "random_sample_mask": RandomSampleMask,
    "random_rotate_along_axis": RandomRotateAlongAxis,
    "random_rotate_perturb": RandomRotatePerturb,
    "random_scale": RandomScale,
    "to_arrays": ToArrays,
}


def build_transforms(specs: list[dict], rng=None) -> Compose:
    """Build a Compose from config dicts [{name: ..., **kwargs}]
    (configs/dataset/*.yaml). A shared numpy Generator is threaded through
    all random transforms for reproducibility."""
    rng = rng or np.random.default_rng()
    ts = []
    for spec in specs:
        spec = dict(spec)
        name = spec.pop("name")
        cls = _TRANSFORM_REGISTRY[name]
        if "rng" in inspect.signature(cls).parameters:
            spec["rng"] = rng
        ts.append(cls(**spec))
    ts.append(ToArrays())
    return Compose(ts)
