"""Procedural synthetic dataset: multi-part shapes with instance masks
(the port's own copy of point_sam_tpu/datasets/synthetic.py, numpy only).

An offline, deterministic stand-in for the HF hub datasets the reference
trains on, with the same example schema: coords [N,3], features (rgb)
[N,3] in 0..255, gt_masks [M,N] bool. The same seed gives the same scenes
as the JAX package.

Scenes are unions of K random primitive parts (boxes, spheres, cylinders)
with per-part colors + noise; each part is one ground-truth instance mask.
"""

from __future__ import annotations

import numpy as np


def _sample_box(rng, n):
    size = rng.uniform(0.2, 1.0, 3)
    face = rng.integers(0, 6, n)
    u, v = rng.uniform(-0.5, 0.5, (2, n))
    pts = np.empty((n, 3))
    axis = face // 2
    sign = (face % 2) * 2.0 - 1.0
    for i, (a, s) in enumerate(zip(axis, sign)):
        rest = [j for j in range(3) if j != a]
        pts[i, a] = 0.5 * s
        pts[i, rest[0]] = u[i]
        pts[i, rest[1]] = v[i]
    return pts * size


def _sample_sphere(rng, n):
    v = rng.standard_normal((n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True) + 1e-12
    return v * rng.uniform(0.15, 0.5)


def _sample_cylinder(rng, n):
    r = rng.uniform(0.1, 0.4)
    h = rng.uniform(0.3, 1.0)
    theta = rng.uniform(0, 2 * np.pi, n)
    z = rng.uniform(-0.5, 0.5, n) * h
    return np.stack([r * np.cos(theta), r * np.sin(theta), z], axis=1)


_PRIMS = [_sample_box, _sample_sphere, _sample_cylinder]


def generate_scene(
    seed: int,
    num_points: int = 32768,
    num_parts: tuple[int, int] = (3, 8),
    noise: float = 0.005,
) -> dict:
    """One synthetic example (deterministic in seed)."""
    rng = np.random.default_rng(seed)
    k = int(rng.integers(num_parts[0], num_parts[1] + 1))
    weights = rng.dirichlet(np.ones(k) * 2.0)
    counts = np.maximum((weights * num_points).astype(int), 16)
    counts[-1] = num_points - counts[:-1].sum()
    if counts[-1] < 16:  # rebalance tiny remainder
        counts = np.full(k, num_points // k)
        counts[-1] += num_points - counts.sum()

    pts_list, part_ids, colors = [], [], []
    for p in range(k):
        prim = _PRIMS[int(rng.integers(len(_PRIMS)))]
        pts = prim(rng, int(counts[p]))
        # random rotation + offset per part
        q = rng.standard_normal((3, 3))
        qmat, _ = np.linalg.qr(q)
        pts = pts @ qmat.T + rng.uniform(-1, 1, 3)
        pts_list.append(pts)
        part_ids.append(np.full(len(pts), p))
        base = rng.uniform(30, 225, 3)
        colors.append(
            np.clip(base + rng.normal(0, 10, (len(pts), 3)), 0, 255)
        )

    coords = np.concatenate(pts_list).astype(np.float64)
    coords += rng.normal(0, noise, coords.shape)
    ids = np.concatenate(part_ids)
    rgb = np.concatenate(colors)

    perm = rng.permutation(len(coords))
    coords, ids, rgb = coords[perm], ids[perm], rgb[perm]
    gt_masks = np.stack([ids == p for p in range(k)])
    return dict(coords=coords, features=rgb, gt_masks=gt_masks)


class SyntheticDataset:
    """Map-style dataset of procedural scenes (schema-compatible with the
    HF-hub datasets the reference trains on)."""

    def __init__(self, num_scenes: int = 512, points_per_scene: int = 32768,
                 seed: int = 0, transform=None):
        self.num_scenes = num_scenes
        self.points_per_scene = points_per_scene
        self.seed = seed
        self.transform = transform

    def __len__(self):
        return self.num_scenes

    def __getitem__(self, i: int) -> dict:
        return self.get(i)

    def get(self, i: int, rng=None) -> dict:
        """Fetch + transform; ``rng`` (injected by the parallel loader)
        seeds the random transforms via the ``_rng`` example key."""
        if not 0 <= i < self.num_scenes:
            raise IndexError(i)
        ex = generate_scene(self.seed * 1_000_003 + i, self.points_per_scene)
        if self.transform is not None:
            if rng is not None:
                ex["_rng"] = rng
            ex = self.transform(ex)
            ex.pop("_rng", None)
        return ex
