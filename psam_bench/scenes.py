"""Seeded scenes, the benchmark's traffic source: unions of random boxes,
spheres and cylinders, each part one instance mask (a copy of the
program's synthetic-scene generator, ``datasets/synthetic.py::
generate_scene``, with the box sampler vectorised; the same seed gives
the same scene), and their normalisation into the unit sphere.
"""

from __future__ import annotations

import numpy as np


def _box(rng, n):
    size = rng.uniform(0.2, 1.0, 3)
    face = rng.integers(0, 6, n)
    u, v = rng.uniform(-0.5, 0.5, (2, n))
    axis = face // 2
    sign = (face % 2) * 2.0 - 1.0
    rest0 = np.where(axis == 0, 1, 0)
    rest1 = np.where(axis == 2, 1, 2)
    pts = np.empty((n, 3))
    rows = np.arange(n)
    pts[rows, axis] = 0.5 * sign
    pts[rows, rest0] = u
    pts[rows, rest1] = v
    return pts * size


def _sphere(rng, n):
    v = rng.standard_normal((n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True) + 1e-12
    return v * rng.uniform(0.15, 0.5)


def _cylinder(rng, n):
    r = rng.uniform(0.1, 0.4)
    h = rng.uniform(0.3, 1.0)
    theta = rng.uniform(0, 2 * np.pi, n)
    z = rng.uniform(-0.5, 0.5, n) * h
    return np.stack([r * np.cos(theta), r * np.sin(theta), z], axis=1)


_PRIMS = [_box, _sphere, _cylinder]


def generate_scene(seed: int, num_points: int, num_parts=(3, 8), noise: float = 0.005) -> dict:
    """coords [N, 3] float64, features [N, 3] colours in 0..255, gt_masks
    [K, N] bool (one per part)."""
    rng = np.random.default_rng(seed)
    k = int(rng.integers(num_parts[0], num_parts[1] + 1))
    weights = rng.dirichlet(np.ones(k) * 2.0)
    counts = np.maximum((weights * num_points).astype(int), 16)
    counts[-1] = num_points - counts[:-1].sum()
    if counts[-1] < 16:
        counts = np.full(k, num_points // k)
        counts[-1] += num_points - counts.sum()
    pts_list, part_ids, colors = [], [], []
    for p in range(k):
        prim = _PRIMS[int(rng.integers(len(_PRIMS)))]
        pts = prim(rng, int(counts[p]))
        qmat, _ = np.linalg.qr(rng.standard_normal((3, 3)))
        pts = pts @ qmat.T + rng.uniform(-1, 1, 3)
        pts_list.append(pts)
        part_ids.append(np.full(len(pts), p))
        base = rng.uniform(30, 225, 3)
        colors.append(np.clip(base + rng.normal(0, 10, (len(pts), 3)), 0, 255))
    coords = np.concatenate(pts_list)
    coords += rng.normal(0, noise, coords.shape)
    ids = np.concatenate(part_ids)
    rgb = np.concatenate(colors)
    perm = rng.permutation(len(coords))
    coords, ids, rgb = coords[perm], ids[perm], rgb[perm]
    return dict(coords=coords, features=rgb, gt_masks=np.stack([ids == p for p in range(k)]))


def unit_sphere(xyz: np.ndarray) -> np.ndarray:
    c = xyz - xyz.mean(0)
    return c / max(float(np.linalg.norm(c, axis=1).max()), 1e-12)
