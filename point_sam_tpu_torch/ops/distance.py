"""Pairwise squared distances (counterpart of point_sam_tpu/ops/distance.py).

All distances are *squared* Euclidean: every consumer (kNN ordering, 1/d^2
interpolation weights, farthest-point argmax) is invariant to the sqrt.
"""

from __future__ import annotations

import torch


def sq_dist(query: torch.Tensor, key: torch.Tensor) -> torch.Tensor:
    """Squared distance matrix via the |q|^2 - 2qk + |k|^2 expansion.

    The cross term is a matmul and must run in full fp32: neighbour
    selection is rank-sensitive, and a reduced-precision cross term (bf16
    or TF32 inputs) collapses top-256 recall on clustered clouds (0.51 in
    the reference's measurement). The package turns TF32 off at import
    (see ``point_sam_tpu_torch/__init__.py``).

    Args:
        query: [..., Nq, D] float tensor.
        key: [..., Nk, D] float tensor.

    Returns:
        [..., Nq, Nk] squared distances, clamped to >= 0.
    """
    q2 = query.square().sum(-1, keepdim=True)  # [..., Nq, 1]
    k2 = key.square().sum(-1, keepdim=True)  # [..., Nk, 1]
    qk = torch.matmul(query, key.transpose(-1, -2))
    d2 = q2 - 2.0 * qk + k2.transpose(-1, -2)
    return d2.clamp_min(0.0)


def sq_dist_to_point(points: torch.Tensor, center: torch.Tensor) -> torch.Tensor:
    """Squared distance from every point to one center, explicit-difference
    form summed as ((dx^2 + dy^2) + dz^2).

    Args:
        points: [..., N, 3]. center: [..., 3].

    Returns:
        [..., N] squared distances.
    """
    diff = points - center[..., None, :]
    sq = diff * diff
    return (sq[..., 0] + sq[..., 1]) + sq[..., 2]
