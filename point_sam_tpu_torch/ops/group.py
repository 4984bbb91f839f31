"""Grouping / gathering primitives (counterpart of point_sam_tpu/ops/group.py).

Indices are int32 at the public API, as in the JAX package; they become
int64 only at the ``torch.gather`` / indexing call.
"""

from __future__ import annotations

import torch


def batch_index_select(x: torch.Tensor, idx: torch.Tensor, axis: int = 1) -> torch.Tensor:
    """Gather along ``axis`` with per-batch indices.

    Args:
        x: [B, N, ...] data.
        idx: [B, ...] integer indices into axis ``axis`` of x.

    Returns:
        Gathered tensor with idx's shape in place of x's ``axis``.
    """
    if axis != 1 and idx.ndim > 2:
        raise NotImplementedError(
            "batch_index_select with axis != 1 supports 2-D idx only"
        )
    if axis != 1:
        x = torch.movedim(x, axis, 1)
    B, N = x.shape[:2]
    flat = x.reshape((B * N,) + tuple(x.shape[2:]))
    offsets = (torch.arange(B, device=x.device, dtype=torch.int64) * N).reshape(
        (B,) + (1,) * (idx.ndim - 1)
    )
    flat_idx = (idx.long() + offsets).reshape(-1)
    out = flat.index_select(0, flat_idx)
    out = out.reshape(tuple(idx.shape) + tuple(x.shape[2:]))
    if axis != 1:
        out = torch.movedim(out, idx.ndim - 1, axis + idx.ndim - 2)
    return out


def repeat_interleave(x: torch.Tensor, repeats: int, axis: int = 0) -> torch.Tensor:
    """Each slice along ``axis`` repeated ``repeats`` times in place."""
    if repeats == 1:
        return x
    return torch.repeat_interleave(x, repeats, dim=axis)


def batch_index_select_repeated(
    features: torch.Tensor, idx: torch.Tensor, repeats: int
) -> torch.Tensor:
    """Gather [B*M, N, C] features with [B, ...] indices shared across M."""
    return batch_index_select(features, repeat_interleave(idx, repeats, 0), axis=1)


def group_points(
    xyz: torch.Tensor,
    features: torch.Tensor,
    centers: torch.Tensor,
    knn_idx: torch.Tensor,
    *,
    radius: float | None = None,
    centralize_features: bool = False,
    center_idx: torch.Tensor | None = None,
) -> torch.Tensor:
    """Per-patch features [rel_xyz, nbr_feats(, nbr - center_feats)].

    Args:
        xyz: [B, N, 3]. features: [B*M, N, C] (B*M a multiple of B).
        centers: [B, G, 3]. knn_idx: [B, G, K] indices into N.

    Returns:
        [B*M, G, K, 3 + C (+ C)].
    """
    B = xyz.shape[0]
    BM, N, C = features.shape
    if BM % B:
        raise ValueError(f"features batch {BM} is not a multiple of {B}")
    repeats = BM // B
    G, K = knn_idx.shape[1:3]
    # All M replicas share the geometry: fold them into the channel axis so
    # the rows are gathered once over [B, N, 3 + M*C].
    feats_ch = features.reshape(B, repeats, N, C).transpose(1, 2).reshape(
        B, N, repeats * C
    )
    packed = torch.cat([xyz, feats_ch.to(xyz.dtype)], dim=-1)
    nbr = batch_index_select(packed, knn_idx, axis=1)  # [B, G, K, 3 + M*C]
    nbr_xyz = nbr[..., :3] - centers[:, :, None, :]
    if radius is not None:
        nbr_xyz = nbr_xyz / radius
    nbr_feats = nbr[..., 3:].reshape(B, G, K, repeats, C).to(features.dtype)
    nbr_feats = nbr_feats.permute(0, 3, 1, 2, 4).reshape(BM, G, K, C)
    nbr_xyz = repeat_interleave(nbr_xyz, repeats, axis=0)

    parts = [nbr_xyz, nbr_feats]
    if centralize_features:
        if center_idx is None:
            raise ValueError("centralize_features needs center_idx")
        center_feats = batch_index_select_repeated(features, center_idx, repeats)
        parts.append(nbr_feats - center_feats[:, :, None, :])
    return torch.cat(parts, dim=-1)


def group_features(features: torch.Tensor, knn_idx: torch.Tensor) -> torch.Tensor:
    """Gather [B*M, N, C] features into [B*M, G, K, C] patch groups whose
    geometry (knn_idx [B, G, K]) is shared across the M replicas."""
    B, G, K = knn_idx.shape
    BM, N, C = features.shape
    if BM % B:
        raise ValueError(f"features batch {BM} is not a multiple of {B}")
    repeats = BM // B
    feats_ch = features.reshape(B, repeats, N, C).transpose(1, 2).reshape(
        B, N, repeats * C
    )
    nbr = batch_index_select(feats_ch, knn_idx, axis=1)  # [B, G, K, M*C]
    return nbr.reshape(B, G, K, repeats, C).permute(0, 3, 1, 2, 4).reshape(
        BM, G, K, C
    )


def group_voronoi(xyz: torch.Tensor, features: torch.Tensor, centers: torch.Tensor,
                  nn_idx: torch.Tensor, *, eps: float = 1e-8) -> torch.Tensor:
    """Per-point voronoi features [unit_dir, dist, features]: each point's
    offset from its centre as a unit direction and a length.

    Args:
        xyz: [B, N, 3]. features: [B, N, C]. centers: [B, L, 3].
        nn_idx: [B, N] index of each point's nearest centre.

    Returns:
        [B, N, 3 + 1 + C].
    """
    nbr_xyz = xyz - batch_index_select(centers, nn_idx, axis=1)
    dist = torch.linalg.vector_norm(nbr_xyz, dim=-1, keepdim=True)
    unit = nbr_xyz / torch.clamp_min(dist, eps)
    return torch.cat([unit, dist, features.to(unit.dtype)], dim=-1)
