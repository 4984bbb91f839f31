"""Click and mask prompt encoders (counterpart of
point_sam_tpu/models/prompt_encoder.py).

- ``PositionEmbeddingRandom``: random-Fourier PE; the gaussian matrix is a
  buffer, kept in fp32.
- ``PointEncoder``: PE of the click coordinates plus a learned
  negative / positive embedding.
- ``MaskEncoder``: previous mask logits regrouped onto the encoder's
  centres / kNN and PointNet-encoded (kernel K2 on the card); a learned
  ``no_mask_embed`` when there is no mask prompt.
- ``MaskEncoderNN``: the voronoi variant's mask encoder, per-point
  [logit, offset to the centre, its length] -> Dense -> segment max onto
  the centres -> residual MLP stack. The JAX converter has no torch keys
  for it, so its keys follow the flax module names (``first_nn``,
  ``res_in``, ``res_in_norm``, ``res_{i}``, ``res_{i}_norm``, ``res_out``).
- ``PromptEncoderNN``: ``PointEncoder`` and ``MaskEncoderNN`` in one module
  (the reference bundles them for the voronoi model; the port's
  ``PointCloudSAMNN`` holds the two apart, as JAX's does).
- ``MaskEncoderHier``: the hier variant's mask encoder, the logits grouped
  onto the level-1 centres and encoded (K2), then those embeddings grouped
  onto the level-2 centres and encoded again (K2).

Padded click slots are encoded like real ones; the decoder's attention
masks neutralise them.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn

from ..ops import (
    batch_index_select,
    group_features,
    group_points,
    repeat_interleave,
    scatter_max,
)
from .layers import GELU, Dense, Embedding, LayerNorm, normal_
from .patch_encoder import PatchEncoder


class PositionEmbeddingRandom(nn.Module):
    """Random spatial-frequency positional encoding for [-1, 1] coords."""

    def __init__(self, num_pos_feats: int = 128, scale: float = 1.0, *, device=None,
                 generator=None):
        super().__init__()
        mat = torch.empty((3, num_pos_feats), dtype=torch.float32, device=device)
        self.register_buffer("positional_encoding_gaussian_matrix",
                             normal_(mat, scale, generator))

    def forward(self, coords: torch.Tensor) -> torch.Tensor:
        """coords [..., 3] -> [..., 2 * num_pos_feats], fp32 throughout."""
        x = coords.float() @ self.positional_encoding_gaussian_matrix
        x = (2.0 * math.pi) * x
        return torch.cat([torch.sin(x), torch.cos(x)], dim=-1)


class PointEncoder(nn.Module):
    """Click prompt encoder (reference prompt_encoder.py:51-77)."""

    def __init__(self, embed_dim: int = 256, *, dtype=torch.float32, device=None,
                 generator=None):
        super().__init__()
        self.dtype = dtype
        self.pe_layer = PositionEmbeddingRandom(embed_dim // 2, device=device,
                                                generator=generator)
        # point_embeddings[0] = negative, [1] = positive.
        self.point_embeddings = nn.ModuleList(
            Embedding(1, embed_dim, device=device, generator=generator) for _ in range(2)
        )

    def forward(self, points: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        """points [..., P, 3], labels [..., P] bool/int -> [..., P, D]."""
        pe = self.pe_layer(points)
        lab = torch.where(labels[..., None] > 0, self.point_embeddings[1].weight[0],
                          self.point_embeddings[0].weight[0])
        return (pe + lab).to(self.dtype)


class MaskEncoder(nn.Module):
    """Mask prompt encoder (reference prompt_encoder.py:80-133)."""

    def __init__(self, embed_dim: int = 256, hidden_dims: Sequence[int] = (128, 512),
                 radius: float | None = None, *, act: str = "erf", dtype=torch.float32,
                 device=None, generator=None):
        super().__init__()
        self.embed_dim = embed_dim
        self.radius = radius
        self.dtype = dtype
        self.patch_encoder = PatchEncoder(4, embed_dim, hidden_dims, act=act, dtype=dtype,
                                          device=device, generator=generator)
        self.no_mask_embed = Embedding(1, embed_dim, device=device, generator=generator)

    def forward(self, masks, coords, centers, knn_idx, rel_xyz=None):
        """masks [B*M, N] logits (or None), coords [B, N, 3], centers
        [B, L, 3], knn_idx [B, L, K] -> dense embeddings [B*M or B, L, D].

        rel_xyz: optional cached [B, L, K, 3] from ``mask_group_rel_xyz``;
        the output is bit-identical with or without it.
        """
        if masks is None:
            B, L = centers.shape[:2]
            return self.no_mask_embed.weight[0].to(self.dtype).expand(B, L, self.embed_dim)
        masks = masks.detach()
        if rel_xyz is None:
            patches = group_points(coords, masks[..., None], centers, knn_idx,
                                   radius=self.radius)  # [B*M, L, K, 4]
        else:
            logit = group_features(masks[..., None], knn_idx)  # [B*M, L, K, 1]
            nbr = repeat_interleave(rel_xyz, masks.shape[0] // coords.shape[0], axis=0)
            patches = torch.cat([nbr, logit.to(nbr.dtype)], dim=-1)
        return self.patch_encoder(patches)


def mask_group_rel_xyz(coords, centers, knn_idx, radius=None):
    """Click-invariant half of the mask-prompt grouping: each centre's K
    neighbours relative to it, [B, L, K, 3] (computed as group_points does,
    so cached and uncached MaskEncoder outputs are bit-equal)."""
    nbr = batch_index_select(coords, knn_idx, axis=1) - centers[:, :, None, :]
    if radius is not None:
        nbr = nbr / radius
    return nbr


def mask_nbr_dist(coords, centers, nn_idx):
    """Click-invariant half of the voronoi mask-prompt features: each
    point's offset from its centre and its length ([B, N, 3], [B, N, 1]),
    computed as ``MaskEncoderNN`` computes them inline, so cached and
    uncached outputs are bit-equal."""
    nbr = coords - batch_index_select(centers, nn_idx, axis=1)
    return nbr, torch.linalg.vector_norm(nbr, dim=-1, keepdim=True)


class MaskEncoderNN(nn.Module):
    """Voronoi mask prompt encoder (reference prompt_encoder.py:248-300)."""

    def __init__(self, embed_dim: int = 256, hidden_dim: int = 1024, *,
                 num_patches: int | None = None, dtype=torch.float32, device=None,
                 generator=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device, generator=generator)
        self.embed_dim = embed_dim
        self.num_patches = num_patches
        self.dtype = dtype
        self.no_mask_embed = Embedding(1, embed_dim, device=device, generator=generator)
        self.first_nn = Dense(5, hidden_dim, **kw)
        self.res_in = Dense(hidden_dim, hidden_dim, **kw)
        self.res_in_norm = LayerNorm(hidden_dim, dtype=dtype, device=device)
        for i in range(3):
            self.add_module(f"res_{i}", Dense(hidden_dim, hidden_dim, **kw))
            self.add_module(f"res_{i}_norm", LayerNorm(hidden_dim, dtype=dtype, device=device))
        self.res_out = Dense(hidden_dim, embed_dim, **kw)
        self.act = GELU()

    def forward(self, masks, coords, centers, nn_idx, point_valid=None, nbr_dist=None):
        """masks [B*M, N] logits or None; coords [B, N, 3]; centers [B, L, 3];
        nn_idx [B, N] voronoi assignment; point_valid [B, N] padding mask
        (padded points never win the per-centre max) -> [B*M or B, L, D].

        nbr_dist: optional cached (nbr, dist) from ``mask_nbr_dist``; the
        output is bit-identical with or without it. The segment count is
        ``num_patches``, or the geometry's centre count L where it is None."""
        B, L = centers.shape[:2]
        if masks is None:
            return self.no_mask_embed.weight[0].to(self.dtype).expand(B, L, self.embed_dim)
        masks = masks.detach()
        repeats = masks.shape[0] // coords.shape[0]
        nbr, dist = nbr_dist if nbr_dist is not None else mask_nbr_dist(coords, centers, nn_idx)
        if repeats > 1:
            nbr, dist, nn_idx = (repeat_interleave(t, repeats, axis=0)
                                 for t in (nbr, dist, nn_idx))
        feats = torch.cat([masks[..., None].to(nbr.dtype), nbr, dist], dim=-1)  # [BM, N, 5]
        x = self.first_nn(feats)
        if point_valid is not None:
            pv = repeat_interleave(point_valid, x.shape[0] // point_valid.shape[0], axis=0)
            x = x.masked_fill(~pv[..., None], float("-inf"))
        y = scatter_max(x, nn_idx, L if self.num_patches is None else self.num_patches)
        h = self.act(self.res_in_norm(self.res_in(y)))
        for i in range(3):
            r = getattr(self, f"res_{i}_norm")(getattr(self, f"res_{i}")(h))
            h = h + self.act(r)
        return self.res_out(h)


class PromptEncoderNN(nn.Module):
    """Click and voronoi mask prompt encoders in one module (reference
    prompt_encoder.py:303-354): ``point_encoder`` and ``mask_encoder``,
    the voronoi model's keys."""

    def __init__(self, embed_dim: int = 256, num_patches: int = 1024, *, dtype=torch.float32,
                 device=None, generator=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device, generator=generator)
        self.point_encoder = PointEncoder(embed_dim, **kw)
        self.mask_encoder = MaskEncoderNN(embed_dim, num_patches=num_patches, **kw)

    def embed_points(self, points, labels):
        return self.point_encoder(points, labels)

    def embed_masks(self, masks, coords, centers, nn_idx, point_valid=None):
        return self.mask_encoder(masks, coords, centers, nn_idx, point_valid)

    def forward(self, points, labels, masks, coords, centers, nn_idx, point_valid=None):
        """-> (sparse [..., P, D], dense [B*M or B, L, D]) embeddings."""
        return (self.embed_points(points, labels),
                self.embed_masks(masks, coords, centers, nn_idx, point_valid))


class MaskEncoderHier(nn.Module):
    """Two-level mask prompt encoder (reference prompt_encoder.py:136-183):
    ``patch_encoder1`` (4 -> 128, widths (64, 128)) over the level-1 groups
    of the mask logits, ``patch_encoder2`` (131 -> embed_dim, widths
    (128, 256)) over the level-2 groups of those embeddings."""

    def __init__(self, embed_dim: int = 256, radius: tuple[float, float] | None = None, *,
                 dtype=torch.float32, device=None, generator=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device, generator=generator)
        self.embed_dim = embed_dim
        self.radius = radius
        self.dtype = dtype
        self.patch_encoder1 = PatchEncoder(4, 128, (64, 128), **kw)
        self.patch_encoder2 = PatchEncoder(3 + 128, embed_dim, (128, 256), **kw)
        self.no_mask_embed = Embedding(1, embed_dim, device=device, generator=generator)

    def forward(self, masks, coords, centers1, knn_idx1, centers2, knn_idx2, rel_xyz1=None,
                rel_xyz2=None):
        """masks [B*M, N] logits (or None); coords [B, N, 3]; centers1 /
        knn_idx1 and centers2 / knn_idx2 the two levels' geometry ->
        (x1 [B*M, G1, 128] or None, dense embeddings [B*M or B, G2, D]).

        rel_xyz1 / rel_xyz2: optional cached [B, G_l, K_l, 3] per level from
        ``mask_group_rel_xyz``; the output is bit-identical with or without
        them."""
        if masks is None:
            B, L = centers2.shape[:2]
            return None, self.no_mask_embed.weight[0].to(self.dtype).expand(
                B, L, self.embed_dim)
        masks = masks.detach()
        r = self.radius
        if rel_xyz1 is None:
            p1 = group_points(coords, masks[..., None], centers1, knn_idx1,
                              radius=r[0] if r else None)
        else:
            logit = group_features(masks[..., None], knn_idx1)
            nbr = repeat_interleave(rel_xyz1, masks.shape[0] // coords.shape[0], axis=0)
            p1 = torch.cat([nbr, logit.to(nbr.dtype)], dim=-1)
        x1 = self.patch_encoder1(p1)  # [B*M, G1, 128]
        if rel_xyz2 is None:
            p2 = group_points(centers1, x1, centers2, knn_idx2, radius=r[1] if r else None)
        else:
            feats = group_features(x1, knn_idx2)  # [B*M, G2, K2, 128]
            nbr2 = repeat_interleave(rel_xyz2, x1.shape[0] // centers1.shape[0], axis=0)
            # The concat promotes to the fp32 of the offsets, as group_points'
            # does: bit-equal either way.
            p2 = torch.cat([nbr2, feats.to(nbr2.dtype)], dim=-1)
        return x1, self.patch_encoder2(p2)
