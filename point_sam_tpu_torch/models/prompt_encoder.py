"""Click and mask prompt encoders (counterpart of
point_sam_tpu/models/prompt_encoder.py).

- ``PositionEmbeddingRandom``: random-Fourier PE; the gaussian matrix is a
  buffer, kept in fp32.
- ``PointEncoder``: PE of the click coordinates plus a learned
  negative / positive embedding.
- ``MaskEncoder``: previous mask logits regrouped onto the encoder's
  centres / kNN and PointNet-encoded (kernel K2 on the card); a learned
  ``no_mask_embed`` when there is no mask prompt.

Padded click slots are encoded like real ones; the decoder's attention
masks neutralise them.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn

from ..ops import batch_index_select, group_features, group_points, repeat_interleave
from .layers import Embedding, normal_
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
