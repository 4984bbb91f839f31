"""Point-cloud ViT encoder (counterpart of point_sam_tpu/models/pc_encoder.py).

Patch embed (kNN grouping + PointNet) -> projection to the ViT width ->
MLP positional embedding of the patch centres -> ViT blocks -> final norm
-> projection to the decoder width. The grouping geometry comes from
models/tokenizer.py, computed once per cloud.

Unlike the JAX tree (``params/patch_embed``), the patch embed lives under
``pc_encoder.patch_embed`` here, which is where the reference's state dict
keeps it.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..ops import group_points
from .layers import CoordMLP, Dense
from .patch_encoder import PatchEncoder
from .tokenizer import TokenizerConfig
from .vit import ViT, ViTConfig


class PatchEmbed(nn.Module):
    """kNN grouping + PointNet encoding (reference pc_encoder.py:13-41)."""

    def __init__(self, cfg: TokenizerConfig, in_channels: int, out_channels: int = 512,
                 hidden_dims: Sequence[int] = (128, 512), *, act: str = "erf",
                 dtype=torch.float32, device=None, generator=None):
        super().__init__()
        self.cfg = cfg
        group_channels = 3 + in_channels * (2 if cfg.centralize_features else 1)
        self.patch_encoder = PatchEncoder(group_channels, out_channels, hidden_dims,
                                          act=act, dtype=dtype, device=device,
                                          generator=generator)

    def forward(self, coords, features, geom: dict) -> torch.Tensor:
        group_feats = group_points(
            coords, features, geom["centers"], geom["knn_idx"],
            radius=self.cfg.radius,
            centralize_features=self.cfg.centralize_features,
            center_idx=geom["fps_idx"] if self.cfg.centralize_features else None,
        )  # [B, G, K, 3 + C]
        return self.patch_encoder(group_feats)


class PointCloudEncoder(nn.Module):
    """Patch embed -> ViT -> per-patch embeddings [B, G, embed_dim]
    (reference pc_encoder.py:84-145)."""

    def __init__(self, vit_cfg: ViTConfig, tokenizer: TokenizerConfig, *,
                 in_channels: int = 3, embed_dim: int = 256,
                 patch_embed_channels: int = 512, act: str = "erf",
                 dtype=torch.float32, device=None, generator=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device, generator=generator)
        self.dtype = dtype
        self.patch_embed = PatchEmbed(tokenizer, in_channels, patch_embed_channels,
                                      act=act, **kw)
        self.patch_proj = Dense(patch_embed_channels, vit_cfg.embed_dim, **kw)
        self.pos_embed = CoordMLP(128, vit_cfg.embed_dim, **kw)
        self.transformer = ViT(vit_cfg, **kw)
        self.out_proj = Dense(vit_cfg.embed_dim, embed_dim, **kw)

    def forward(self, patch_embeddings, centers):
        """patch_embeddings [B, G, C] from ``patch_embed``; centers [B, G, 3]."""
        x = self.patch_proj(patch_embeddings)
        x = x + self.pos_embed(centers)
        x = self.transformer(x)
        return self.out_proj(x)
