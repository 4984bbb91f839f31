"""Point-cloud ViT encoder (counterpart of point_sam_tpu/models/pc_encoder.py).

Patch embed (kNN grouping + PointNet) -> projection to the ViT width ->
MLP positional embedding of the patch centres -> ViT blocks -> final norm
-> projection to the decoder width. The grouping geometry comes from
models/tokenizer.py, computed once per cloud.

Unlike the JAX tree (``params/patch_embed``), the patch embed lives under
``pc_encoder.patch_embed`` here, which is where the reference's state dict
keeps it. ``PatchEmbedNN`` is the voronoi variant's: per-point MLP blocks,
a segment max onto the centres, per-centre MLP blocks. The JAX converter
has no torch keys for it, so its keys follow the flax module names
(``in_proj``, ``blocks1_{i}``, ``blocks2_{i}``, ``norm``, ``out_proj``).
``PatchEmbedHier`` is the hier variant's two PointNets, ``patch_encoder1``
and ``patch_encoder2`` (the reference's and the flax names).
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..ops import group_points, group_voronoi, scatter_max
from .layers import GELU, CoordMLP, Dense, LayerNorm
from .patch_encoder import PatchEncoder
from .tokenizer import HierTokenizerConfig, TokenizerConfig
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


class PreLNBlock(nn.Module):
    """x + Dense(LN(GELU(Dense(LN(x))))), the residual block of the voronoi
    patch embed (reference pc_encoder.py:148-162)."""

    def __init__(self, dim: int, *, dtype=torch.float32, device=None, generator=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device, generator=generator)
        self.norm = LayerNorm(dim, dtype=dtype, device=device)
        self.fc1 = Dense(dim, dim, **kw)
        self.act = GELU()
        self.mid_norm = LayerNorm(dim, dtype=dtype, device=device)
        self.fc2 = Dense(dim, dim, **kw)

    def forward(self, x):
        return x + self.fc2(self.mid_norm(self.act(self.fc1(self.norm(x)))))


class PatchEmbedNN(nn.Module):
    """Voronoi tokenizer: per-point MLP blocks, segment max onto the
    centres, per-centre MLP blocks (reference pc_encoder.py:148-198).

    The segment count is the geometry's centre count, so a per-scene G (the
    Predictor's N > 30000 rule) embeds every centre."""

    def __init__(self, in_channels: int = 3, hidden_dim: int = 256, out_channels: int = 512,
                 *, dtype=torch.float32, device=None, generator=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device, generator=generator)
        self.dtype = dtype
        self.in_proj = Dense(4 + in_channels, hidden_dim, **kw)
        for i in range(3):
            self.add_module(f"blocks1_{i}", PreLNBlock(hidden_dim, **kw))
        for i in range(3):
            self.add_module(f"blocks2_{i}", PreLNBlock(hidden_dim, **kw))
        self.norm = LayerNorm(hidden_dim, dtype=dtype, device=device)
        self.out_proj = Dense(hidden_dim, out_channels, **kw)

    def forward(self, coords, features, geom: dict) -> torch.Tensor:
        """coords [B, N, 3], features [B, N, C], geom from
        ``compute_geometry_voronoi`` -> [B, G, out_channels]."""
        x = self.in_proj(group_voronoi(coords, features, geom["centers"], geom["nn_idx"]))
        for i in range(3):
            x = getattr(self, f"blocks1_{i}")(x)
        if geom.get("point_valid") is not None:  # padded points never win the max
            x = x.masked_fill(~geom["point_valid"][..., None], float("-inf"))
        y = scatter_max(x, geom["nn_idx"], geom["centers"].shape[1])
        for i in range(3):
            y = getattr(self, f"blocks2_{i}")(y)
        return self.out_proj(self.norm(y))


class PatchEmbedHier(nn.Module):
    """PointNet++-style two-level patch embed (reference pc_encoder.py:201-239).

    Level 1 groups the cloud into G1 patches and encodes them to 128
    channels (kernel K2 at C_in = 3 + C, widths (64, 128)); level 2 groups
    the level-1 centres and their 128-channel embeddings into G2 patches and
    encodes them to ``out_channels`` (K2 at C_in = 131, widths (128, 256)).
    Returns (embeddings_l1 [B, G1, 128], embeddings_l2 [B, G2, out])."""

    def __init__(self, cfg: HierTokenizerConfig, in_channels: int = 3, out_channels: int = 512,
                 *, dtype=torch.float32, device=None, generator=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device, generator=generator)
        self.cfg = cfg
        self.patch_encoder1 = PatchEncoder(3 + in_channels, 128, (64, 128), **kw)
        self.patch_encoder2 = PatchEncoder(3 + 128, out_channels, (128, 256), **kw)

    def forward(self, coords, features, geom: dict):
        r = self.cfg.radius
        g1 = group_points(coords, features, geom["centers1"], geom["knn_idx1"],
                          radius=r[0] if r else None)
        x1 = self.patch_encoder1(g1)
        g2 = group_points(geom["centers1"], x1, geom["centers2"], geom["knn_idx2"],
                          radius=r[1] if r else None)
        return x1, self.patch_encoder2(g2)


class PointCloudEncoder(nn.Module):
    """Patch embed -> ViT -> per-patch embeddings [B, G, embed_dim]
    (reference pc_encoder.py:84-145)."""

    def __init__(self, vit_cfg: ViTConfig, tokenizer: TokenizerConfig | None = None, *,
                 in_channels: int = 3, embed_dim: int = 256,
                 patch_embed_channels: int = 512, act: str = "erf",
                 patch_embed: nn.Module | None = None, vit_remat: bool = False,
                 dtype=torch.float32, device=None, generator=None):
        """``patch_embed``: the variant's patch embed module; without one,
        the kNN ``PatchEmbed`` of ``tokenizer``. ``vit_remat``: recompute
        each ViT block in the backward (JAX's ``vit_remat``)."""
        super().__init__()
        kw = dict(dtype=dtype, device=device, generator=generator)
        self.dtype = dtype
        self.patch_embed = patch_embed or PatchEmbed(tokenizer, in_channels,
                                                     patch_embed_channels, act=act, **kw)
        self.patch_proj = Dense(patch_embed_channels, vit_cfg.embed_dim, **kw)
        self.pos_embed = CoordMLP(128, vit_cfg.embed_dim, **kw)
        self.transformer = ViT(vit_cfg, remat=vit_remat, **kw)
        self.out_proj = Dense(vit_cfg.embed_dim, embed_dim, **kw)

    def forward(self, patch_embeddings, centers):
        """patch_embeddings [B, G, C] from ``patch_embed``; centers [B, G, 3]."""
        x = self.patch_proj(patch_embeddings)
        x = x + self.pos_embed(centers)
        x = self.transformer(x)
        return self.out_proj(x)
