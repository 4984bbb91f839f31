"""EVA02-style ViT backbone (counterpart of point_sam_tpu/models/vit.py).

The block stack + final norm of timm's Eva as the reference uses it (no
rotary embedding, no mask, no cls token; pc_encoder.py:138-142):
pre-norm attention with separate q/k/v projections (biased q and v,
bias-free k), then a pre-norm SwiGLU MLP with an inner LayerNorm (sub-LN).
Attention runs through ``ops.mha_flat`` (kernel K3 on the card).

The blocks are one ``nn.ModuleList`` named ``blocks``, so state-dict keys
are ``blocks.{i}....`` as in timm. The EVA-giant preset (fused qkv, plain
GELU MLP) comes with the variants.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import mha_flat
from .layers import Dense, LayerNorm


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    embed_dim: int
    depth: int
    num_heads: int
    mlp_hidden_dim: int

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.num_heads


# hidden = int(dim * 4 * 2/3) for the SwiGLU EVA02 family (timm).
VIT_PRESETS: dict[str, ViTConfig] = {
    "eva02_base": ViTConfig(768, 12, 12, int(768 * 4 * 2 / 3)),
    "eva02_large": ViTConfig(1024, 24, 16, int(1024 * 4 * 2 / 3)),
    # Small config for tests.
    "tiny": ViTConfig(128, 2, 4, 256),
}


def get_vit_config(name: str) -> ViTConfig:
    if name not in VIT_PRESETS:
        raise KeyError(f"unknown ViT preset {name!r}; have {sorted(VIT_PRESETS)}")
    return VIT_PRESETS[name]


class EvaAttention(nn.Module):
    def __init__(self, cfg: ViTConfig, *, dtype, device=None, generator=None):
        super().__init__()
        D = cfg.embed_dim
        kw = dict(dtype=dtype, device=device, generator=generator)
        self.q_proj = Dense(D, D, **kw)
        self.k_proj = Dense(D, D, bias=False, **kw)
        self.v_proj = Dense(D, D, **kw)
        self.proj = Dense(D, D, **kw)
        self.num_heads = cfg.num_heads

    def forward(self, x):
        out = mha_flat(self.q_proj(x), self.k_proj(x), self.v_proj(x), self.num_heads)
        return self.proj(out)


class SwiGLU(nn.Module):
    """SwiGLU MLP with an inner LayerNorm (EVA02 sub-LN)."""

    def __init__(self, dim, hidden_dim, *, dtype, device=None, generator=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device, generator=generator)
        self.fc1_g = Dense(dim, hidden_dim, **kw)
        self.fc1_x = Dense(dim, hidden_dim, **kw)
        self.norm = LayerNorm(hidden_dim, dtype=dtype, device=device)
        self.fc2 = Dense(hidden_dim, dim, **kw)

    def forward(self, x):
        return self.fc2(self.norm(F.silu(self.fc1_g(x)) * self.fc1_x(x)))


class EvaBlock(nn.Module):
    def __init__(self, cfg: ViTConfig, *, dtype=torch.float32, device=None,
                 generator=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device, generator=generator)
        D = cfg.embed_dim
        self.norm1 = LayerNorm(D, dtype=dtype, device=device)
        self.attn = EvaAttention(cfg, **kw)
        self.norm2 = LayerNorm(D, dtype=dtype, device=device)
        self.mlp = SwiGLU(D, cfg.mlp_hidden_dim, **kw)

    def forward(self, x):
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class ViT(nn.Module):
    """Block stack + final norm."""

    def __init__(self, cfg: ViTConfig, *, dtype=torch.float32, device=None,
                 generator=None):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        self.blocks = nn.ModuleList(
            EvaBlock(cfg, dtype=dtype, device=device, generator=generator)
            for _ in range(cfg.depth)
        )
        self.norm = LayerNorm(cfg.embed_dim, dtype=dtype, device=device)

    def forward(self, x):
        x = x.to(self.dtype)
        for block in self.blocks:
            x = block(x)
        return self.norm(x)
