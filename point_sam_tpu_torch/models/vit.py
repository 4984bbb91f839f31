"""EVA02-style ViT backbone (counterpart of point_sam_tpu/models/vit.py).

The block stack + final norm of timm's Eva as the reference uses it (no
rotary embedding, no mask, no cls token; pc_encoder.py:138-142):

- pre-norm attention: separate q/k/v projections with biased q and v and a
  bias-free k (EVA02), or one fused qkv projection with separate q and v
  biases (EVA-giant, timm's ``qkv.weight`` / ``q_bias`` / ``v_bias``);
- pre-norm MLP: SwiGLU with an inner LayerNorm, sub-LN (EVA02), or a plain
  GELU MLP (EVA-giant);
- optionally timm's LayerNorm on the attention output before ``proj``
  (``attn_inner_norm``, timm's ``scale_attn_inner``; key ``attn.norm``),
  off in every preset.

Attention runs through ``ops.mha_flat``: kernel K3 at EVA02's head size 64,
kernel K5 at EVA-giant's 88. The blocks are one ``nn.ModuleList`` named
``blocks``, so state-dict keys are ``blocks.{i}....`` as in timm.

Under tensor parallelism (``parallel.tensor_parallel.shard_model``) an
attention runs on its rank's heads and an MLP on its rank's slice of the
hidden axis: ``tp_group`` is set, the input passes ``tp_copy`` (Megatron's
f), the projections into the heads or the hidden axis hold their rank's
output features, ``proj`` / ``fc2`` are ``RowParallelDense`` (the partial
sums all-reduced in fp32, Megatron's g) and the sub-LN is a
``ShardedLayerNorm``. ``num_heads`` is then the rank's head count.

With ``remat`` (JAX's ``nn.remat`` on every block) each block runs under
``torch.utils.checkpoint`` while a gradient is being recorded: the
backward keeps only the block inputs and runs each block's forward again.
Without a gradient nothing changes.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops import mha_flat
from .layers import Dense, LayerNorm, tp_copy


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    embed_dim: int
    depth: int
    num_heads: int
    mlp_hidden_dim: int
    swiglu: bool = True  # SwiGLU MLP with its sub-LN (EVA02) vs plain GELU MLP (EVA-giant)
    qkv_fused: bool = False  # fused qkv projection (EVA-giant)
    attn_inner_norm: bool = False  # LayerNorm on the attention output before proj

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.num_heads


# hidden = int(dim * 4 * 2/3) for the SwiGLU EVA02 family (timm); EVA-giant
# has a plain MLP of hidden 6144.
VIT_PRESETS: dict[str, ViTConfig] = {
    "eva02_base": ViTConfig(768, 12, 12, int(768 * 4 * 2 / 3)),
    "eva02_large": ViTConfig(1024, 24, 16, int(1024 * 4 * 2 / 3)),
    "eva_giant": ViTConfig(1408, 40, 16, 6144, swiglu=False, qkv_fused=True),
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
        self.dtype = dtype
        self.qkv_fused = cfg.qkv_fused
        if cfg.qkv_fused:
            # timm's layout: F.linear(x, qkv.weight, cat(q_bias, 0, v_bias)).
            self.qkv = Dense(D, 3 * D, bias=False, **kw)
            self.q_bias = nn.Parameter(torch.zeros(D, device=device))
            self.v_bias = nn.Parameter(torch.zeros(D, device=device))
        else:
            self.q_proj = Dense(D, D, **kw)
            self.k_proj = Dense(D, D, bias=False, **kw)
            self.v_proj = Dense(D, D, **kw)
        self.norm = LayerNorm(D, dtype=dtype, device=device) if cfg.attn_inner_norm else None
        self.proj = Dense(D, D, **kw)
        self.num_heads = cfg.num_heads
        self.tp_group = None  # the model group under tensor parallelism

    def forward(self, x):
        if self.tp_group is not None:
            x = tp_copy(x, self.tp_group)
        if self.qkv_fused:
            bias = torch.cat([self.q_bias, torch.zeros_like(self.q_bias), self.v_bias])
            qkv = F.linear(x.to(self.dtype), self.qkv.weight.to(self.dtype),
                           bias.to(self.dtype))
            q, k, v = qkv.chunk(3, dim=-1)
        else:
            q, k, v = self.q_proj(x), self.k_proj(x), self.v_proj(x)
        out = mha_flat(q, k, v, self.num_heads)
        if self.norm is not None:
            out = self.norm(out)
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
        self.tp_group = None  # the model group under tensor parallelism

    def forward(self, x):
        if self.tp_group is not None:
            x = tp_copy(x, self.tp_group)
        h = F.silu(self.fc1_g(x)) * self.fc1_x(x)
        return self.fc2(self.norm(h))


class GeluMLP(nn.Module):
    """Dense -> exact GELU -> Dense (EVA-giant)."""

    def __init__(self, dim, hidden_dim, *, dtype, device=None, generator=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device, generator=generator)
        self.fc1 = Dense(dim, hidden_dim, **kw)
        self.fc2 = Dense(hidden_dim, dim, **kw)
        self.tp_group = None  # the model group under tensor parallelism

    def forward(self, x):
        if self.tp_group is not None:
            x = tp_copy(x, self.tp_group)
        return self.fc2(F.gelu(self.fc1(x)))


class EvaBlock(nn.Module):
    def __init__(self, cfg: ViTConfig, *, dtype=torch.float32, device=None,
                 generator=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device, generator=generator)
        D = cfg.embed_dim
        self.norm1 = LayerNorm(D, dtype=dtype, device=device)
        self.attn = EvaAttention(cfg, **kw)
        self.norm2 = LayerNorm(D, dtype=dtype, device=device)
        if cfg.swiglu:
            self.mlp = SwiGLU(D, cfg.mlp_hidden_dim, **kw)
        else:
            self.mlp = GeluMLP(D, cfg.mlp_hidden_dim, **kw)

    def forward(self, x):
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class ViT(nn.Module):
    """Block stack + final norm; ``remat``: recompute each block in the
    backward (see the module docstring)."""

    def __init__(self, cfg: ViTConfig, *, remat: bool = False, dtype=torch.float32,
                 device=None, generator=None):
        super().__init__()
        self.cfg = cfg
        self.remat = remat
        self.dtype = dtype
        self.blocks = nn.ModuleList(
            EvaBlock(cfg, dtype=dtype, device=device, generator=generator)
            for _ in range(cfg.depth)
        )
        self.norm = LayerNorm(cfg.embed_dim, dtype=dtype, device=device)

    def forward(self, x):
        x = x.to(self.dtype)
        remat = self.remat and torch.is_grad_enabled()
        for block in self.blocks:
            x = checkpoint(block, x, use_reentrant=False) if remat else block(x)
        return self.norm(x)
