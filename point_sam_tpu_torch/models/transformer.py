"""SAM-style two-way transformer (counterpart of point_sam_tpu/models/transformer.py).

depth blocks of {token self-attention, token->pc cross-attention, MLP,
pc->token cross-attention}, each with residual + LN, then a final
token->pc attention (reference transformer.py:15-176). Cross-attention
runs at half width (downsample_rate=2).

Padded prompt slots are neutralised with an additive -1e30 key mask
wherever tokens act as attention keys; their own outputs are never read.
These are small matmuls, left to torch.matmul as the JAX package left
them to XLA.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from .layers import Dense, LayerNorm, MLPBlock

_NEG_INF = -1e30  # additive softmax mask; finite, so no NaN from -inf - -inf


class Attention(nn.Module):
    """Multi-head attention with optional width downsampling and key mask
    (reference transformer.py:179-236)."""

    def __init__(self, embed_dim: int, num_heads: int, downsample_rate: int = 1, *,
                 dtype=torch.float32, device=None, generator=None):
        super().__init__()
        internal = embed_dim // downsample_rate
        kw = dict(dtype=dtype, device=device, generator=generator)
        self.q_proj = Dense(embed_dim, internal, **kw)
        self.k_proj = Dense(embed_dim, internal, **kw)
        self.v_proj = Dense(embed_dim, internal, **kw)
        self.out_proj = Dense(internal, embed_dim, **kw)
        self.num_heads = num_heads
        self.dtype = dtype

    def forward(self, q, k, v, *, key_valid=None):
        q, k, v = self.q_proj(q), self.k_proj(k), self.v_proj(v)
        B, Lq, C = q.shape
        Lk = k.shape[1]
        hd = C // self.num_heads
        q = q.reshape(B, Lq, self.num_heads, hd).transpose(1, 2)
        k = k.reshape(B, Lk, self.num_heads, hd).transpose(1, 2)
        v = v.reshape(B, Lk, self.num_heads, hd).transpose(1, 2)
        attn = torch.matmul(q.float(), k.float().transpose(-1, -2)) / math.sqrt(hd)
        if key_valid is not None:
            mask = torch.zeros(key_valid.shape, dtype=torch.float32, device=attn.device)
            attn = attn + mask.masked_fill(~key_valid, _NEG_INF)[:, None, None, :]
        attn = torch.softmax(attn, dim=-1).to(self.dtype)
        out = torch.matmul(attn, v).transpose(1, 2).reshape(B, Lq, C)
        return self.out_proj(out)


class TwoWayAttentionBlock(nn.Module):
    """(reference transformer.py:103-176)."""

    def __init__(self, embed_dim: int, num_heads: int, mlp_dim: int = 2048,
                 downsample_rate: int = 2, skip_first_layer_pe: bool = False, *,
                 dtype=torch.float32, device=None, generator=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device, generator=generator)
        self.self_attn = Attention(embed_dim, num_heads, **kw)
        self.norm1 = LayerNorm(embed_dim, dtype=dtype, device=device)
        self.cross_attn_token_to_image = Attention(embed_dim, num_heads, downsample_rate, **kw)
        self.norm2 = LayerNorm(embed_dim, dtype=dtype, device=device)
        self.mlp = MLPBlock(embed_dim, mlp_dim, embed_dim, act=torch.relu, **kw)
        self.norm3 = LayerNorm(embed_dim, dtype=dtype, device=device)
        self.norm4 = LayerNorm(embed_dim, dtype=dtype, device=device)
        self.cross_attn_image_to_token = Attention(embed_dim, num_heads, downsample_rate, **kw)
        self.skip_first_layer_pe = skip_first_layer_pe

    def forward(self, queries, keys, query_pe, key_pe, *, query_valid=None):
        if self.skip_first_layer_pe:
            queries = self.self_attn(queries, queries, queries, key_valid=query_valid)
        else:
            q = queries + query_pe
            queries = queries + self.self_attn(q, q, queries, key_valid=query_valid)
        queries = self.norm1(queries)

        q = queries + query_pe
        k = keys + key_pe
        queries = self.norm2(queries + self.cross_attn_token_to_image(q, k, keys))

        queries = self.norm3(queries + self.mlp(queries))

        # pc -> token attention: tokens are the keys, mask the padded ones.
        q = queries + query_pe
        k = keys + key_pe
        keys = self.norm4(keys + self.cross_attn_image_to_token(k, q, queries,
                                                                key_valid=query_valid))
        return queries, keys


class TwoWayTransformer(nn.Module):
    """(reference transformer.py:15-100)."""

    def __init__(self, depth: int = 2, embed_dim: int = 256, num_heads: int = 8,
                 mlp_dim: int = 2048, downsample_rate: int = 2, *, dtype=torch.float32,
                 device=None, generator=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device, generator=generator)
        self.dtype = dtype
        self.layers = nn.ModuleList(
            TwoWayAttentionBlock(embed_dim, num_heads, mlp_dim, downsample_rate,
                                 skip_first_layer_pe=(i == 0), **kw)
            for i in range(depth)
        )
        self.final_attn_token_to_image = Attention(embed_dim, num_heads, downsample_rate, **kw)
        self.norm_final_attn = LayerNorm(embed_dim, dtype=dtype, device=device)

    def forward(self, pc_embedding, pc_pe, point_embedding, *, token_valid=None):
        """pc_embedding, pc_pe: [B, G, D]; point_embedding: [B, T, D];
        token_valid: optional [B, T] bool (False = padded prompt slot).

        Returns (tokens [B, T, D], pc [B, G, D]).
        """
        queries = point_embedding.to(self.dtype)
        keys = pc_embedding.to(self.dtype)
        pc_pe = pc_pe.to(self.dtype)
        point_embedding = queries
        for layer in self.layers:
            queries, keys = layer(queries, keys, point_embedding, pc_pe,
                                  query_valid=token_valid)
        q = queries + point_embedding
        k = keys + pc_pe
        queries = self.norm_final_attn(queries + self.final_attn_token_to_image(q, k, keys))
        return queries, keys
