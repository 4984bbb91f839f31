"""Experimental mask-upscaling ("propagate") variants (counterpart of
point_sam_tpu/models/decoder_variants.py).

The reference's experimental decoder family (pc_sam/model/decoder/*.py),
standalone modules that no config wires in. Each maps the decoder's
centre tokens back to the points:

    propagate(xyz [B, N, 3], rgb [B, N, C], centers [B, L, 3],
              center_feats [B, L, D]) -> [B, N, D]

- ``Propagate``: a learned relative-position MLP blended with the
  inverse-square-distance 3-NN interpolation, then a residual MLP on the
  colours (reference decoder/mask_decoder.py:37-97).
- ``PropagateAttn``: attention over the 3 nearest centres with
  MLP-embedded query / key positions (reference
  decoder/mask_decoder_trm.py:38-90).
- ``PropagateNN``: the voronoi 1-NN gather plus a random-Fourier encoding
  of the direction to the centre, through a residual MLP (reference
  decoder/mask_decoder_voronoi.py:65-106).
- ``PatchDropout``: a random keep of tokens by the top-k of normal noise
  (reference pc_encoder.py:44-81).

The numerics are JAX's: the 3-NN weights are ``1 / (d^2 + eps)``
normalised, over ``ops.knn(xyz, centers, 3)`` (the plain small-k search on
every device; kernel K10 clamps ``1 / max(d^2, eps)``, another formula),
and ``PropagateAttn``'s logits are fp32, scaled by ``1 / sqrt(64)``.

``nbrs``: each variant's forward takes an optional precomputed (d^2, idx)
of ``ops.knn(xyz, centers, 3)`` (``PropagateNN``: of ``ops.nn1(xyz,
centers)``); the output is bit-identical with or without it. It lets
several variants share one search, and a check hold one device's module
to another's on the same neighbours: the 1 / (d^2 + eps) weights amplify
the rounding of the d^2 expansion (~1e-7 absolute) on each device.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ..ops import batch_index_select, knn, nn1
from .layers import GELU, MLP, Dense, LayerNorm, PointNetLayer, normal_


def _knn3_weights(xyz, centers, nbrs=None, eps=1e-8):
    d2, idx = knn(xyz, centers, 3) if nbrs is None else nbrs
    recip = 1.0 / (d2 + eps)
    return idx, recip / recip.sum(-1, keepdim=True)


class Propagate(nn.Module):
    """(reference decoder/mask_decoder.py:37-97). ``relative_mlp``, ``mlp``
    and ``fc`` are Dense-LN-GELU-Dense blocks; ``rgb_dim`` is C."""

    def __init__(self, feats_dim: int, hidden_dim: int = 128, *, rgb_dim: int = 3,
                 dtype=torch.float32, device=None, generator=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device, generator=generator)
        self.relative_mlp = PointNetLayer(3, hidden_dim, feats_dim, **kw)
        self.mlp = PointNetLayer(feats_dim + rgb_dim, hidden_dim, feats_dim, **kw)
        self.fc = PointNetLayer(feats_dim, hidden_dim, feats_dim, **kw)

    def forward(self, xyz, rgb, centers, center_feats, nbrs=None):
        idx, weight = _knn3_weights(xyz, centers, nbrs)
        rela_xyz = batch_index_select(centers, idx) - xyz[:, :, None, :]
        rela_feats = self.relative_mlp(rela_xyz)  # [B, N, 3, D]
        rela_feats = torch.einsum("bnkd,bnk->bnd", rela_feats, weight.to(rela_feats.dtype))
        nbr_feats = batch_index_select(center_feats, idx)  # [B, N, 3, D]
        interp = torch.einsum("bnkd,bnk->bnd", nbr_feats, weight.to(nbr_feats.dtype))
        skip = rela_feats + interp
        x = self.mlp(torch.cat([skip, rgb.to(skip.dtype)], dim=-1))
        return self.fc(skip + x)


class PropagateAttn(nn.Module):
    """(reference decoder/mask_decoder_trm.py:38-90). ``q_mlp`` / ``k_mlp``:
    3-layer ReLU MLPs 3 -> 64; ``mlp``: Dense-LN-GELU-Dense."""

    def __init__(self, feats_dim: int, hidden_dim: int = 128, *, dtype=torch.float32,
                 device=None, generator=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device, generator=generator)
        self.dtype = dtype
        self.q_mlp = MLP(3, 64, 64, 3, **kw)
        self.k_mlp = MLP(3, 64, 64, 3, **kw)
        self.mlp = PointNetLayer(feats_dim + 3, hidden_dim, feats_dim, **kw)

    def forward(self, xyz, rgb, centers, center_feats, nbrs=None):
        idx = (knn(xyz, centers, 3) if nbrs is None else nbrs)[1]
        keys = batch_index_select(centers, idx)  # [B, N, 3, 3]
        values = batch_index_select(center_feats, idx)  # [B, N, 3, D]
        q = self.q_mlp(xyz[:, :, None, :].to(self.dtype))  # [B, N, 1, 64]
        k = self.k_mlp(keys.to(self.dtype))  # [B, N, 3, 64]
        # The products of bf16 values are exact in fp32: fp32 logits.
        logits = torch.einsum("bnqe,bnke->bnqk", q.float(), k.float())
        logits = logits / math.sqrt(q.shape[-1])
        w = torch.softmax(logits, dim=-1)[:, :, 0, :]  # [B, N, 3]
        attended = torch.einsum("bnkd,bnk->bnd", values, w.to(values.dtype))
        return self.mlp(torch.cat([attended, xyz.to(attended.dtype)], dim=-1))


class PropagateNN(nn.Module):
    """(reference decoder/mask_decoder_voronoi.py:65-106). The buffer
    ``gaussian_matrix`` [3, feats_dim // 2] is drawn N(0, 1) from
    ``generator``; the residual MLP is ``res_in`` / ``res_in_norm``,
    ``res_{i}`` / ``res_{i}_norm`` and ``res_out``."""

    def __init__(self, feats_dim: int, hidden_dim: int = 128, num_res_layers: int = 3, *,
                 dtype=torch.float32, device=None, generator=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device, generator=generator)
        self.dtype = dtype
        self.num_res_layers = num_res_layers
        mat = torch.empty((3, feats_dim // 2), dtype=torch.float32, device=device)
        self.register_buffer("gaussian_matrix", normal_(mat, 1.0, generator))
        self.res_in = Dense(feats_dim, hidden_dim, **kw)
        self.res_in_norm = LayerNorm(hidden_dim, dtype=dtype, device=device)
        for i in range(num_res_layers):
            self.add_module(f"res_{i}", Dense(hidden_dim, hidden_dim, **kw))
            self.add_module(f"res_{i}_norm", LayerNorm(hidden_dim, dtype=dtype, device=device))
        self.res_out = Dense(hidden_dim, feats_dim, **kw)
        self.act = GELU()

    def forward(self, xyz, rgb, centers, center_feats, nbrs=None):
        idx = (nn1(xyz, centers) if nbrs is None else nbrs)[1]  # [B, N]
        feats = batch_index_select(center_feats, idx)  # [B, N, D]
        nbr = xyz - batch_index_select(centers, idx)
        dist = torch.linalg.vector_norm(nbr, dim=-1, keepdim=True)
        unit = nbr / (dist + 1e-8)
        pe = (unit.float() @ self.gaussian_matrix) * (2.0 * math.pi)
        pe = torch.cat([torch.sin(pe), torch.cos(pe)], dim=-1)
        x = feats + pe.to(feats.dtype)
        h = self.act(self.res_in_norm(self.res_in(x)))
        for i in range(self.num_res_layers):
            r = getattr(self, f"res_{i}_norm")(getattr(self, f"res_{i}")(h))
            h = h + self.act(r)
        return self.res_out(h)


class PatchDropout(nn.Module):
    """Random token keep (reference pc_encoder.py:44-81, switched off there:
    it does not fit the decoder's centre-aligned upscaling). Fixed shape:
    ``max(1, int(L * (1 - prob)))`` body tokens, by the top-k of normal
    noise drawn from ``generator`` on the tokens' device; the
    ``num_prefix_tokens`` leading tokens are kept in front."""

    def __init__(self, prob: float, num_prefix_tokens: int = 0):
        super().__init__()
        self.prob = prob
        self.num_prefix_tokens = num_prefix_tokens

    def forward(self, x: torch.Tensor, *, deterministic: bool = True,
                generator: torch.Generator | None = None):
        """x [B, P + L, D] -> (kept [B, P + keep, D], body indices [B, keep]
        int64, in the noise's descending order), or (x, None) when
        ``deterministic`` or ``prob`` is 0."""
        if deterministic or self.prob == 0.0:
            return x, None
        if generator is None:
            raise ValueError("PatchDropout needs a generator unless deterministic")
        p = self.num_prefix_tokens
        prefix, body = x[:, :p], x[:, p:]
        B, L = body.shape[:2]
        num_keep = max(1, int(L * (1.0 - self.prob)))
        noise = torch.randn((B, L), generator=generator, device=x.device)
        keep = torch.topk(noise, num_keep, dim=-1).indices
        kept = batch_index_select(body, keep)
        if p:
            kept = torch.cat([prefix, kept], dim=1)
        return kept, keep
