"""3-NN inverse-square-distance interpolation (counterpart of
point_sam_tpu/ops/interp.py). Plain torch."""

from __future__ import annotations

import torch

from .group import batch_index_select
from .knn import knn


def compute_interp_weights(
    query: torch.Tensor,
    key: torch.Tensor,
    k: int = 3,
    eps: float = 1e-8,
    *,
    key_valid: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Weights 1 / max(d^2, eps) over the k nearest keys, normalised.

    Returns:
        (indices [B, Nq, k] int32, weights [B, Nq, k]).
    """
    d2, idx = knn(query, key, k, key_valid=key_valid)
    inv = 1.0 / torch.clamp_min(d2, eps)
    return idx, inv / inv.sum(-1, keepdim=True)


def interpolate_features(x: torch.Tensor, index: torch.Tensor,
                         weight: torch.Tensor) -> torch.Tensor:
    """out[b, n] = sum_k w[b, n, k] * x[b, index[b, n, k]].

    Args:
        x: [B, L, C]. index: [B, Nq, K]. weight: [B, Nq, K].

    Returns:
        [B, Nq, C].
    """
    gathered = batch_index_select(x, index, axis=1)  # [B, Nq, K, C]
    return torch.einsum("bnkc,bnk->bnc", gathered, weight.to(gathered.dtype))


def interpolate_features_repeated(x: torch.Tensor, index: torch.Tensor,
                                  weight: torch.Tensor) -> torch.Tensor:
    """Like ``interpolate_features`` with x [B*M, L, C] and [B, Nq, K]
    geometry shared by the M replicas (folded into channels, gathered once).
    """
    B = index.shape[0]
    repeats = x.shape[0] // B
    if repeats == 1:
        return interpolate_features(x, index, weight)
    L, C = x.shape[1:]
    x_ch = x.reshape(B, repeats, L, C).transpose(1, 2).reshape(B, L, repeats * C)
    out = interpolate_features(x_ch, index, weight)  # [B, Nq, M*C]
    nq = out.shape[1]
    return out.reshape(B, nq, repeats, C).transpose(1, 2).reshape(B * repeats, nq, C)
