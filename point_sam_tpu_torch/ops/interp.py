"""3-NN inverse-square-distance interpolation (counterpart of
point_sam_tpu/ops/interp.py).

``compute_interp_weights`` is the JAX function's k=3, unmasked case, the
only one the port calls: kernel K10 on a CUDA tensor, its plain version on
a CPU tensor (``ops/interp_pallas.py``). Both rank by the Pallas kernel's
explicit-difference distances, as the JAX package does on the TPU; off the
TPU it takes its kNN expansion instead, which agrees with them wherever no
two keys are within fp32 rounding of a tie.
"""

from __future__ import annotations

import torch

from .group import batch_index_select
from .interp_pallas import interp_weights_cuda, interp_weights_plain


def compute_interp_weights(query: torch.Tensor, key: torch.Tensor,
                           eps: float = 1e-8) -> tuple[torch.Tensor, torch.Tensor]:
    """Weights 1 / max(d^2, eps) over the 3 nearest keys, normalised.

    Returns:
        (indices [B, Nq, 3] int32, weights [B, Nq, 3] f32).
    """
    if query.is_cuda:
        return interp_weights_cuda(query, key, eps=eps)
    return interp_weights_plain(query, key, eps=eps)


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
