"""3-NN interpolation weights (counterpart of point_sam_tpu/ops/interp_pallas.py).

For every query point, its 3 nearest keys and the weights 1 / max(d^2, eps)
normalised over the three: kernel K10 (``interp_weights_cuda``,
``csrc/interp.cu``, replacing ``interp_weights_pallas``), which
``ops.interp.compute_interp_weights`` launches on CUDA tensors (its scan,
``csrc/nn3.cuh``, is also K1's 3-NN launch), and its plain torch version
``interp_weights_plain``.

Distances are the explicit per-coordinate differences of the Pallas
kernel, not the |q|^2 - 2qk + |k|^2 expansion of ``knn``: with 3
coordinates the expansion saves nothing and cancels for near neighbours,
the ones being ranked. Their fp32 bits are XLA's (``fps.fma_sq_norm``), so
the indices equal the reference kernel's; ties go to the smaller key index.
"""

from __future__ import annotations

import torch

from . import _cuda
from .fps import fma_sq_norm

# Queries per block of the plain version (bounds its [tile, G] matrices).
_QUERY_TILE = 4096


def interp_weights_plain(query: torch.Tensor, key: torch.Tensor, *, eps: float = 1e-8):
    """Plain torch version of kernel K10.

    Args:
        query: [B, N, 3]. key: [B, G, 3] with G >= 3 (computed in fp32).

    Returns:
        (idx [B, N, 3] int32, weight [B, N, 3] f32).
    """
    query, key = query.float(), key.float()
    idxs, ds = [], []
    for s in range(0, query.shape[1], _QUERY_TILE):
        d2 = fma_sq_norm(query[:, s:s + _QUERY_TILE, None, :] - key[:, None, :, :])
        tile_d, tile_i = [], []
        for j in range(3):  # masked extractions: first index among equal minima
            d, i = d2.min(dim=-1)
            tile_d.append(d)
            tile_i.append(i.int())
            if j < 2:
                d2 = d2.scatter(-1, i[..., None], float("inf"))
        ds.append(torch.stack(tile_d, -1))
        idxs.append(torch.stack(tile_i, -1))
    inv = 1.0 / torch.clamp_min(torch.cat(ds, 1), eps)
    return torch.cat(idxs, 1), inv / inv.sum(-1, keepdim=True)


@_cuda.counted
def interp_weights_cuda(query: torch.Tensor, key: torch.Tensor, *, eps: float = 1e-8):
    """Kernel K10 on the card; same result as ``interp_weights_plain``."""
    query, key = query.float().contiguous(), key.float().contiguous()
    _cuda.require_cuda(query, key)
    B, N, _ = query.shape
    G = key.shape[1]
    if key.shape[0] != B or not 3 <= G <= 16384:
        raise ValueError(f"K10 takes [B, N, 3] queries and [B, 3..16384, 3] keys, "
                         f"got {tuple(query.shape)} and {tuple(key.shape)}")
    idx = torch.empty((B, N, 3), dtype=torch.int32, device=query.device)
    weight = torch.empty((B, N, 3), dtype=torch.float32, device=query.device)
    code = _cuda.library().psam_interp_weights(
        _cuda.ptr(query), _cuda.ptr(key), B, N, G, eps, _cuda.ptr(idx), _cuda.ptr(weight),
        _cuda.stream())
    _cuda.check("psam_interp_weights", code)
    _cuda.count_launch(interp_weights_cuda, B=B, N=N, G=G)
    return idx, weight
