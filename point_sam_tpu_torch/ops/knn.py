"""Exact k-nearest-neighbour search (counterpart of point_sam_tpu/ops/knn.py).

Plain torch with exact selection: the distance matrix comes from
``sq_dist`` in fp32 and the selection from ``torch.topk``. Large key sets
are processed in key tiles with a running top-k, so memory stays
O(B * Nq * (k + tile)) whatever Nk is.

The JAX package's ``method="approx"`` (``lax.approx_min_k``, a TPU
primitive) has no counterpart yet; its Hopper kernel is queued in
ROADMAP.md ("approx-kNN kernel").

Padding contract: ``key_valid`` marks real keys; padded keys get +inf
distance and are never selected while k real keys exist.
"""

from __future__ import annotations

import torch

from .distance import sq_dist

_INF = float("inf")
# Above this many distance-matrix elements per call, tile the query axis
# in the small-k path (bounds the [tile, Nk] matrix).
_SINGLE_SHOT_MAX_ELEMENTS = 1 << 29


def _mask_invalid(d2: torch.Tensor, key_valid: torch.Tensor | None) -> torch.Tensor:
    if key_valid is None:
        return d2
    return d2.masked_fill(~key_valid[..., None, :], _INF)


def _dense_knn(query, key, k, key_valid):
    d2 = _mask_invalid(sq_dist(query, key), key_valid)
    d, idx = torch.topk(d2, k, dim=-1, largest=False, sorted=True)
    return d, idx.int()


def _tiled_knn(query, key, k, key_valid, key_tile):
    """Key-tiled running top-k: each tile's distances are merged with the
    best k so far and re-selected."""
    nk = key.shape[-2]
    best_d = best_i = None
    for start in range(0, nk, key_tile):
        stop = min(start + key_tile, nk)
        kv = key_valid[..., start:stop] if key_valid is not None else None
        d2 = _mask_invalid(sq_dist(query, key[..., start:stop, :]), kv)
        idx = torch.arange(start, stop, device=key.device, dtype=torch.int32)
        idx = idx.expand(d2.shape)
        if best_d is not None:
            d2 = torch.cat([best_d, d2], dim=-1)
            idx = torch.cat([best_i, idx], dim=-1)
        best_d, sel = torch.topk(d2, min(k, d2.shape[-1]), dim=-1,
                                 largest=False, sorted=True)
        best_i = torch.gather(idx, -1, sel)
    return best_d, best_i


def _small_k_single(query, key, k, key_valid):
    d2 = _mask_invalid(sq_dist(query, key), key_valid)
    ds, idxs = [], []
    for _ in range(k):
        d, i = d2.min(dim=-1)  # first index among equal minima
        ds.append(d)
        idxs.append(i.int())
        d2 = d2.scatter(-1, i[..., None], _INF)
    return torch.stack(ds, -1), torch.stack(idxs, -1)


def _small_k_knn(query, key, k, key_valid, *, query_tile: int = 8192):
    """k-NN by k successive masked min-extractions (tiny k: 3-NN interp
    weights, 1-NN voronoi assignment)."""
    nq, nk = query.shape[-2], key.shape[-2]
    if nq * nk <= _SINGLE_SHOT_MAX_ELEMENTS:
        return _small_k_single(query, key, k, key_valid)
    parts = [
        _small_k_single(query[..., s:s + query_tile, :], key, k, key_valid)
        for s in range(0, nq, query_tile)
    ]
    return (torch.cat([p[0] for p in parts], dim=-2),
            torch.cat([p[1] for p in parts], dim=-2))


def knn(
    query: torch.Tensor,
    key: torch.Tensor,
    k: int,
    *,
    key_valid: torch.Tensor | None = None,
    key_tile: int = 4096,
    dense_max: int = 8192,
    method: str = "auto",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Find the k nearest keys for each query point.

    Args:
        query: [B, Nq, D] float coordinates.
        key: [B, Nk, D] float coordinates.
        k: number of neighbours.
        key_valid: optional [B, Nk] bool; False entries are never selected.
        key_tile: key-axis tile of the blocked exact path.
        dense_max: up to this Nk the distance matrix is built in one shot.
        method: "auto" | "exact" | "small_k". auto picks small_k for
            k <= 4 and exact otherwise.

    Returns:
        (sq_dists [B, Nq, k], indices [B, Nq, k] int32), ascending.
    """
    nk = key.shape[-2]
    if k > nk:
        raise ValueError(f"k={k} exceeds number of keys {nk}")
    if method == "approx":
        raise NotImplementedError(
            "knn(method='approx') has no port yet: see ROADMAP.md, "
            "'approx-kNN kernel' in the kernel queue"
        )
    if method == "auto":
        method = "small_k" if k <= 4 else "exact"
    if method == "small_k":
        return _small_k_knn(query, key, k, key_valid)
    if method != "exact":
        raise ValueError(f"unknown knn method {method!r}")
    if nk <= dense_max or nk <= key_tile:
        return _dense_knn(query, key, k, key_valid)
    return _tiled_knn(query, key, k, key_valid, key_tile)
