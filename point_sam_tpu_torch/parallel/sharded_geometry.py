"""Point-axis-sharded geometry over the ranks of a process group
(counterpart of point_sam_tpu/parallel/sharded_geometry.py).

The kNN against a cloud and the click simulator's border distances are
parallel over keys: each rank holds a shard of the points, computes its
local result, and one small collective merges the shards (an all-gather
of k candidates, or of each rank's distances). FPS stays replicated (it
is sequential over the whole cloud).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..ops.distance import sq_dist
from ..ops.knn import knn


def _all_gather_last(t: torch.Tensor, group) -> torch.Tensor:
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts, dim=-1)


def sharded_knn(query: torch.Tensor, key_local: torch.Tensor, k: int, *, group=None,
                method: str = "auto", recall_target: float = 0.95,
                key_valid: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """kNN with the key cloud split over the ranks of ``group``.

    Args:
        query: [B, Nq, 3], the same on every rank.
        key_local: [B, Nk / W, 3], this rank's contiguous shard of the keys
            (rank r holds keys [r * Nk / W, (r + 1) * Nk / W)).
        k: neighbours per query.
        key_valid: optional [B, Nk / W] bool, sharded as the keys; padded
            keys never win while k real keys exist.

    Each rank searches its shard (``ops.knn``: K12 on the card), offsets
    its indices to global ones, and one all-gather each of distances and
    indices brings every shard's k candidates; their merge keeps the k
    smallest, equal distances to the smaller global index (the earlier
    shard, then the shard's own order), as JAX's ``lax.top_k`` merge does.

    Returns: (sq_dists [B, Nq, k], global indices [B, Nq, k] int32), the
    same on every rank.
    """
    d, i = knn(query, key_local, k, method=method, recall_target=recall_target,
               key_valid=key_valid)
    i = i + dist.get_rank(group) * key_local.shape[1]
    d_all = _all_gather_last(d, group)
    i_all = _all_gather_last(i, group)
    sel = torch.sort(d_all, dim=-1, stable=True).indices[..., :k]
    return torch.take_along_dim(d_all, sel, dim=-1), torch.take_along_dim(i_all, sel, dim=-1)


def sharded_min_sq_dist_to_complement(coords_local: torch.Tensor, regions_local: torch.Tensor,
                                      coords_full: torch.Tensor, regions_full: torch.Tensor,
                                      *, group=None) -> torch.Tensor:
    """The click simulator's border distances with the query points split
    over the ranks: for each of this rank's points, the smallest squared
    distance to the complement of each region over the FULL cloud; the
    ranks' results are all-gathered along the point axis.

    Args:
        coords_local: [B, N / W, 3], this rank's contiguous shard of points.
        regions_local: [B, R, N / W], its regions (JAX's signature; the
            distances need only the full regions).
        coords_full: [B, N, 3]; regions_full: [B, R, N] bool.

    Returns: [B, R, N] fp32, the same on every rank.
    """
    del regions_local
    d2 = sq_dist(coords_local, coords_full)  # [B, n, N]
    comp = ~regions_full
    out = torch.stack([d2.masked_fill(~comp[:, r, None, :], float("inf")).amin(-1)
                       for r in range(regions_full.shape[1])], dim=1)  # [B, R, n]
    return _all_gather_last(out, group)
