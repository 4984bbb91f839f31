"""Segment reductions of the voronoi tokenizer (counterpart of
point_sam_tpu/ops/scatter.py), plain torch.

``scatter_max`` takes each centre's max over the points assigned to it,
the reference's ``torch.scatter_reduce(..., "amax")`` onto a zero-filled
buffer: a centre that receives no point, or only points masked to -inf
(padding), gets 0.
"""

from __future__ import annotations

import torch


def scatter_max(x: torch.Tensor, idx: torch.Tensor, num_segments: int, *,
                fill_value: float = 0.0) -> torch.Tensor:
    """Per-batch segment max of point features onto centres.

    Args:
        x: [B, N, C] features (padded points at -inf never win).
        idx: [B, N] segment (centre) index per point, in [0, num_segments).
        num_segments: L.
        fill_value: the value of a segment with no finite maximum.

    Returns:
        [B, L, C] in x's dtype.
    """
    B, N, C = x.shape
    out = torch.full((B, num_segments, C), float("-inf"), dtype=x.dtype, device=x.device)
    out = out.scatter_reduce(1, idx.long()[..., None].expand(B, N, C), x, "amax")
    return out.masked_fill(torch.isneginf(out), fill_value)


def gather_segments(y: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Per-centre features back to the points: out[b, n] = y[b, idx[b, n]]."""
    return torch.take_along_dim(y, idx.long()[..., None], dim=1)
