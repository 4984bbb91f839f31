"""Click simulator for training and evaluation (counterpart of
point_sam_tpu/ops/sampler.py). Plain torch, on the device of its inputs.

The new click of each (cloud, mask) is the point of the error region that
lies farthest from the region's border, the border distance being the
squared distance to the nearest point of the region's complement:

- first click (no previous logits): the region is the GT mask, label 1;
- later clicks: the deepest point of the false-negative region (positive
  click) and of the false-positive region (negative click), whichever is
  deeper; if neither exists, the GT mask's deepest point.

``sample_prompts_random`` draws a uniform point of the error region
instead (the reference's random sampler), from an explicit generator.
"""

from __future__ import annotations

import torch

from .distance import sq_dist

_INF = float("inf")
# Tile of the complement (key) axis: the temporary stays [B, N, 2048].
_KEY_TILE = 2048


def min_sq_dist_to_complement(coords: torch.Tensor, regions: torch.Tensor, *,
                              point_valid: torch.Tensor | None = None) -> torch.Tensor:
    """For every point, the min squared distance to the region's complement.

    Args:
        coords: [B, N, 3] fp32. regions: [B, R, N] bool.
        point_valid: optional [B, N] bool; invalid points belong to neither
            region nor complement.

    Returns:
        [B, R, N] fp32, +inf where the complement is empty.
    """
    B, N, _ = coords.shape
    comp = ~regions
    if point_valid is not None:
        comp = comp & point_valid[:, None, :]
    dmin = torch.full(regions.shape, _INF, dtype=torch.float32, device=coords.device)
    for k0 in range(0, N, _KEY_TILE):
        d2 = sq_dist(coords, coords[:, k0:k0 + _KEY_TILE])  # [B, N, tile]
        penal = torch.where(comp[:, :, k0:k0 + _KEY_TILE], 0.0, _INF)  # [B, R, tile]
        # One region at a time keeps the temporary at [B, N, tile].
        tile_min = torch.stack([(d2 + penal[:, r, None, :]).amin(-1)
                                for r in range(regions.shape[1])], dim=1)
        dmin = torch.minimum(dmin, tile_min)
    return dmin


def _farthest_in_region(dmin_row: torch.Tensor, region: torch.Tensor):
    """Masked argmax of the border distance within a region: (score, idx),
    score -inf when the region or its complement is empty."""
    masked = torch.where(region, dmin_row, -_INF)
    idx = masked.argmax(-1)
    score = masked.amax(-1)
    return torch.where(torch.isfinite(score), score, -_INF), idx


def _gather_clicks(coords, gt_masks, sel_idx):
    """(prompt_coords [B*M, 1, 3], prompt_labels [B*M, 1] bool) at sel_idx [B*M]."""
    B, M, N = gt_masks.shape
    coords_bm = torch.repeat_interleave(coords, M, dim=0)
    pc = torch.take_along_dim(coords_bm, sel_idx[:, None, None], dim=1)
    pl = torch.take_along_dim(gt_masks.reshape(B * M, N), sel_idx[:, None], dim=1)
    return pc, pl


@torch.no_grad()
def sample_prompts(coords: torch.Tensor, gt_masks: torch.Tensor,
                   pred_logits: torch.Tensor | None = None, *,
                   point_valid: torch.Tensor | None = None):
    """One new click per (cloud, mask), farthest-from-border rule.

    Args:
        coords: [B, N, 3] fp32. gt_masks: [B, M, N] bool.
        pred_logits: optional [B*M, N] previous mask logits (prediction =
            logits > 0).
        point_valid: optional [B, N] bool padding mask.

    Returns:
        (prompt_coords [B*M, 1, 3], prompt_labels [B*M, 1] bool).
    """
    B, M, N = gt_masks.shape
    if pred_logits is None:
        dmin = min_sq_dist_to_complement(coords, gt_masks, point_valid=point_valid)
        _, sel_idx = _farthest_in_region(dmin.reshape(B * M, N), gt_masks.reshape(B * M, N))
        return _gather_clicks(coords, gt_masks, sel_idx)
    pred = pred_logits.reshape(B, M, N) > 0
    fn = gt_masks & ~pred
    fp = ~gt_masks & pred
    gt_eff = gt_masks
    if point_valid is not None:
        pv = point_valid[:, None, :]
        fn, fp, gt_eff = fn & pv, fp & pv, gt_masks & pv
    regions = torch.cat([fn, fp, gt_eff], dim=1)  # [B, 3M, N]
    dmin = min_sq_dist_to_complement(coords, regions, point_valid=point_valid)
    flat = lambda t: t.reshape(B * M, N)  # noqa: E731
    d_fn, d_fp, d_gt = dmin.split(M, dim=1)
    p_score, p_idx = _farthest_in_region(flat(d_fn), flat(fn))
    n_score, n_idx = _farthest_in_region(flat(d_fp), flat(fp))
    _, g_idx = _farthest_in_region(flat(d_gt), flat(gt_eff))
    # pdist > ndist -> positive; elif no negative candidate -> GT; else negative.
    sel_idx = torch.where(p_score > n_score, p_idx,
                          torch.where(torch.isneginf(n_score), g_idx, n_idx))
    return _gather_clicks(coords, gt_masks, sel_idx)


@torch.no_grad()
def sample_prompts_random(generator: torch.Generator, coords: torch.Tensor,
                          gt_masks: torch.Tensor, pred_logits: torch.Tensor | None = None,
                          *, point_valid: torch.Tensor | None = None):
    """A uniform-random click in the error region (the GT mask when the
    error region is empty), via a masked argmax over Gumbel noise drawn
    from ``generator``. Same returns as ``sample_prompts``."""
    B, M, N = gt_masks.shape
    diff = gt_masks if pred_logits is None else gt_masks != (pred_logits.reshape(B, M, N) > 0)
    gt_eff = gt_masks
    if point_valid is not None:
        pv = point_valid[:, None, :]
        diff, gt_eff = diff & pv, gt_masks & pv
    empty = ~diff.any(-1, keepdim=True)
    diff = torch.where(empty, gt_eff, diff)
    u = torch.rand((B, M, N), generator=generator, device=coords.device).clamp_min(1e-20)
    noise = -torch.log(-torch.log(u))
    sel_idx = torch.where(diff, noise, -_INF).argmax(-1).reshape(B * M)
    return _gather_clicks(coords, gt_masks, sel_idx)
