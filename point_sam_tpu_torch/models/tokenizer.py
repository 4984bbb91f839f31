"""Point-cloud tokenizer geometry (counterpart of point_sam_tpu/models/tokenizer.py).

Pure functions of the coordinates: FPS centres, per-centre kNN indices and
the per-point 3-NN interpolation weights, computed once per cloud and
reused by every decode. ``point_valid`` padding masks let one bucket size
serve any N up to it.
"""

from __future__ import annotations

import dataclasses

import torch

from ..ops import batch_index_select, fps, fps_with_interp, knn


@dataclasses.dataclass(frozen=True)
class TokenizerConfig:
    """Grouping hyperparameters (reference configs/model/*.yaml:6-9).

    ``knn_method``: "auto" / "exact" select the exact search; "approx" is
    not ported yet (ROADMAP.md, approx-kNN kernel). ``fps_candidates``
    (approximate FPS) is not ported; None is exact FPS.
    """

    num_patches: int = 512
    patch_size: int = 64
    radius: float | None = None
    centralize_features: bool = False
    knn_method: str = "auto"
    fps_candidates: int | None = None


@torch.no_grad()
def compute_geometry(
    coords: torch.Tensor,
    cfg: TokenizerConfig,
    *,
    point_valid: torch.Tensor | None = None,
    with_interp: bool = True,
) -> dict:
    """FPS centres + per-centre kNN + (optionally) 3-NN interp weights.

    Returns dict(fps_idx [B,G], centers [B,G,3], knn_idx [B,G,K],
                 interp_index [B,N,3], interp_weight [B,N,3]).
    """
    coords = coords.float()
    if with_interp:
        fps_idx, centers, idx, w = fps_with_interp(
            coords, cfg.num_patches, valid=point_valid,
            candidates=cfg.fps_candidates, with_centers=True)
    else:
        if cfg.fps_candidates is not None:
            raise NotImplementedError("approximate FPS is not ported")
        fps_idx = fps(coords, cfg.num_patches, valid=point_valid)
        centers = batch_index_select(coords, fps_idx, axis=1)
    _, knn_idx = knn(centers, coords, cfg.patch_size, key_valid=point_valid,
                     method=cfg.knn_method)
    out = dict(fps_idx=fps_idx, centers=centers, knn_idx=knn_idx)
    if with_interp:
        out["interp_index"], out["interp_weight"] = idx, w
    return out
