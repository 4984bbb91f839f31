"""Point-cloud tokenizer geometry (counterpart of point_sam_tpu/models/tokenizer.py).

Pure functions of the coordinates: FPS centres, per-centre kNN indices
(kNN tokenizer), each point's nearest centre (voronoi tokenizer) or two
levels of centres and neighbours (hier tokenizer), and the per-point 3-NN
interpolation weights, computed once per cloud and reused by every decode.
``point_valid`` padding masks let one bucket size serve any N up to it.
"""

from __future__ import annotations

import dataclasses

import torch

from ..ops import (
    batch_index_select,
    compute_interp_weights,
    fps,
    fps_with_interp,
    fps_with_interp_knn,
    knn,
    nn1,
)


@dataclasses.dataclass(frozen=True)
class TokenizerConfig:
    """Grouping hyperparameters (reference configs/model/*.yaml:6-9).

    ``knn_method``: "auto" / "exact" select the exact search (kernel K12
    on the card). "approx" selects the fused geometry (kernel K9: FPS,
    interp and a binned kNN of expected recall ~0.97 at K=256 from one
    pass) where its gate holds (``ops.fps.fused_geometry_ok``, which asks
    for ``knn_recall_target <= 0.93``); elsewhere FPS and interp (K1) and
    the approximate search (``knn(method="approx")``: K12 over the bins
    XLA's ``approx_min_k`` would use at ``knn_recall_target``).
    ``fps_candidates``: approximate FPS, the centres selected from a strided
    subset of this many points (``ops.fps(candidates=)``); None is exact FPS.
    ``knn_recall_target``: the approximate search's recall target (JAX's
    default 0.9, the evaluator's operating point).
    """

    num_patches: int = 512
    patch_size: int = 64
    radius: float | None = None
    centralize_features: bool = False
    knn_method: str = "auto"
    fps_candidates: int | None = None
    knn_recall_target: float = 0.9


@dataclasses.dataclass(frozen=True)
class HierTokenizerConfig:
    """Two-level grouping (reference configs/model/hier.yaml): (G1, G2)
    centres of (K1, K2) neighbours, with a radius per level."""

    num_patches: tuple[int, int] = (2048, 512)
    patch_size: tuple[int, int] = (32, 32)
    radius: tuple[float, float] | None = None


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
        if cfg.fps_candidates is None and cfg.knn_method == "approx":
            # FPS, centres, 3-NN interp and the tokenizer kNN from one pass
            # (kernel K9) where its gate holds; None otherwise.
            fused = fps_with_interp_knn(coords, cfg.num_patches, cfg.patch_size,
                                        valid=point_valid, recall_target=cfg.knn_recall_target)
            if fused is not None:
                fps_idx, centers, idx, w, knn_idx = fused
                return dict(fps_idx=fps_idx, centers=centers, knn_idx=knn_idx,
                            interp_index=idx, interp_weight=w)
        fps_idx, centers, idx, w = fps_with_interp(
            coords, cfg.num_patches, valid=point_valid,
            candidates=cfg.fps_candidates, with_centers=True)
    else:
        fps_idx = fps(coords, cfg.num_patches, valid=point_valid, candidates=cfg.fps_candidates)
        centers = batch_index_select(coords, fps_idx, axis=1)
    _, knn_idx = knn(centers, coords, cfg.patch_size, key_valid=point_valid,
                     method=cfg.knn_method, recall_target=cfg.knn_recall_target)
    out = dict(fps_idx=fps_idx, centers=centers, knn_idx=knn_idx)
    if with_interp:
        out["interp_index"], out["interp_weight"] = idx, w
    return out


@torch.no_grad()
def compute_geometry_voronoi(
    coords: torch.Tensor,
    num_patches: int,
    *,
    point_valid: torch.Tensor | None = None,
    with_interp: bool = True,
) -> dict:
    """FPS centres (kernel K8 on the card) + each point's nearest centre
    (reference NNGrouper, common.py:198-201) + (optionally) the 3-NN interp
    weights (kernel K10 on the card).

    Returns dict(fps_idx [B,G], centers [B,G,3], nn_idx [B,N],
                 point_valid [B,N] or None, interp_index [B,N,3],
                 interp_weight [B,N,3]); point_valid rides along so the
    segment-max consumers can keep padded points out of the per-centre max.
    """
    coords = coords.float()
    fps_idx = fps(coords, num_patches, valid=point_valid)
    centers = batch_index_select(coords, fps_idx, axis=1)
    _, nn_idx = nn1(coords, centers)
    out = dict(fps_idx=fps_idx, centers=centers, nn_idx=nn_idx, point_valid=point_valid)
    if with_interp:
        out["interp_index"], out["interp_weight"] = compute_interp_weights(coords, centers)
    return out


@torch.no_grad()
def compute_geometry_hier(
    coords: torch.Tensor,
    cfg: HierTokenizerConfig,
    *,
    point_valid: torch.Tensor | None = None,
) -> dict:
    """Two-level geometry (reference PatchEmbedHier, pc_encoder.py:230-238):
    level 1 groups the cloud around G1 FPS centres (kernel K8 on the card);
    level 2 groups the level-1 centres around the first G2 of them (no
    FPS). Both kNNs are exact (kernel K12 on the card). The 3-NN interp
    weights (kernel K10 on the card) go from the points to the level-1
    centres and from the level-1 to the level-2 centres.

    Returns dict(fps_idx1 [B,G1], centers1 [B,G1,3], knn_idx1 [B,G1,K1],
                 centers2 [B,G2,3], knn_idx2 [B,G2,K2], centers (= centers2),
                 interp_index [B,N,3], interp_weight [B,N,3],
                 interp_index_21 [B,G1,3], interp_weight_21 [B,G1,3]).
    """
    coords = coords.float()
    g1, g2 = cfg.num_patches
    k1, k2 = cfg.patch_size
    fps_idx1 = fps(coords, g1, valid=point_valid)
    centers1 = batch_index_select(coords, fps_idx1, axis=1)
    _, knn_idx1 = knn(centers1, coords, k1, key_valid=point_valid)
    centers2 = centers1[:, :g2]
    _, knn_idx2 = knn(centers2, centers1, k2)
    idx21, w21 = compute_interp_weights(centers1, centers2)
    idx, w = compute_interp_weights(coords, centers1)
    return dict(fps_idx1=fps_idx1, centers1=centers1, knn_idx1=knn_idx1, centers2=centers2,
                knn_idx2=knn_idx2, centers=centers2, interp_index=idx, interp_weight=w,
                interp_index_21=idx21, interp_weight_21=w21)
