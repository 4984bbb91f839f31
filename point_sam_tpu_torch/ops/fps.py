"""Farthest point sampling (counterpart of point_sam_tpu/ops/fps.py).

``fps`` has the semantics of the JAX ``fps_xla``: iterative farthest-point
selection over fp32 coordinates from the first valid point; padded points
sit at -inf and are never selected; ties go to the smallest index. On a
CUDA tensor it launches kernel K8 (``csrc/fps_interp.cu`` in its
selection-only mode, replacing ``ops/fps_pallas.py::fps_pallas``); on a
CPU tensor it runs ``fps_plain``, the same loop step by step in torch.

``fps_with_interp`` also returns the selected centres and, for every
point, its 3 nearest centres with normalised inverse-square-distance
weights. On a CUDA tensor it launches kernel K1 (``csrc/fps_interp.cu``,
replacing ``ops/fps_pallas.py::fps_interp_pallas``); on a CPU tensor it
runs ``fps_interp_plain``, the same computation step by step in torch.
With ``candidates`` (approximate FPS) the selection runs on a strided
subset of the cloud (K8 on the card), and ``fps_with_interp`` then takes
the 3-NN weights from ``compute_interp_weights`` (K10), as JAX does.

K1 and K8 take one of two routes, by the row length alone
(``fps_route``): "cluster", one thread-block cluster a row with every
point held on chip (K1: then a 3-NN launch over the centres), for rows of
up to ``CLUSTER_POINTS``; "grid", the cooperative kernel over all SMs,
above that.

``fps_with_interp_knn`` adds the tokenizer's k nearest points of every
centre, from the nearest member of each of 8 * l_lanes bins of the padded
cloud: kernel K9 (replacing ``ops/fps_pallas.py::fps_interp_knn_pallas``),
which is K1's launch on the padded cloud and then ``knn_bins_kernel``
(``csrc/fps_interp.cu``) over its centres, on a CUDA tensor;
``fps_interp_knn_plain`` on a CPU tensor. The JAX kernel folds each step's
distance field into the bins as it selects; that fold reads only the
centre's distances and the validity, so the bins follow from the centres
alone. The tokenizer takes it for ``knn_method="approx"``, gated on the
shapes as the JAX function is; it returns None where the gate fails.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _cuda
from .group import batch_index_select


def fma_sq_norm(d: torch.Tensor) -> torch.Tensor:
    """Squared norm of fp32 differences [..., 3] with the exact fp32 bits
    of the JAX reference as XLA compiles its explicit-difference sums (FPS
    and the 3-NN interp kernel alike): fma(dz, dz, fma(dx, dx, dy * dy)).
    Kernels K1, K8 and K10 write these two FMAs with __fmaf_rn. An fp32 FMA
    is emulated in fp64, where the product of two fp32 values is exact."""
    dx, dz = d[..., 0].double(), d[..., 2].double()
    inner = (dx * dx + (d[..., 1] * d[..., 1]).double()).float()
    return (dz * dz + inner.double()).float()


def fps_sq_dist(points: torch.Tensor, center: torch.Tensor) -> torch.Tensor:
    """Squared distance of every point to one centre, [B, N, 3] x [B, 3]
    -> [B, N] (``fma_sq_norm`` of the differences)."""
    return fma_sq_norm(points - center[:, None, :])


def _init_min_dist(points: torch.Tensor, valid: torch.Tensor | None):
    B, N, _ = points.shape
    min_d = torch.full((B, N), float("inf"), device=points.device)
    if valid is None:
        return min_d, torch.zeros(B, dtype=torch.int64, device=points.device)
    min_d = min_d.masked_fill(~valid, float("-inf"))
    first = valid.to(torch.uint8).argmax(dim=1)  # first valid point per row
    return min_d, first


def _center(points: torch.Tensor, sel: torch.Tensor) -> torch.Tensor:
    return torch.gather(points, 1, sel[:, None, None].expand(-1, 1, 3))[:, 0]


def fps_plain(points: torch.Tensor, num_samples: int, *,
              valid: torch.Tensor | None = None) -> torch.Tensor:
    """Plain torch version of kernel K8: sample ``num_samples``
    farthest-point indices per batch row.

    Args:
        points: [B, N, 3] coordinates (computed in fp32).
        num_samples: G.
        valid: optional [B, N] bool mask of real points.

    Returns:
        [B, G] int32 indices into N.
    """
    points = points.float()
    min_d, sel = _init_min_dist(points, valid)
    out = [sel]
    min_d = torch.minimum(min_d, fps_sq_dist(points, _center(points, sel)))
    for _ in range(1, num_samples):
        sel = min_d.argmax(dim=1)  # first index among equal maxima
        out.append(sel)
        min_d = torch.minimum(min_d, fps_sq_dist(points, _center(points, sel)))
    return torch.stack(out, dim=1).int()


def _first_valid(points: torch.Tensor, valid: torch.Tensor | None):
    """(valid as uint8 or None, first valid index per row, int32)."""
    if valid is None:
        return None, torch.zeros(points.shape[0], dtype=torch.int32, device=points.device)
    valid_u8 = valid.to(torch.uint8).contiguous()
    return valid_u8, valid_u8.argmax(dim=1).int()


def _candidates(B: int, device):
    """Scratch of the grid kernels' double-buffered per-block candidates."""
    return (torch.empty(2 * B * 4096, dtype=torch.float32, device=device),
            torch.empty(2 * B * 4096, dtype=torch.int32, device=device))


# The most points a row may have on the cluster route: what a cluster of 16
# CTAs holds, 256 threads x 32 points in registers each
# (csrc/fps_interp.cu kClusterPoints). It holds the serve bucket.
CLUSTER_POINTS = 131_072


def fps_route(N: int) -> str:
    """The route of K1's and K8's launch for rows of N points: "cluster"
    (one thread-block cluster a row, its points held on chip for the
    whole loop) up to ``CLUSTER_POINTS``, which takes the serve bucket
    131072 and the train rows; "grid" (the cooperative kernel over all
    SMs) above, e.g. the Predictor's 524288 bucket."""
    return "cluster" if N <= CLUSTER_POINTS else "grid"


def _launch(points: torch.Tensor, num_samples: int, valid, route: str, interp: bool):
    """Launch K1 (``interp``) or K8 on ``route`` ("cluster" or "grid"): K8's
    idx, or K1's (idx, centers, interp_idx, interp_d2). The wrappers pass
    ``fps_route``; a check may name the other route to hold the two
    against each other. Counts nothing."""
    if route not in ("cluster", "grid"):
        raise ValueError(f"unknown FPS route {route!r}")
    points = points.float().contiguous()
    _cuda.require_cuda(points)
    B, N, _ = points.shape
    dev = points.device
    valid_u8, first = _first_valid(points, valid)
    G = num_samples
    idx = torch.empty((B, G), dtype=torch.int32, device=dev)
    cand_v, cand_i = _candidates(B, dev) if route == "grid" else (None, None)
    p, lib, cluster = _cuda.ptr, _cuda.library(), int(route == "cluster")
    if not interp:
        code = lib.psam_fps(p(points), p(valid_u8), p(first), B, N, G, cluster, p(idx),
                            p(cand_v), p(cand_i), _cuda.stream())
        _cuda.check("psam_fps", code)
        return idx
    centers = torch.empty((B, G, 3), dtype=torch.float32, device=dev)
    interp_idx = torch.empty((B, N, 3), dtype=torch.int32, device=dev)
    interp_d2 = torch.empty((B, N, 3), dtype=torch.float32, device=dev)
    code = lib.psam_fps_interp(p(points), p(valid_u8), p(first), B, N, G, cluster, p(idx),
                               p(centers), p(interp_idx), p(interp_d2), p(cand_v), p(cand_i),
                               _cuda.stream())
    _cuda.check("psam_fps_interp", code)
    return idx, centers, interp_idx, interp_d2


@_cuda.counted
def fps_cuda(points: torch.Tensor, num_samples: int, *,
             valid: torch.Tensor | None = None) -> torch.Tensor:
    """Kernel K8 on the card, on the route ``fps_route`` gives (recorded
    in its launch count); same indices as ``fps_plain``."""
    B, N, _ = points.shape
    route = fps_route(N)
    idx = _launch(points, num_samples, valid, route, interp=False)
    _cuda.count_launch(fps_cuda, B=B, N=N, G=num_samples, valid=valid is not None,
                       route=route)
    return idx


def candidate_subset(n: int, candidates: int) -> np.ndarray:
    """The strided subset of approximate FPS, as JAX forms it:
    floor(arange(candidates) * (n / candidates)) in fp32, the quotient
    rounded to fp32 first (a weakly typed Python float in JAX). int64 [c]."""
    step = np.float32(n / candidates)
    return np.floor(np.arange(candidates, dtype=np.float32) * step).astype(np.int64)


def fps(points: torch.Tensor, num_samples: int, *,
        valid: torch.Tensor | None = None, candidates: int | None = None) -> torch.Tensor:
    """Farthest point sampling: K8 on the card, ``fps_plain`` on the CPU.

    Args:
        points: [B, N, 3] coordinates (computed in fp32).
        num_samples: G.
        valid: optional [B, N] bool mask of real points.
        candidates: approximate FPS (JAX ``ops/fps.py:109-117``): where
            N > candidates, select from the strided subset
            ``candidate_subset(N, candidates)`` (and its part of ``valid``)
            and map the indices back to N.

    Returns:
        [B, G] int32 indices into N.
    """
    N = points.shape[-2]
    if candidates is not None and N > candidates:
        if num_samples > candidates:
            raise ValueError(f"num_samples={num_samples} exceeds candidates={candidates}")
        sub = torch.from_numpy(candidate_subset(N, candidates)).to(points.device)
        idx = fps(points[:, sub], num_samples, valid=None if valid is None else valid[:, sub])
        return sub[idx.long()].int()
    run = fps_cuda if points.is_cuda else fps_plain
    return run(points, num_samples, valid=valid)


def fps_gather(points: torch.Tensor, num_samples: int, *,
               valid: torch.Tensor | None = None) -> torch.Tensor:
    """FPS returning the sampled coordinates (JAX ``ops/fps.py:288``, the
    reference's ``fps`` wrapper, common.py:12-24): ``fps`` (K8 on the card),
    then a gather. [B, N, 3] -> [B, G, 3] in the dtype of ``points``."""
    return batch_index_select(points, fps(points, num_samples, valid=valid))


def fps_interp_plain(points: torch.Tensor, num_samples: int, *,
                     valid: torch.Tensor | None = None):
    """Plain torch version of kernel K1 (the CPU path and the reference the
    kernel is held against).

    Same selection as ``fps_plain``; every step's distance field also updates a
    running best-3 per point (strict <, so ties keep the earlier slot), and
    one extra pass folds in the last centre's distances.

    Returns:
        (fps_idx [B, G] int32, centers [B, G, 3] f32,
         interp_idx [B, N, 3] int32 centre slots,
         interp_d2 [B, N, 3] f32 ascending squared distances).
    """
    points = points.float()
    B, N, _ = points.shape
    min_d, sel = _init_min_dist(points, valid)
    inf = torch.full((B, N), float("inf"), device=points.device)
    zero = torch.zeros((B, N), dtype=torch.int32, device=points.device)
    b0, b1, b2 = inf, inf, inf
    i0, i1, i2 = zero, zero, zero
    idx, ctrs = [], []
    for g in range(num_samples):
        idx.append(sel)
        c = _center(points, sel)
        ctrs.append(c)
        d = fps_sq_dist(points, c)
        min_d = torch.minimum(min_d, d)
        lt0, lt1, lt2 = d < b0, d < b1, d < b2
        gi = torch.full_like(zero, g)
        b2, i2 = (torch.where(lt2, torch.where(lt1, b1, d), b2),
                  torch.where(lt2, torch.where(lt1, i1, gi), i2))
        b1, i1 = (torch.where(lt1, torch.where(lt0, b0, d), b1),
                  torch.where(lt1, torch.where(lt0, i0, gi), i1))
        b0, i0 = torch.where(lt0, d, b0), torch.where(lt0, gi, i0)
        if g + 1 < num_samples:
            sel = min_d.argmax(dim=1)
    return (torch.stack(idx, 1).int(), torch.stack(ctrs, 1),
            torch.stack([i0, i1, i2], -1), torch.stack([b0, b1, b2], -1))


@_cuda.counted
def fps_interp_cuda(points: torch.Tensor, num_samples: int, *,
                    valid: torch.Tensor | None = None):
    """Kernel K1 on the card, on the route ``fps_route`` gives (recorded
    in its launch count); same outputs as ``fps_interp_plain``."""
    B, N, _ = points.shape
    route = fps_route(N)
    out = _launch(points, num_samples, valid, route, interp=True)
    _cuda.count_launch(fps_interp_cuda, B=B, N=N, G=num_samples, valid=valid is not None,
                       route=route)
    return out


def fps_with_interp(
    points: torch.Tensor,
    num_samples: int,
    *,
    valid: torch.Tensor | None = None,
    candidates: int | None = None,
    with_centers: bool = False,
    eps: float = 1e-8,
):
    """FPS + 3-NN interpolation geometry from one pass (K1). With
    ``candidates`` (approximate FPS; the selection no longer sees every
    point) in two, as JAX's: ``fps(candidates=)`` (K8 on the strided subset),
    the centres gathered, then ``compute_interp_weights`` (K10).

    Returns:
        (fps_idx [B, G] int32, interp_idx [B, N, 3] int32,
         interp_weight [B, N, 3] f32) — with ``with_centers``:
        (fps_idx, centers [B, G, 3] f32, interp_idx, interp_weight).
    """
    if candidates is not None:
        from .interp import compute_interp_weights  # interp imports this module

        fps_idx = fps(points, num_samples, valid=valid, candidates=candidates)
        centers = batch_index_select(points.float(), fps_idx, axis=1)
        idx, weight = compute_interp_weights(points, centers, eps=eps)
    else:
        run = fps_interp_cuda if points.is_cuda else fps_interp_plain
        fps_idx, centers, idx, d2 = run(points, num_samples, valid=valid)
        inv = 1.0 / torch.clamp_min(d2, eps)
        weight = inv / inv.sum(-1, keepdim=True)
    if with_centers:
        return fps_idx, centers, idx, weight
    return fps_idx, idx, weight


# ------------------------------------------------------------------ K9
_SUBLANES, _LANES = 8, 128  # the Pallas kernel's cell layout [8, n_pad / 8]


def _knn_cells(points: torch.Tensor, valid: torch.Tensor | None, l_lanes: int):
    """The cloud padded to n_pad = round_up(N, 8 * max(128, l_lanes)) points
    at 0, and its validity (padding invalid), as the Pallas wrapper pads."""
    B, N, _ = points.shape
    n_pad = -(-N // (_SUBLANES * max(_LANES, l_lanes))) * (_SUBLANES * max(_LANES, l_lanes))
    pts = torch.zeros((B, n_pad, 3), dtype=torch.float32, device=points.device)
    pts[:, :N] = points
    v = torch.zeros((B, n_pad), dtype=torch.bool, device=points.device)
    v[:, :N] = True if valid is None else valid
    return pts, v


def bins_top_k(cd: torch.Tensor, ci: torch.Tensor, k: int, n: int) -> torch.Tensor:
    """The k nearest of a centre's bins, ascending ([B, G, bins] minima and
    their point ids -> [B, G, k] int32 ids, clamped to n - 1 as the JAX
    wrapper clamps empty bins' ids). Equal distances go to the lower bin, as
    ``lax.top_k`` orders them: the key is (distance bits << 32 | bin), which
    orders as (distance, bin) since every distance is >= +0."""
    bin_id = torch.arange(cd.shape[-1], device=cd.device, dtype=torch.int64)
    key = (cd.float().contiguous().view(torch.int32).long() << 32) | bin_id
    pos = torch.topk(key, k, dim=-1, largest=False, sorted=True).indices
    return torch.gather(ci, -1, pos).clamp_max(n - 1).int()


def _check_knn_args(num_samples: int, k: int, l_lanes: int) -> None:
    if num_samples < 3:
        raise ValueError("the fused geometry needs num_samples >= 3")
    if k > _SUBLANES * l_lanes:
        raise ValueError(f"k={k} exceeds the bin count {_SUBLANES * l_lanes}")


# Centres a step of ``knn_bins_plain`` takes (bounds its [B, tile, n_pad]
# distance matrices).
_BIN_CENTRE_TILE = 64


def knn_bins_plain(points: torch.Tensor, valid: torch.Tensor, centers: torch.Tensor,
                   l_lanes: int):
    """Plain torch version of K9's bins (``knn_bins_kernel``).

    ``points`` [B, n_pad, 3] is the padded cloud (n_pad a multiple of
    8 * l_lanes), ``valid`` [B, n_pad] bool its validity, ``centers``
    [B, G, 3]. Point n lies in bin (n // n8, (n % n8) % l_lanes), n8 =
    n_pad / 8; for every centre and bin, the smallest ``fps_sq_dist`` of
    the bin's points to the centre (+inf at invalid points) and that
    point's id, ties to the smallest id (an all-invalid bin: +inf and its
    first point). The Pallas kernel folds exactly this at the step that
    selects the centre.

    Returns:
        (cd [B, G, 8 * l_lanes] f32, ci [B, G, 8 * l_lanes] int32).
    """
    B, n_pad, _ = points.shape
    n8 = n_pad // _SUBLANES
    chunks = n8 // l_lanes
    first = (torch.arange(_SUBLANES, device=points.device)[:, None] * n8
             + torch.arange(l_lanes, device=points.device)).reshape(-1)
    cds, cis = [], []
    for s in range(0, centers.shape[1], _BIN_CENTRE_TILE):
        c = centers[:, s:s + _BIN_CENTRE_TILE].float()
        d = fma_sq_norm(points[:, None] - c[:, :, None])  # [B, tile, n_pad]
        dm = d.masked_fill(~valid[:, None], float("inf"))
        dm = dm.view(B, c.shape[1], _SUBLANES, chunks, l_lanes)
        mn = dm.min(dim=3).values  # [B, tile, 8, l_lanes]
        j = (dm == mn[:, :, :, None]).to(torch.uint8).argmax(dim=3)  # first: smallest id
        cds.append(mn.reshape(B, c.shape[1], -1))
        cis.append((first + j.reshape(B, c.shape[1], -1) * l_lanes).int())
    return torch.cat(cds, 1), torch.cat(cis, 1)


def fps_interp_knn_plain(points: torch.Tensor, num_samples: int, k: int, *,
                         valid: torch.Tensor | None = None, l_lanes: int = 512):
    """Plain torch version of kernel K9 (with the top-k that follows it):
    ``fps_interp_plain`` on the padded cloud, ``knn_bins_plain`` over its
    centres, then the k nearest bins of every centre (``bins_top_k``).

    Returns:
        (fps_idx [B, G] int32, centers [B, G, 3] f32,
         interp_idx [B, N, 3] int32, interp_d2 [B, N, 3] f32,
         knn_idx [B, G, k] int32, ascending by distance).
    """
    _check_knn_args(num_samples, k, l_lanes)
    N = points.shape[1]
    pts, v = _knn_cells(points.float(), valid, l_lanes)
    idx, ctr, iidx, id2 = fps_interp_plain(pts, num_samples, valid=v)
    knn_idx = bins_top_k(*knn_bins_plain(pts, v, ctr, l_lanes), k, N)
    return idx, ctr, iidx[:, :N], id2[:, :N], knn_idx


def knn_bins_cuda(points: torch.Tensor, valid: torch.Tensor, centers: torch.Tensor,
                  l_lanes: int):
    """K9's bins on the card (``knn_bins_kernel``); same arguments and
    outputs as ``knn_bins_plain``, with l_lanes a multiple of 32. Counts
    nothing: K9's wrapper counts its launches."""
    if l_lanes % 32:
        raise ValueError(f"K9 takes l_lanes a multiple of 32, got {l_lanes}")
    points, centers = points.float().contiguous(), centers.float().contiguous()
    valid_u8 = valid.to(torch.uint8).contiguous()
    _cuda.require_cuda(points, valid_u8, centers)
    B, n_pad, _ = points.shape
    G = centers.shape[1]
    nbins = _SUBLANES * l_lanes
    cd = torch.empty((B, G, nbins), dtype=torch.float32, device=points.device)
    ci = torch.empty((B, G, nbins), dtype=torch.int32, device=points.device)
    p = _cuda.ptr
    code = _cuda.library().psam_knn_bins(p(points), p(valid_u8), p(centers), B, n_pad, G,
                                         l_lanes, p(cd), p(ci), _cuda.stream())
    _cuda.check("psam_knn_bins", code)
    return cd, ci


@_cuda.counted
def fps_interp_knn_cuda(points: torch.Tensor, num_samples: int, k: int, *,
                        valid: torch.Tensor | None = None, l_lanes: int = 512):
    """Kernel K9 on the card: K1's launch on the padded cloud, on the
    route ``fps_route`` gives for its length (recorded in the launch
    count), then ``knn_bins_cuda`` and ``bins_top_k`` (torch, outside the
    kernels, as the JAX wrapper runs ``lax.top_k`` outside its kernel);
    same outputs as ``fps_interp_knn_plain``."""
    _check_knn_args(num_samples, k, l_lanes)
    points = points.float().contiguous()
    _cuda.require_cuda(points)
    B, N, _ = points.shape
    pts, v = _knn_cells(points, valid, l_lanes)
    route = fps_route(pts.shape[1])
    idx, centers, interp_idx, interp_d2 = _launch(pts, num_samples, v, route, interp=True)
    cd, ci = knn_bins_cuda(pts, v, centers, l_lanes)
    _cuda.count_launch(fps_interp_knn_cuda, B=B, N=N, G=num_samples, k=k,
                       valid=valid is not None, route=route)
    knn_idx = bins_top_k(cd, ci, k, N)
    return idx, centers, interp_idx[:, :N], interp_d2[:, :N], knn_idx


def fused_geometry_ok(B: int, N: int, num_samples: int, k: int,
                      recall_target: float = 0.9) -> bool:
    """The gate of JAX's fused geometry (``fps_with_interp_knn``): B == 1,
    G % 128 == 0 and 3 <= G <= 2048, 16384 <= N <= 400000, 4 < k <= 1024
    and recall_target <= 0.93 (the 4096 bins give an expected recall of
    about 1 - (k - 1) / 8192, 0.97 at k = 256, so a higher target takes
    the composed path). JAX also asks for its TPU backend and
    ``PSAM_FUSED_GEOM=1``; the port's fused geometry is chosen by
    ``knn_method="approx"`` alone."""
    return (B == 1 and num_samples % 128 == 0 and 3 <= num_samples <= 2048
            and 16_384 <= N <= 400_000 and 4 < k <= 1024 and recall_target <= 0.93)


def fps_with_interp_knn(points: torch.Tensor, num_samples: int, k: int, *,
                        valid: torch.Tensor | None = None, eps: float = 1e-8,
                        recall_target: float = 0.9):
    """FPS + centres + 3-NN interp + the tokenizer's k-NN from one pass of
    K9 (``fps_interp_knn_plain`` on a CPU tensor), or None where
    ``fused_geometry_ok`` fails.

    Returns:
        (fps_idx [B, G] int32, centers [B, G, 3] f32, interp_idx [B, N, 3]
         int32, interp_weight [B, N, 3] f32, knn_idx [B, G, k] int32) or None.
    """
    B, N, _ = points.shape
    if not fused_geometry_ok(B, N, num_samples, k, recall_target):
        return None
    run = fps_interp_knn_cuda if points.is_cuda else fps_interp_knn_plain
    fps_idx, centers, idx, d2, knn_idx = run(points, num_samples, k, valid=valid)
    inv = 1.0 / torch.clamp_min(d2, eps)
    return fps_idx, centers, idx, inv / inv.sum(-1, keepdim=True), knn_idx
