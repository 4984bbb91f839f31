"""Farthest point sampling (counterpart of point_sam_tpu/ops/fps.py).

``fps`` has the semantics of the JAX ``fps_xla``: iterative farthest-point
selection over fp32 coordinates from the first valid point; padded points
sit at -inf and are never selected; ties go to the smallest index.

``fps_with_interp`` also returns the selected centres and, for every
point, its 3 nearest centres with normalised inverse-square-distance
weights. On a CUDA tensor it launches kernel K1 (``csrc/fps_interp.cu``,
replacing ``ops/fps_pallas.py::fps_interp_pallas``); on a CPU tensor it
runs ``fps_interp_plain``, the same computation step by step in torch.
"""

from __future__ import annotations

import torch

from . import _cuda


def fps_sq_dist(points: torch.Tensor, center: torch.Tensor) -> torch.Tensor:
    """Squared distance of every point to one centre, [B, N, 3] x [B, 3]
    -> [B, N], with the exact fp32 bits of the JAX reference as XLA
    compiles it: fma(dz, dz, fma(dx, dx, dy * dy)). (XLA contracts the
    explicit-difference sum into these two FMAs; kernel K1 writes them with
    __fmaf_rn.) An fp32 FMA is emulated in fp64, where the product of two
    fp32 values is exact."""
    d = points - center[:, None, :]
    dx, dz = d[..., 0].double(), d[..., 2].double()
    inner = (dx * dx + (d[..., 1] * d[..., 1]).double()).float()
    return (dz * dz + inner.double()).float()


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


def fps(points: torch.Tensor, num_samples: int, *,
        valid: torch.Tensor | None = None) -> torch.Tensor:
    """Sample ``num_samples`` farthest-point indices per batch row.

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


def fps_interp_plain(points: torch.Tensor, num_samples: int, *,
                     valid: torch.Tensor | None = None):
    """Plain torch version of kernel K1 (the CPU path and the reference the
    kernel is held against).

    Same selection as ``fps``; every step's distance field also updates a
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
    """Kernel K1 on the card; same outputs as ``fps_interp_plain``."""
    points = points.float().contiguous()
    _cuda.require_cuda(points)
    B, N, _ = points.shape
    dev = points.device
    if valid is None:
        first = torch.zeros(B, dtype=torch.int32, device=dev)
        valid_u8 = None
    else:
        valid_u8 = valid.to(torch.uint8).contiguous()
        first = valid_u8.argmax(dim=1).int()
    G = num_samples
    idx = torch.empty((B, G), dtype=torch.int32, device=dev)
    centers = torch.empty((B, G, 3), dtype=torch.float32, device=dev)
    interp_idx = torch.empty((B, N, 3), dtype=torch.int32, device=dev)
    interp_d2 = torch.empty((B, N, 3), dtype=torch.float32, device=dev)
    cand_v = torch.empty(2 * B * 4096, dtype=torch.float32, device=dev)
    cand_i = torch.empty(2 * B * 4096, dtype=torch.int32, device=dev)
    code = _cuda.library().psam_fps_interp(
        _cuda.ptr(points), _cuda.ptr(valid_u8), _cuda.ptr(first), B, N, G,
        _cuda.ptr(idx), _cuda.ptr(centers), _cuda.ptr(interp_idx),
        _cuda.ptr(interp_d2), _cuda.ptr(cand_v), _cuda.ptr(cand_i), _cuda.stream())
    _cuda.check("psam_fps_interp", code)
    _cuda.count_launch(fps_interp_cuda, B=B, N=N, G=G, valid=valid is not None)
    return idx, centers, interp_idx, interp_d2


def fps_with_interp(
    points: torch.Tensor,
    num_samples: int,
    *,
    valid: torch.Tensor | None = None,
    candidates: int | None = None,
    with_centers: bool = False,
    eps: float = 1e-8,
):
    """FPS + 3-NN interpolation geometry from one pass.

    Returns:
        (fps_idx [B, G] int32, interp_idx [B, N, 3] int32,
         interp_weight [B, N, 3] f32) — with ``with_centers``:
        (fps_idx, centers [B, G, 3] f32, interp_idx, interp_weight).
    """
    if candidates is not None:
        raise NotImplementedError(
            "approximate FPS (candidates=) is not ported; see ROADMAP.md")
    run = fps_interp_cuda if points.is_cuda else fps_interp_plain
    fps_idx, centers, idx, d2 = run(points, num_samples, valid=valid)
    inv = 1.0 / torch.clamp_min(d2, eps)
    weight = inv / inv.sum(-1, keepdim=True)
    if with_centers:
        return fps_idx, centers, idx, weight
    return fps_idx, idx, weight
