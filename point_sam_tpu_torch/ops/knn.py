"""k-nearest-neighbour search (counterpart of point_sam_tpu/ops/knn.py).

The G x K search of the tokenizers (k > 4) is ``knn_select``: kernel K12
(``csrc/knn.cu``) on CUDA tensors, its plain torch version
``knn_select_plain`` on CPU tensors. It runs in two modes:

- exact: the k smallest squared distances, ties to the smaller key index,
  as ``lax.top_k`` orders them (JAX ``knn(method="exact")``);
- approximate: the nearest key of each of L strided bins, then the k
  nearest of those L, where L is the bin count XLA's ``ApproxTopK`` picks
  for the recall target (``approx_bins``): the port's counterpart of
  ``lax.approx_min_k`` (JAX ``knn(method="approx")``).

Both modes rank the fp32 expansion ``max((|q|^2 - 2 q.k) + |k|^2, +0)``,
each sum formed element by element with the FMAs ``knn_select_plain``
states, so that the card reproduces it bit for bit.

Tiny k (k <= 4: the 3-NN and the voronoi 1-NN) keeps the masked
min-extractions of ``_small_k_knn``.

Padding contract: ``key_valid`` marks real keys; padded keys get +inf
distance and are never selected while k real keys exist.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import _cuda
from .distance import sq_dist

_INF = float("inf")
# Above this many distance-matrix elements per call, tile the query axis
# in the small-k path (bounds the [tile, Nk] matrix).
_SINGLE_SHOT_MAX_ELEMENTS = 1 << 29
# (query, key) pairs a chunk of the plain selection holds as int64 keys.
_SELECT_CHUNK_ELEMENTS = 1 << 24
# The fp32 bits of +inf: the distance of an invalid key, and the high
# word of an empty bin.
_INF_BITS = 0x7F800000
# XLA's lane tiling of the reduced axis for an operand of rank >= 2.
_TPU_TILING = 128
# K12's limits (csrc/knn.cu: kMaxK, kMaxBins): k, and the bins whose
# bitmaps fit beside the candidate buffers.
K12_MAX_K = 1024
K12_MAX_BINS = 26624
# K12's launch plan (``k12_plan``; csrc/knn.cu checks it against its own
# layout): the shared memory an H100 block may opt into, the (queries a
# warp, warps) a block may take, most queries first, keys a tile, the
# largest sample, the sample distances a lane keeps (kTop), the largest
# candidate buffer (kMaxCap), and the blocks that fill the card's 132 SMs
# in one wave.
K12_SMEM_LIMIT = 232_448
_K12_BLOCKS = ((4, 8), (2, 8), (2, 4), (2, 2), (2, 1))
_K12_TILE = 1024
_K12_SAMPLE = 4096
_K12_TOP = 8
_K12_MAX_CAP = 2048
_K12_WAVE = 128


def approx_bins(n: int, k: int, recall_target: float) -> tuple[int, int]:
    """(L, log2_reduction): the bins XLA's ``ApproxTopK`` reduces ``n``
    values into for a top-``k`` at ``recall_target``, its
    ``ApproxTopKReductionOutputSize`` for an operand of rank >= 2:

        M = min(max(int((1 - k) / ln(rt)), 128), n)   (rt rounded to fp32)
        r = min(floor(log2(n // M)), ceil(log2(ceil(n / 128))))
        L = 128 * ceil(ceil(n / 128) / 2^r)

    with L = n, r = 0 where n <= 128 or floor(log2(n // M)) = 0 (no
    reduction). Its expected recall is about exp(-(k - 1) / L)."""
    if n <= _TPU_TILING:
        return n, 0
    if not 0.0 < recall_target < 1.0:
        raise ValueError(f"recall_target must lie in (0, 1), got {recall_target}")
    rt = float(np.float32(recall_target))
    m = min(max(int((1.0 - k) / math.log(rt)), _TPU_TILING), n)
    r = (n // m).bit_length() - 1
    if r <= 0:
        return n, 0
    tiles = -(-n // _TPU_TILING)
    r = min(r, (tiles - 1).bit_length())
    return _TPU_TILING * -(-tiles // (1 << r)), r


def fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """fp32 fma(a, b, c) = a * b + c rounded once, as __fmaf_rn: the product
    of two fp32 values is exact in fp64, the sum's rounding error is
    recovered exactly (TwoSum), and where the fp64 sum sits on the midpoint
    of two fp32 values that error decides the side (a plain fp64 -> fp32
    cast would round twice)."""
    p = a.double() * b.double()
    cd = c.double()
    s = p + cd
    t = s - p
    e = (p - (s - t)) + (cd - t)  # s + e == a * b + c exactly
    r = s.float()
    gap = s - r.double()
    other = torch.nextafter(r, torch.where(gap > 0, _INF, -_INF))
    mid = (gap != 0) & (2.0 * gap == other.double() - r.double())
    return torch.where(mid & (e * gap > 0), other, r)


def dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a . b over the last axis of 3, as ``fma(a2, b2, fma(a1, b1, a0 * b0))``
    in fp32: the bits XLA's CPU dot and sum of squares give (so JAX's
    ``sq_dist`` on the CPU), which kernel K12 writes with __fmaf_rn."""
    return fma_f32(a[..., 2], b[..., 2], fma_f32(a[..., 1], b[..., 1], a[..., 0] * b[..., 0]))


def _packed_keys(query: torch.Tensor, key: torch.Tensor,
                 key_valid: torch.Tensor | None) -> torch.Tensor:
    """int64 [B, Nq, Nk]: (fp32 bits of d^2) << 32 | key index. d^2 >= +0,
    so the order of these keys is the order by (d^2, index)."""
    q2 = dot3(query, query)[:, :, None]  # [B, Nq, 1]
    k2 = dot3(key, key)[:, None, :]  # [B, 1, Nk]
    dot = dot3(query[:, :, None, :], key[:, None, :, :])
    d2 = (q2 - 2.0 * dot) + k2
    d2 = torch.where(d2 > 0.0, d2, 0.0)  # +0, never -0: the bits keep the order
    if key_valid is not None:
        d2 = d2.masked_fill(~key_valid[:, None, :], _INF)
    index = torch.arange(key.shape[1], device=key.device, dtype=torch.int64)
    return (d2.view(torch.int32).to(torch.int64) << 32) | index


def _unpack(keys: torch.Tensor, nk: int) -> tuple[torch.Tensor, torch.Tensor]:
    d2 = (keys >> 32).to(torch.int32).view(torch.float32)
    idx = (keys & 0xFFFFFFFF).clamp_max(nk - 1).to(torch.int32)
    return d2, idx


def _check_select_args(nk: int, k: int, bins: int | None) -> None:
    if not 1 <= k <= nk:
        raise ValueError(f"k={k} must lie in [1, {nk}] (the number of keys)")
    if bins is not None and not k <= bins:
        raise ValueError(f"approximate kNN needs bins >= k, got {bins} bins for k={k}")


def _align16(n: int) -> int:
    return (n + 15) // 16 * 16


def k12_smem_bytes(warps: int, qw: int, cap: int, tile: int, sample: int, bins: int) -> int:
    """Shared memory of a K12 block (csrc/knn.cu ``layout``): the candidate
    buffers (``cap`` 64-bit keys for each of the block's queries), which
    first stage the sample (16 + 1 bytes a key); three staged tiles of (x,
    y, z, k^2) and their valid bits; two raw tiles (fp32 triples, valid bytes,
    16 bytes each for the misalignment); in approximate mode a bitmap of
    the bins for each warp; a flag and the queries' candidate counts; the
    ring's eight mbarriers."""
    cand = warps * qw * cap * 8
    return (_align16(max(cand, sample * 17)) + 3 * tile * 16 + _align16(3 * (tile // 32) * 4)
            + 2 * _align16(tile * 12 + 16) + 2 * _align16(tile + 16)
            + _align16(warps * ((bins + 31) // 32) * 4) + _align16(4 + warps * qw * 4) + 64)


def _pow2(n: int) -> int:
    return 1 << max(0, n - 1).bit_length()


def k12_plan(B: int, nq: int, nk: int, k: int, bins: int | None = None) -> dict:
    """K12's launch at (B, Nq, Nk, k, bins), a pure function of them.

    - ``sample`` keys at a ``stride`` (0: none; every key is a candidate
      from the start, as where Nk <= 1024) bound each query's candidates by
      the ``rank``-th smallest sample distance: mu + 4 sqrt(mu) + 4, mu the
      expected number of the ``need`` nearest keys in the sample (k; in
      approximate mode the keys whose bins fill k of the L, -L ln(1 - k / L)).
      The sample is at most 4096 and keeps mu <= 80, so rank <= 128 of the
      256 distances a warp keeps.
    - ``cap``: the candidates a query holds, a power of two: every key
      where there is no sample; else >= k + 64 and about the expected count
      below the bound plus one sigma (a full buffer is cut to k and the scan
      goes on), at most 2048.
    - ``tile``: the keys a tile of the ring (1024).
    - ``warps`` scoring warps of ``qw`` queries each (4 x 8, 2 x 8, 2 x 4,
      2 x 2, 2 x 1), and two more warps that stage the tiles:
      the first whose ``smem`` fits 232,448 bytes and still gives 128
      blocks (a wave of the 132 SMs), else the last that fits; ``grid`` = B
      * ``groups``, block b * groups + g taking queries [g * queries, (g +
      1) * queries) of batch row b, those >= Nq idle.
    """
    _check_select_args(nk, k, bins)
    if k > K12_MAX_K or (bins is not None and bins > K12_MAX_BINS):
        raise ValueError(f"K12 takes k <= {K12_MAX_K} and bins <= {K12_MAX_BINS}, got k={k}, "
                         f"bins={bins}")
    L = bins or 0
    if 0 < L < nk:
        need = nk if k >= L else min(nk, math.ceil(-L * math.log1p(-k / L)))
    else:  # exact, or a bin a key
        need = k
    sample = stride = rank = 0
    target = min(_K12_SAMPLE, 80 * nk // need)
    if nk <= 1024:
        cap = max(32, _pow2(nk))
    elif target >= 256:
        stride = -(-nk // target)
        sample = -(-nk // stride)
        mu = need * sample / nk
        rank = math.ceil(mu + 4.0 * math.sqrt(mu) + 4.0)
        expect = rank * nk / sample * (1.0 + 1.0 / math.sqrt(rank))
        cap = min(_K12_MAX_CAP, _pow2(max(k + 64, math.ceil(expect))))
    else:
        cap = _K12_MAX_CAP
    tile = _K12_TILE
    fits = [(qw, w) for qw, w in _K12_BLOCKS
            if k12_smem_bytes(w, qw, cap, tile, sample, L) <= K12_SMEM_LIMIT]
    qw, warps = next((f for f in fits if B * -(-nq // (f[0] * f[1])) >= _K12_WAVE), fits[-1])
    queries = qw * warps
    groups = -(-nq // queries)
    return dict(warps=warps, qw=qw, threads=32 * (warps + 2), queries=queries, groups=groups,
                cap=cap, tile=tile, sample=sample, stride=stride, rank=rank,
                smem=k12_smem_bytes(warps, qw, cap, tile, sample, L), grid=B * groups)


def knn_select_plain(query: torch.Tensor, key: torch.Tensor, k: int, *,
                     key_valid: torch.Tensor | None = None,
                     bins: int | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain torch version of kernel K12.

    d^2 of a (query, key) pair is ``max((q2 - 2 * dot) + k2, +0.0)`` in
    fp32, every product formed element by element, no matmul: ``q2 =
    dot3(q, q)``, ``k2 = dot3(k, k)``, ``dot = dot3(q, k)``, each
    ``fma(z, z', fma(y, y', x * x'))`` rounded as one fp32 FMA a step (the
    bits of JAX's ``sq_dist`` on the CPU); a value that is not > 0 (-0, or
    a rounding below 0) becomes +0. An invalid key has d^2 = +inf.

    Exact mode (``bins=None``): the k smallest by (d^2, index), so equal
    distances go to the smaller index, as ``lax.top_k`` orders them.

    Approximate mode (``bins=L``): first the smallest by (d^2, index) of
    each strided bin ``{i : i mod L == j}``, then the k smallest of the L
    bin minima by the same order (XLA's partial reduction with
    ``aggregate_to_topk``; which element falls in which bin cannot be seen
    off the TPU, so strided bins are the port's definition). A bin with no
    key (j >= Nk) holds (+inf, Nk + j), after every real key, and reports
    index Nk - 1.

    Queries are taken in chunks of at most 2^24 (query, key) pairs.

    Args:
        query: [B, Nq, 3]. key: [B, Nk, 3] (computed in fp32).
        key_valid: optional [B, Nk] bool.
        bins: None (exact) or L >= k.

    Returns:
        (d^2 [B, Nq, k] f32, indices [B, Nq, k] int32), ascending.
    """
    query, key = query.float(), key.float()
    B, nq, _ = query.shape
    nk = key.shape[1]
    if query.shape[2] != 3 or key.shape[2] != 3:
        raise ValueError(f"kNN selection takes 3-D points, got {tuple(query.shape)} and "
                         f"{tuple(key.shape)}")
    _check_select_args(nk, k, bins)
    chunk = max(1, _SELECT_CHUNK_ELEMENTS // (B * max(nk, bins or 0)))
    pad = None
    if bins is not None:
        rows = -(-nk // bins)
        p = torch.arange(nk, rows * bins, device=key.device, dtype=torch.int64)
        pad = ((_INF_BITS << 32) | (nk + p % bins)).expand(B, 1, -1)
    ds, idxs = [], []
    for s in range(0, nq, chunk):
        keys = _packed_keys(query[:, s:s + chunk], key, key_valid)
        if pad is not None:
            keys = torch.cat([keys, pad.expand(B, keys.shape[1], -1)], dim=-1)
            keys = keys.view(B, keys.shape[1], rows, bins).amin(dim=2)
        best = torch.topk(keys, k, dim=-1, largest=False, sorted=True).values
        d, i = _unpack(best, nk)
        ds.append(d)
        idxs.append(i)
    return torch.cat(ds, 1), torch.cat(idxs, 1)


def _bulk_copyable(t: torch.Tensor) -> torch.Tensor:
    """``t`` where K12's 16-byte bulk copies may read it whole: its base
    16-byte aligned and its bytes a multiple of 16 (the last tile's copy
    ends on a 16-byte boundary); else a flat copy padded to one."""
    if t.data_ptr() % 16 == 0 and t.numel() * t.element_size() % 16 == 0:
        return t
    unit = 16 // t.element_size()
    out = torch.zeros(-(-t.numel() // unit) * unit, dtype=t.dtype, device=t.device)
    out[:t.numel()] = t.reshape(-1)
    return out


@_cuda.counted
def knn_select_cuda(query: torch.Tensor, key: torch.Tensor, k: int, *,
                    key_valid: torch.Tensor | None = None,
                    bins: int | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel K12 on the card, one launch at ``k12_plan``'s plan; same
    arguments and outputs as ``knn_select_plain``, bit for bit. Takes k <=
    1024 and, in approximate mode, bins <= 26624; raises on anything else."""
    query, key = query.float().contiguous(), key.float().contiguous()
    valid = None if key_valid is None else key_valid.to(torch.uint8).contiguous()
    _cuda.require_cuda(query, key, *(() if valid is None else (valid,)))
    B, nq, _ = query.shape
    nk = key.shape[1]
    if key.shape[0] != B or query.shape[2] != 3 or key.shape[2] != 3:
        raise ValueError(f"K12 takes [B, Nq, 3] queries and [B, Nk, 3] keys, got "
                         f"{tuple(query.shape)} and {tuple(key.shape)}")
    plan = k12_plan(B, nq, nk, k, bins)
    key = _bulk_copyable(key)
    valid = None if valid is None else _bulk_copyable(valid)
    d = torch.empty((B, nq, k), dtype=torch.float32, device=query.device)
    idx = torch.empty((B, nq, k), dtype=torch.int32, device=query.device)
    p = _cuda.ptr
    code = _cuda.library().psam_knn_select(
        p(query), p(key), p(valid), B, nq, nk, k, bins or 0,
        *(plan[f] for f in ("warps", "qw", "cap", "tile", "sample", "stride", "rank", "smem",
                            "grid")),
        p(d), p(idx), _cuda.stream())
    _cuda.check("psam_knn_select", code)
    _cuda.count_launch(knn_select_cuda, B=B, Nq=nq, Nk=nk, k=k, valid=valid is not None,
                       bins=bins)
    return d, idx


def knn_select(query: torch.Tensor, key: torch.Tensor, k: int, *,
               key_valid: torch.Tensor | None = None,
               bins: int | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """K12 on CUDA tensors, ``knn_select_plain`` on CPU tensors."""
    run = knn_select_cuda if query.is_cuda else knn_select_plain
    return run(query, key, k, key_valid=key_valid, bins=bins)


def _small_k_single(query, key, k, key_valid):
    d2 = sq_dist(query, key)
    if key_valid is not None:
        d2 = d2.masked_fill(~key_valid[..., None, :], _INF)
    ds, idxs = [], []
    for j in range(k):
        d, i = d2.min(dim=-1)  # first index among equal minima
        ds.append(d)
        idxs.append(i.int())
        if j + 1 < k:
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


def nn1(query: torch.Tensor, key: torch.Tensor, *,
        key_valid: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Single nearest neighbour, squeezed (the voronoi assignment of each
    point to its centre): ([B, Nq] squared distances, [B, Nq] int32)."""
    d, i = knn(query, key, 1, key_valid=key_valid)
    return d[..., 0], i[..., 0]


def knn(
    query: torch.Tensor,
    key: torch.Tensor,
    k: int,
    *,
    key_valid: torch.Tensor | None = None,
    key_tile: int = 4096,
    dense_max: int = 8192,
    method: str = "auto",
    recall_target: float = 0.95,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Find the k nearest keys for each query point.

    Args:
        query: [B, Nq, 3] float coordinates.
        key: [B, Nk, 3] float coordinates.
        k: number of neighbours.
        key_valid: optional [B, Nk] bool; False entries are never selected.
        key_tile, dense_max: the key tiling of JAX's exact scan, kept for
            its signature; the port's selection does not tile keys.
        method: "auto" | "exact" | "approx" | "small_k". "auto" picks
            small_k for k <= 4 and the exact selection otherwise, on every
            device (JAX takes "approx" there on the TPU only). "approx":
            the strided-bin selection at ``approx_bins(Nk, k,
            recall_target)``.
        recall_target: the approximate selection's target, as JAX's.

    Returns:
        (sq_dists [B, Nq, k], indices [B, Nq, k] int32), ascending.
    """
    del key_tile, dense_max
    nk = key.shape[-2]
    if k > nk:
        raise ValueError(f"k={k} exceeds number of keys {nk}")
    if method == "auto":
        method = "small_k" if k <= 4 else "exact"
    if method == "small_k":
        return _small_k_knn(query, key, k, key_valid)
    if method == "exact":
        return knn_select(query, key, k, key_valid=key_valid)
    if method == "approx":
        bins = approx_bins(nk, k, recall_target)[0]
        return knn_select(query, key, k, key_valid=key_valid, bins=bins)
    raise ValueError(f"unknown knn method {method!r}")
