"""Multi-head attention of the ViT (counterpart of point_sam_tpu/ops/attention.py).

``mha_flat`` takes the q/k/v projections in [B, S, D] layout. On a CUDA
tensor it launches kernel K3 (``csrc/attention.cu``, replacing
``mha_packed_pallas``); on a CPU tensor it runs ``mha_plain``.
"""

from __future__ import annotations

import math

import torch

from . import _cuda


def scale_folds_exactly(scale: float) -> bool:
    """True iff ``scale`` is a power of two, so q * scale is exact and
    dot(q * scale, k) equals dot(q, k) * scale bit for bit."""
    return math.frexp(scale)[0] == 0.5


def mha_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              num_heads: int) -> torch.Tensor:
    """Plain torch version of kernel K3: per head, fp32 logits and softmax,
    the power-of-two scale folded into q, P rounded to v's dtype before the
    PV product, normalisation after it.

    Args:
        q, k, v: [B, S, D] with D = num_heads * dh.

    Returns:
        [B, S, D] in q's dtype.
    """
    B, S, D = q.shape
    dh = D // num_heads
    scale = 1.0 / math.sqrt(dh)
    fold = scale_folds_exactly(scale)
    split = lambda t: t.reshape(B, S, num_heads, dh).transpose(1, 2)  # noqa: E731
    qh, kh, vh = split(q), split(k), split(v)
    if fold:
        qh = qh * scale
    logits = torch.matmul(qh.float(), kh.float().transpose(-1, -2))
    if not fold:
        logits = logits * scale
    e = torch.exp(logits - logits.amax(-1, keepdim=True))
    denom = e.sum(-1, keepdim=True)
    # fp32 product of the rounded operands = fp32 accumulation.
    o = torch.matmul(e.to(v.dtype).float(), vh.float()) / denom
    return o.to(q.dtype).transpose(1, 2).reshape(B, S, D)


def mha_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             num_heads: int) -> torch.Tensor:
    """Kernel K3 on the card; same result as ``mha_plain``."""
    _cuda.require_cuda(q, k, v)
    B, S, D = q.shape
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q/k/v shapes differ: {q.shape} {k.shape} {v.shape}")
    if q.dtype != k.dtype or q.dtype != v.dtype:
        raise ValueError("q/k/v dtypes differ")
    if D % num_heads:
        raise ValueError(f"D={D} not divisible by {num_heads} heads")
    dh = D // num_heads
    scale = 1.0 / math.sqrt(dh)
    out = torch.empty_like(q)
    code = _cuda.library().psam_attention(
        _cuda.ptr(q), _cuda.ptr(k), _cuda.ptr(v), _cuda.ptr(out), B, S,
        num_heads, dh, scale, int(scale_folds_exactly(scale)),
        _cuda.dtype_code(q.dtype), _cuda.stream())
    _cuda.check("psam_attention", code)
    mha_cuda.launches += 1
    return out


mha_cuda.launches = 0


def mha_flat(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             num_heads: int) -> torch.Tensor:
    """[B, S, D] dense attention: K3 on the card, ``mha_plain`` on the CPU."""
    if q.is_cuda:
        return mha_cuda(q.contiguous(), k.contiguous(), v.contiguous(), num_heads)
    return mha_plain(q, k, v, num_heads)
