"""Multi-head attention of the ViT (counterpart of point_sam_tpu/ops/attention.py).

``mha_flat`` takes the q/k/v projections in [B, S, D] layout and runs the
``MhaPacked`` autograd Function (the counterpart of ``mha_packed_ad``):

- forward: kernel K3 (``csrc/attention.cu``, replacing
  ``mha_packed_pallas``) on a CUDA tensor, ``mha_plain`` on a CPU tensor;
- backward: kernel K6 (``csrc/attention_bwd.cu``, replacing
  ``mha_packed_bwd_pallas``) on a CUDA tensor, ``mha_packed_bwd_plain`` on
  a CPU tensor. Every S goes through K6 (no TPU-style S gate).
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


@_cuda.counted
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
    _cuda.count_launch(mha_cuda, B=B, S=S, D=D, heads=num_heads, dtype=str(q.dtype))
    return out



def mha_packed_bwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         do: torch.Tensor, num_heads: int):
    """Plain torch version of kernel K6, the arithmetic of the reference's
    ``_mha_packed_bwd_kernel``: per head, the softmax recomputed in fp32
    from the (scale-folded) logits; dv = p^T do and dp = do v^T with do and
    v in fp32; ds = p (dp - rowsum(dp p)) in fp32 (times the scale when it
    does not fold); dq = ds (k scale) and dk = ds^T (q scale) with fp32
    operands when the scale folds, else dq = ds k and dk = ds^T q.

    Args:
        q, k, v, do: [B, S, D] with D = num_heads * dh.

    Returns:
        (dq, dk, dv), each [B, S, D] in q's dtype.
    """
    B, S, D = q.shape
    dh = D // num_heads
    scale = 1.0 / math.sqrt(dh)
    fold = scale_folds_exactly(scale)
    split = lambda t: t.reshape(B, S, num_heads, dh).transpose(1, 2)  # noqa: E731
    qh, kh, vh, doh = split(q), split(k), split(v), split(do)
    qs = qh * scale if fold else qh
    logits = torch.matmul(qs.float(), kh.float().transpose(-1, -2))
    if not fold:
        logits = logits * scale
    e = torch.exp(logits - logits.amax(-1, keepdim=True))
    p = e / e.sum(-1, keepdim=True)
    do32 = doh.float()
    dv = torch.matmul(p.transpose(-1, -2), do32)
    dp = torch.matmul(do32, vh.float().transpose(-1, -2))
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    if not fold:
        ds = ds * scale
    kq = kh * scale if fold else kh
    dq = torch.matmul(ds, kq.float())
    dk = torch.matmul(ds.transpose(-1, -2), qs.float())
    merge = lambda t: t.to(q.dtype).transpose(1, 2).reshape(B, S, D)  # noqa: E731
    return merge(dq), merge(dk), merge(dv)


@_cuda.counted
def mha_packed_bwd_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        do: torch.Tensor, num_heads: int):
    """Kernel K6 on the card; same result as ``mha_packed_bwd_plain``.

    Two launches: K6's query pass (per-row softmax statistics and dq)
    writes an fp32 [B, H, S, 3] workspace that its key pass (dk, dv)
    reads; no atomics, so the grads are the same from run to run.
    """
    _cuda.require_cuda(q, k, v, do)
    B, S, D = q.shape
    if any(t.shape != q.shape for t in (k, v, do)):
        raise ValueError(f"q/k/v/do shapes differ: {q.shape} {k.shape} {v.shape} {do.shape}")
    if any(t.dtype != q.dtype for t in (k, v, do)):
        raise ValueError("q/k/v/do dtypes differ")
    if D % num_heads:
        raise ValueError(f"D={D} not divisible by {num_heads} heads")
    dh = D // num_heads
    scale = 1.0 / math.sqrt(dh)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(q), torch.empty_like(q)
    stats = torch.empty((B, num_heads, S, 3), dtype=torch.float32, device=q.device)
    p = _cuda.ptr
    code = _cuda.library().psam_attention_bwd(
        p(q), p(k), p(v), p(do), p(dq), p(dk), p(dv), p(stats), B, S, num_heads, dh,
        scale, int(scale_folds_exactly(scale)), _cuda.dtype_code(q.dtype), _cuda.stream())
    _cuda.check("psam_attention_bwd", code)
    _cuda.count_launch(mha_packed_bwd_cuda, B=B, S=S, D=D, heads=num_heads,
                       dtype=str(q.dtype))
    return dq, dk, dv



class MhaPacked(torch.autograd.Function):
    """Attention on [B, S, D] with a kernel backward (``mha_packed_ad``):
    K3 / K6 on CUDA tensors, ``mha_plain`` / ``mha_packed_bwd_plain`` on
    CPU tensors. Saves only q, k, v; the backward recomputes the softmax."""

    @staticmethod
    def forward(ctx, q, k, v, num_heads: int):
        ctx.num_heads = num_heads
        ctx.save_for_backward(q, k, v)
        if q.is_cuda:
            return mha_cuda(q, k, v, num_heads)
        return mha_plain(q, k, v, num_heads)

    @staticmethod
    def backward(ctx, do):
        q, k, v = ctx.saved_tensors
        do = do.to(q.dtype).contiguous()
        bwd = mha_packed_bwd_cuda if q.is_cuda else mha_packed_bwd_plain
        dq, dk, dv = bwd(q, k, v, do, ctx.num_heads)
        return dq, dk, dv, None


def mha_flat(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             num_heads: int) -> torch.Tensor:
    """[B, S, D] dense attention: K3 (forward) and K6 (backward) on the
    card, their plain versions on the CPU."""
    if q.is_cuda:
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    return MhaPacked.apply(q, k, v, num_heads)
