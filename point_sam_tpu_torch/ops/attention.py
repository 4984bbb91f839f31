"""Multi-head attention of the ViT (counterpart of point_sam_tpu/ops/attention.py).

``mha_flat`` takes the q/k/v projections in [B, S, D] layout and routes
them as the JAX function does, without its TPU-only S gates:

- head size 64 or 128 (and, for 64, an even head count): the ``MhaPacked``
  autograd Function (the counterpart of ``mha_packed_ad``). Forward:
  kernel K3 (``csrc/attention.cu``, replacing ``mha_packed_pallas``) on a
  CUDA tensor, ``mha_plain`` on a CPU tensor. Backward: kernel K6
  (``csrc/attention_bwd.cu``, replacing ``mha_packed_bwd_pallas``) on a
  CUDA tensor, ``mha_packed_bwd_plain`` on a CPU tensor;
- any other head size (EVA-giant's 88, the tiny test ViT's 32): heads split
  to [B, H, S, dh] and ``mha``, the ``MhaHeads`` Function (the counterpart
  of ``mha_pallas_ad``). Forward: kernel K5 (``csrc/attention.cu``,
  replacing ``mha_pallas``) on a CUDA tensor, ``mha_heads_plain`` on a CPU
  tensor. Backward: the plain recompute ``mha_heads_bwd_plain``, as in
  the JAX package, which has no backward kernel for K5.
"""

from __future__ import annotations

import math

import torch

from . import _cuda


def scale_folds_exactly(scale: float) -> bool:
    """True iff ``scale`` is a power of two, so q * scale is exact and
    dot(q * scale, k) equals dot(q, k) * scale bit for bit."""
    return math.frexp(scale)[0] == 0.5


def split_heads(t: torch.Tensor, num_heads: int) -> torch.Tensor:
    """[B, S, D] -> [B, H, S, D // H] (a view)."""
    B, S, D = t.shape
    return t.reshape(B, S, num_heads, D // num_heads).transpose(1, 2)


def merge_heads(t: torch.Tensor) -> torch.Tensor:
    """[B, H, S, dh] -> [B, S, H * dh]."""
    B, H, S, dh = t.shape
    return t.transpose(1, 2).reshape(B, S, H * dh)


def mha_heads_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Plain torch version of kernel K5 (and, per head, of K3): fp32
    logits and softmax, the power-of-two scale folded into q, e rounded to
    v's dtype before the PV product, normalisation after it.

    Args:
        q, k, v: [B, H, S, dh].

    Returns:
        [B, H, S, dh] in q's dtype.
    """
    scale = 1.0 / math.sqrt(q.shape[-1])
    fold = scale_folds_exactly(scale)
    if fold:
        q = q * scale
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2))
    if not fold:
        logits = logits * scale
    e = torch.exp(logits - logits.amax(-1, keepdim=True))
    denom = e.sum(-1, keepdim=True)
    # fp32 product of the rounded operands = fp32 accumulation.
    o = torch.matmul(e.to(v.dtype).float(), v.float()) / denom
    return o.to(q.dtype)


def mha_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              num_heads: int) -> torch.Tensor:
    """Plain torch version of kernel K3: ``mha_heads_plain`` on each head.

    Args:
        q, k, v: [B, S, D] with D = num_heads * dh.

    Returns:
        [B, S, D] in q's dtype.
    """
    o = mha_heads_plain(*(split_heads(t, num_heads) for t in (q, k, v)))
    return merge_heads(o)


def _check_qkv(q, k, v, num_heads: int | None = None) -> None:
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q/k/v shapes differ: {q.shape} {k.shape} {v.shape}")
    if q.dtype != k.dtype or q.dtype != v.dtype:
        raise ValueError("q/k/v dtypes differ")
    if num_heads is not None and q.shape[-1] % num_heads:
        raise ValueError(f"D={q.shape[-1]} not divisible by {num_heads} heads")


@_cuda.counted
def mha_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             num_heads: int) -> torch.Tensor:
    """Kernel K3 on the card; same result as ``mha_plain``."""
    _cuda.require_cuda(q, k, v)
    _check_qkv(q, k, v, num_heads)
    B, S, D = q.shape
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


@_cuda.counted
def mha_heads_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Kernel K5 on the card; same result as ``mha_heads_plain``."""
    _cuda.require_cuda(q, k, v)
    _check_qkv(q, k, v)
    B, H, S, dh = q.shape
    if dh > 128:
        raise ValueError(f"K5 takes head sizes up to 128, got {dh}")
    scale = 1.0 / math.sqrt(dh)
    out = torch.empty_like(q)
    code = _cuda.library().psam_attention_heads(
        _cuda.ptr(q), _cuda.ptr(k), _cuda.ptr(v), _cuda.ptr(out), B, H, S, dh, scale,
        int(scale_folds_exactly(scale)), _cuda.dtype_code(q.dtype), _cuda.stream())
    _cuda.check("psam_attention_heads", code)
    _cuda.count_launch(mha_heads_cuda, B=B, heads=H, S=S, dh=dh, dtype=str(q.dtype))
    return out


def mha_heads_bwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        do: torch.Tensor):
    """Backward of ``MhaHeads``, the reference's plain recompute
    ``_mha_bwd``: logits (fp32 products of the input-dtype operands) times
    the scale, the softmax p in fp32, dv = p^T do and dp = do v^T in fp32,
    ds = p (dp - rowsum(dp p)) scale, dq = ds k and dk = ds^T q in fp32.

    Args:
        q, k, v, do: [B, H, S, dh].

    Returns:
        (dq, dk, dv) in q's, k's and v's dtypes.
    """
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    p = torch.softmax(logits, dim=-1)
    do32 = do.float()
    dv = torch.matmul(p.transpose(-1, -2), do32)
    dp = torch.matmul(do32, v.float().transpose(-1, -2))
    ds = p * (dp - (dp * p).sum(-1, keepdim=True)) * scale
    dq = torch.matmul(ds, k.float())
    dk = torch.matmul(ds.transpose(-1, -2), q.float())
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


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
    dh = q.shape[-1] // num_heads
    scale = 1.0 / math.sqrt(dh)
    fold = scale_folds_exactly(scale)
    qh, kh, vh, doh = (split_heads(t, num_heads) for t in (q, k, v, do))
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
    return tuple(merge_heads(t.to(q.dtype)) for t in (dq, dk, dv))


@_cuda.counted
def mha_packed_bwd_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        do: torch.Tensor, num_heads: int):
    """Kernel K6 on the card; same result as ``mha_packed_bwd_plain``.

    Two launches: K6's query pass (per-row softmax statistics and dq)
    writes an fp32 [B, H, S, 3] workspace that its key pass (dk, dv)
    reads; no atomics, so the grads are the same from run to run. In bf16
    all five products run on the tensor cores, with p and ds rounded to
    bf16 as operands (within the bf16 tolerance of this plain version).
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


class MhaHeads(torch.autograd.Function):
    """Attention on [B, H, S, dh] (``mha_pallas_ad``): K5 on CUDA tensors,
    ``mha_heads_plain`` on CPU tensors; the backward recomputes the softmax
    in plain torch (``mha_heads_bwd_plain``) on either. Saves q, k, v."""

    @staticmethod
    def forward(ctx, q, k, v):
        ctx.save_for_backward(q, k, v)
        if q.is_cuda:
            return mha_heads_cuda(q, k, v)
        return mha_heads_plain(q, k, v)

    @staticmethod
    def backward(ctx, do):
        return mha_heads_bwd_plain(*ctx.saved_tensors, do)


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """[B, H, S, dh] dense attention: K5 on the card, its plain version on
    the CPU (both with the recompute backward)."""
    if q.is_cuda:
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    return MhaHeads.apply(q, k, v)


def packs_heads(dh: int, num_heads: int) -> bool:
    """True where the reference takes the packed [B, S, D] kernel: head
    size 64 or 128, and an even head count for 64 (two heads per 128
    lanes)."""
    return dh in (64, 128) and num_heads % (128 // dh) == 0


def mha_flat(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             num_heads: int) -> torch.Tensor:
    """[B, S, D] dense attention: the packed K3 / K6 path for the head sizes
    ``packs_heads`` admits, else heads split through ``mha`` (K5)."""
    if not packs_heads(q.shape[-1] // num_heads, num_heads):
        out = mha(*(split_heads(t, num_heads) for t in (q, k, v)))
        return merge_heads(out)
    if q.is_cuda:
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    return MhaPacked.apply(q, k, v, num_heads)
