"""Fused mask-decoder tail (counterpart of point_sam_tpu/ops/upscale_pallas.py;
the file keeps the reference's name so each counterpart is easy to find).

``interp_upscale_hyper_fused``: 3-NN interpolation of the Dense_0-projected
tokens h1, then LN -> GELU -> Dense -> GELU, then the dot with the
hypernetwork rows, giving mask logits. It runs the ``InterpUpscale``
autograd Function (the counterpart of ``interp_upscale_hyper_ad``): the
forward launches kernel K4 (``csrc/upscale.cu``) on a CUDA tensor and runs
``interp_upscale_plain`` on a CPU tensor. The reference has no backward
kernel for it: its backward recomputes the chain in plain arithmetic and
differentiates that (``_bwd2``), and so does the port's, on both devices.
``index`` and ``weight`` are stop-gradient geometry and get no gradient.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _cuda
from .interp import interpolate_features_repeated
from .patch_encoder_pallas import _dense, gelu_erf, ln_gelu


def interp_upscale_plain(h1, index, weight, params, hyper, *, cdt):
    """Plain torch version of kernel K4.

    Args:
        h1: [BM, G, D] projected tokens (BM = B*M replicas).
        index / weight: [B, N, 3] 3-NN geometry shared by the M replicas.
        params: (ln_scale [D], ln_bias [D], w2 [D, D] as [in, out], b2 [D]).
        hyper: [BM, C, D].

    Returns:
        mask logits [BM, C, N] fp32.
    """
    s, t, w, b = params
    x = interpolate_features_repeated(h1.float(), index, weight).to(cdt)
    g = ln_gelu(x, s, t, cdt)
    h = gelu_erf(_dense(g, w, b, cdt).float()).to(cdt)
    return torch.matmul(hyper.to(cdt).float(), h.float().transpose(1, 2))


@_cuda.counted
def interp_upscale_cuda(h1, index, weight, params, hyper, *, cdt):
    """Kernel K4 on the card; same contract as ``interp_upscale_plain``."""
    s, t, w, b = params
    BM, G, D = h1.shape
    B, N, _ = index.shape
    if BM % B:
        raise ValueError(f"h1 batch {BM} is not a multiple of {B}")
    C = hyper.shape[1]
    h1c = h1.to(cdt).contiguous()
    idx = index.int().contiguous()
    wts = weight.float().contiguous()
    wc = w.to(cdt).contiguous()
    hy = hyper.to(cdt).contiguous()
    vecs = [v.float().contiguous() for v in (s, t, b)]
    _cuda.require_cuda(h1c, idx, wts, wc, hy, *vecs)
    out = torch.empty((BM, C, N), dtype=torch.float32, device=h1.device)
    p = _cuda.ptr
    code = _cuda.library().psam_interp_upscale(
        p(h1c), p(idx), p(wts), p(vecs[0]), p(vecs[1]), p(wc), p(vecs[2]),
        p(hy), p(out), B, BM // B, G, N, D, C, _cuda.dtype_code(cdt),
        _cuda.stream())
    _cuda.check("psam_interp_upscale", code)
    _cuda.count_launch(interp_upscale_cuda, B=B, M=BM // B, G=G, N=N, D=D, C=C, cdt=str(cdt))
    return out



def upscale_hyper_reference(x, params, hyper, *, cdt):
    """The module-path tail the reference's backward recomputes
    (``upscale_hyper_reference``): LN (fp32 stats) cast to cdt, exact GELU,
    Dense in cdt, GELU, then the hypernet product with fp32 accumulation."""
    s, t, w, b = params
    x32 = x.float()
    c = x32 - x32.mean(-1, keepdim=True)
    y = c * torch.rsqrt((c * c).mean(-1, keepdim=True) + 1e-5) * s + t
    y = F.gelu(y.to(cdt))
    h = F.gelu(torch.matmul(y, w.to(cdt)) + b.to(cdt))
    return torch.matmul(hyper.to(cdt).float(), h.float().transpose(1, 2))


def interp_upscale_reference(h1, index, weight, params, hyper, *, cdt):
    """The chain the backward differentiates: the 3-NN gather-sum
    interpolation, then ``upscale_hyper_reference``. (The reference swaps
    in a dense [N, G] matrix product below 2^24 elements to keep XLA's
    scatter-add out of its TPU backward; autograd of the gather here
    needs neither the size gate nor the [B, N, G] matrix.)"""
    x = interpolate_features_repeated(h1, index, weight)
    return upscale_hyper_reference(x, params, hyper, cdt=cdt)


class InterpUpscale(torch.autograd.Function):
    """K4 forward, recompute backward (``interp_upscale_hyper_ad``). Grads
    go to h1, the four tail parameters and hyper; none to the geometry."""

    @staticmethod
    def forward(ctx, h1, index, weight, hyper, cdt, *params):
        ctx.cdt = cdt
        ctx.save_for_backward(h1, index, weight, hyper, *params)
        run = interp_upscale_cuda if h1.is_cuda else interp_upscale_plain
        return run(h1, index, weight, params, hyper, cdt=cdt)

    @staticmethod
    def backward(ctx, dout):
        h1, index, weight, hyper, *params = ctx.saved_tensors
        inputs = [t.detach().requires_grad_() for t in (h1, hyper, *params)]
        with torch.enable_grad():
            out = interp_upscale_reference(inputs[0], index, weight, tuple(inputs[2:]),
                                           inputs[1], cdt=ctx.cdt)
        grads = torch.autograd.grad(out, inputs, dout)
        return (grads[0], None, None, grads[1], None, *grads[2:])


def interp_upscale_hyper_fused(h1, index, weight, params, hyper, *, cdt):
    """Mask logits [BM, C, N]: K4 on the card, plain on the CPU; the
    backward recomputes in plain torch on both."""
    return InterpUpscale.apply(h1, index, weight.detach(), hyper, cdt, *params)
