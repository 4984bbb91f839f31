"""Fused mask-decoder tail (counterpart of point_sam_tpu/ops/upscale_pallas.py;
the file keeps the reference's name so each counterpart is easy to find).

The tail: LN -> GELU -> Dense -> GELU on the Dense_0-projected features of
every point, then the dot with the hypernetwork rows, giving mask logits.
``decoder_tail`` is the one entry both decoders call; it routes as the JAX
``MaskDecoder`` does (models/mask_decoder.py:232-251 there), on the shapes
alone:

- where ``interp_upscale_dispatch_ok`` holds (G <= 2048, G % 128 == 0, the
  working-set estimate within budget), ``interp_upscale_hyper_fused``: the
  3-NN interpolation fused with the tail, the ``InterpUpscale`` autograd
  Function (``interp_upscale_hyper_ad``), kernel K4 (``csrc/upscale.cu``)
  on a CUDA tensor and ``interp_upscale_plain`` on a CPU tensor;
- otherwise an explicit 3-NN gather (``interpolate_features_repeated``,
  plain torch, as JAX gathers in XLA) and ``upscale_hyper_fused``: the
  ``UpscaleHyper`` Function (``upscale_hyper_ad``), kernel K11
  (``csrc/upscale.cu``) on a CUDA tensor and ``upscale_hyper_reference`` on
  a CPU tensor. JAX's third branch, the module path for widths its K11
  gate refuses, has no counterpart on the card: K11 takes every D <= 512.

K4 and K11 take one of two routes, by the shapes alone (``upscale_route``):
"mma", the Dense and the hypernet dot on the tensor cores with W resident
in shared memory (bf16 at D a multiple of 64 up to 256, C <= 8: every
model's bf16 tail), or "fma", fp32 tiles with the Dense on the FMA units
(fp32, and bf16 at other widths).

The reference has no backward kernel for either: both backwards recompute
the chain in plain arithmetic and differentiate that (``_bwd``, ``_bwd2``),
and so do the port's, on both devices. ``index`` and ``weight`` are
stop-gradient geometry and get no gradient.
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


# The mma route's shapes (csrc/upscale.cu, interp_upscale_mma_kernel<D>):
# bf16 at the widths of every model's tail, D = 128 or 256 (W [D, D] stays
# in shared memory beside two 64-row tiles up to 256), and C <= 8 hypernet
# rows, which fill one n16 pair of mma.sync tiles.
MMA_WIDTHS = (128, 256)
MMA_MAX_C = 8
_ROUTES = {"fma": 0, "mma": 1}


def upscale_route(D: int, C: int, cdt) -> str:
    """The route of K4's and K11's launch, by the shapes alone: "mma" (the
    Dense and the hypernet dot on the tensor cores, W resident in shared
    memory) for bf16 at D in {128, 256} and C <= 8, which takes every
    model's bf16 decoder tail; "fma" (fp32 tiles, the Dense on the FMA
    units) otherwise: fp32, and bf16 at other D <= 512 or C > 8."""
    if cdt == torch.bfloat16 and D in MMA_WIDTHS and C <= MMA_MAX_C:
        return "mma"
    return "fma"


def _tail_args(params, hyper, cdt):
    """The tail's parameters as the kernels take them: w and hyper in cdt,
    ln_s, ln_b, b in fp32, all contiguous."""
    s, t, w, b = params
    return (w.to(cdt).contiguous(), hyper.to(cdt).contiguous(),
            *(v.float().contiguous() for v in (s, t, b)))


def _launch_interp_upscale(h1, index, weight, params, hyper, cdt, route):
    """Launch K4 on ``route`` ("mma" or "fma"); counts nothing. The wrapper
    passes ``upscale_route``; a check may name the other route."""
    BM, G, D = h1.shape
    B, N, _ = index.shape
    if BM % B:
        raise ValueError(f"h1 batch {BM} is not a multiple of {B}")
    C = hyper.shape[1]
    h1c = h1.to(cdt).contiguous()
    idx = index.int().contiguous()
    wts = weight.float().contiguous()
    wc, hy, s, t, b = _tail_args(params, hyper, cdt)
    _cuda.require_cuda(h1c, idx, wts, wc, hy, s, t, b)
    out = torch.empty((BM, C, N), dtype=torch.float32, device=h1.device)
    p = _cuda.ptr
    code = _cuda.library().psam_interp_upscale(
        p(h1c), p(idx), p(wts), p(s), p(t), p(wc), p(b), p(hy), p(out), B, BM // B, G, N, D,
        C, _cuda.dtype_code(cdt), _ROUTES[route], _cuda.stream())
    _cuda.check("psam_interp_upscale", code)
    return out


@_cuda.counted
def interp_upscale_cuda(h1, index, weight, params, hyper, *, cdt):
    """Kernel K4 on the card, on the route ``upscale_route`` gives
    (recorded in its launch count); same contract as
    ``interp_upscale_plain``."""
    BM, G, D = h1.shape
    B, N, _ = index.shape
    C = hyper.shape[1]
    route = upscale_route(D, C, cdt)
    out = _launch_interp_upscale(h1, index, weight, params, hyper, cdt, route)
    _cuda.count_launch(interp_upscale_cuda, B=B, M=BM // B, G=G, N=N, D=D, C=C, cdt=str(cdt),
                       route=route)
    return out


def _launch_upscale_hyper(x, params, hyper, cdt, route):
    """Launch K11 on ``route``; counts nothing (see ``_launch_interp_upscale``)."""
    BM, N, D = x.shape
    C = hyper.shape[1]
    xc = x.to(cdt).contiguous()
    wc, hy, s, t, b = _tail_args(params, hyper, cdt)
    _cuda.require_cuda(xc, wc, hy, s, t, b)
    out = torch.empty((BM, C, N), dtype=torch.float32, device=x.device)
    p = _cuda.ptr
    code = _cuda.library().psam_upscale_hyper(
        p(xc), p(s), p(t), p(wc), p(b), p(hy), p(out), BM, N, D, C, _cuda.dtype_code(cdt),
        _ROUTES[route], _cuda.stream())
    _cuda.check("psam_upscale_hyper", code)
    return out


@_cuda.counted
def upscale_hyper_cuda(x, params, hyper, *, cdt):
    """Kernel K11 on the card, on the route ``upscale_route`` gives
    (recorded in its launch count); same contract as
    ``upscale_hyper_reference``.

    Args:
        x: [BM, N, D] interpolated, Dense_0-projected features.
        params: (ln_scale [D], ln_bias [D], w2 [D, D] as [in, out], b2 [D]).
        hyper: [BM, C, D].

    Returns:
        mask logits [BM, C, N] fp32.
    """
    BM, N, D = x.shape
    C = hyper.shape[1]
    route = upscale_route(D, C, cdt)
    out = _launch_upscale_hyper(x, params, hyper, cdt, route)
    _cuda.count_launch(upscale_hyper_cuda, BM=BM, N=N, D=D, C=C, cdt=str(cdt), route=route)
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


class UpscaleHyper(torch.autograd.Function):
    """K11 forward, recompute backward (``upscale_hyper_ad``): the forward
    saves no [BM, N, D] intermediate; grads go to x, the four tail
    parameters and hyper."""

    @staticmethod
    def forward(ctx, x, hyper, cdt, *params):
        ctx.cdt = cdt
        ctx.save_for_backward(x, hyper, *params)
        run = upscale_hyper_cuda if x.is_cuda else upscale_hyper_reference
        return run(x, params, hyper, cdt=cdt)

    @staticmethod
    def backward(ctx, dout):
        inputs = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with torch.enable_grad():
            out = upscale_hyper_reference(inputs[0], tuple(inputs[2:]), inputs[1], cdt=ctx.cdt)
        grads = torch.autograd.grad(out, inputs, dout)
        return (grads[0], grads[1], None, *grads[2:])


def upscale_hyper_fused(x, params, hyper, *, cdt):
    """Mask logits [BM, C, N] of pre-interpolated x [BM, N, D]: K11 on the
    card, ``upscale_hyper_reference`` on the CPU; the backward recomputes
    in plain torch on both."""
    return UpscaleHyper.apply(x, hyper, cdt, *params)


# ------------------------------------------------------------- routing
_TILE2 = 512  # the Pallas K4's point tile, which sizes its working set


def interp_upscale_dispatch_ok(n: int, g: int, d: int, c: int, cdt=torch.bfloat16,
                               m: int = 1) -> bool:
    """JAX's gate of K4 (``interp_upscale_dispatch_ok``) as a function of
    shapes alone: G <= 2048 and G % 128 == 0, D a multiple of 128 up to
    1024, C <= 8, and the Pallas kernel's whole working-set estimate within
    72 MB. The port takes K4 exactly where this holds, so both packages
    compute the same function at every shape."""
    if g > 2048 or g % 128 or d % 128 or d > 1024 or c > 8:
        return False
    ib = torch.empty((), dtype=cdt).element_size()
    t = _TILE2
    est = (
        2 * m * g * d * ib          # h1 block, double-buffered
        + t * g * (4 + 4 + ib)      # iota + fp32 one-hot accum + cdt W
        + 2 * m * c * d * 4         # hyper block, double-buffered
        + 4 * t * d * 4             # x/gl/h + LN temps (fp32)
        + 2 * m * c * t * 4         # out block, double-buffered
    )
    if est > 72 * 2**20:
        return False
    return n >= 8


def decoder_tail(h1, index, weight, params, hyper, *, cdt):
    """Mask logits [BM, C, N] of the decoder: K4 where JAX's K4 gate holds,
    else the explicit 3-NN gather and K11 (plain versions on the CPU).

    Args:
        h1: [BM, G, D] Dense_0-projected tokens (BM = B*M replicas).
        index / weight: [B, N, 3] 3-NN geometry shared by the M replicas.
        params: (ln_scale, ln_bias, w2 [in, out], b2); hyper: [BM, C, D].
    """
    BM, G, D = h1.shape
    B, N = index.shape[:2]
    if interp_upscale_dispatch_ok(N, G, D, hyper.shape[1], cdt, m=BM // B):
        return interp_upscale_hyper_fused(h1, index, weight, params, hyper, cdt=cdt)
    x = interpolate_features_repeated(h1, index, weight.detach())
    return upscale_hyper_fused(x, params, hyper, cdt=cdt)
