"""Fused mask-decoder tail (counterpart of point_sam_tpu/ops/upscale_pallas.py;
the file keeps the reference's name so each counterpart is easy to find).

``interp_upscale_hyper_fused``: 3-NN interpolation of the Dense_0-projected
tokens h1, then LN -> GELU -> Dense -> GELU, then the dot with the
hypernetwork rows, giving mask logits. On a CUDA tensor it launches kernel
K4 (``csrc/upscale.cu``); on a CPU tensor it runs ``interp_upscale_plain``.
"""

from __future__ import annotations

import torch

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
    interp_upscale_cuda.launches += 1
    return out


interp_upscale_cuda.launches = 0


def interp_upscale_hyper_fused(h1, index, weight, params, hyper, *, cdt):
    """Mask logits [BM, C, N]: K4 on the card, plain on the CPU."""
    run = interp_upscale_cuda if h1.is_cuda else interp_upscale_plain
    return run(h1, index, weight, params, hyper, cdt=cdt)
