"""Fused PointNet patch encoder (counterpart of
point_sam_tpu/ops/patch_encoder_pallas.py; the file keeps the reference's
name so each module's counterpart is easy to find).

``patch_encoder_fused`` launches kernel K2 (``csrc/patch_encoder.cu``) on a
CUDA tensor and runs ``patch_encoder_plain`` on a CPU tensor. Both follow
the reference kernel's numerics: matmul operands in the compute dtype
``cdt`` with fp32 accumulation, the product rounded to ``cdt`` and the bias
added in ``cdt`` (flax Dense); fp32 two-pass LayerNorm statistics with
eps 1e-5; LN -> GELU fused in fp32 for ``act="erf"``, or the LN affine and
the tanh GELU in ``cdt`` for ``act="tanh"``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _cuda

_SQRT_HALF = 0.7071067811865476


def _dense(x, w, b, cdt):
    """flax Dense rounding: product of cdt operands accumulated in fp32,
    rounded to cdt, bias added in cdt. ``w`` is [in, out]."""
    y = torch.matmul(x.to(cdt).float(), w.to(cdt).float()).to(cdt)
    return y + b.to(cdt)


def gelu_erf(x32):
    """Exact-erf GELU in fp32, written as the kernels compute it."""
    return x32 * 0.5 * (1.0 + torch.erf(x32 * _SQRT_HALF))


def ln_gelu(x, scale, shift, cdt, act: str = "erf"):
    """LayerNorm (fp32 two-pass stats, eps 1e-5) -> GELU, rounded to cdt."""
    x32 = x.float()
    c = x32 - x32.mean(-1, keepdim=True)
    y = c * torch.rsqrt((c * c).mean(-1, keepdim=True) + 1e-5)
    if act == "tanh":
        yc = y.to(cdt) * scale.to(cdt) + shift.to(cdt)
        return F.gelu(yc, approximate="tanh")
    return gelu_erf(y * scale.float() + shift.float()).to(cdt)


def patch_encoder_plain(grouped, params, *, num_groups, group_size, cdt,
                        act: str = "erf"):
    """Plain torch version of kernel K2.

    Args:
        grouped: [B, G*K, C_in] group features.
        params: (w1a, b1a, ln1_scale, ln1_bias, w1b, b1b, w2a, b2a,
            ln2_scale, ln2_bias, w2b, b2b); matrices [in, out].

    Returns:
        [B, G, C_out] in cdt.
    """
    w1a, b1a, s1, t1, w1b, b1b, w2a, b2a, s2, t2, w2b, b2b = params
    B = grouped.shape[0]
    x = grouped.reshape(B, num_groups, group_size, grouped.shape[-1])
    h = _dense(x, w1a, b1a, cdt)
    h = ln_gelu(h, s1, t1, cdt, act)
    h = _dense(h, w1b, b1b, cdt)  # [B, G, K, h0]
    h0 = h.shape[-1]
    # The pooled half of the stage-2 Dense is constant over K.
    pooled = h.amax(dim=2)
    up_pool = torch.matmul(pooled.to(cdt).float(), w2a[:h0].to(cdt).float())
    up_pt = torch.matmul(h.to(cdt).float(), w2a[h0:].to(cdt).float())
    h = (up_pt + up_pool[:, :, None]).to(cdt) + b2a.to(cdt)
    h = ln_gelu(h, s2, t2, cdt, act)
    h = _dense(h, w2b, b2b, cdt)
    return h.amax(dim=2).to(cdt)


def patch_encoder_cuda(grouped, params, *, num_groups, group_size, cdt,
                       act: str = "erf"):
    """Kernel K2 on the card; same contract as ``patch_encoder_plain``."""
    w1a, b1a, s1, t1, w1b, b1b, w2a, b2a, s2, t2, w2b, b2b = params
    B, rows, cin = grouped.shape
    G, K = num_groups, group_size
    if rows != G * K:
        raise ValueError(f"grouped has {rows} rows, expected G*K = {G * K}")
    h0, h1, cout = w1a.shape[1], w2a.shape[1], w2b.shape[1]
    if w1a.shape[0] != cin or w2a.shape[0] != 2 * h0 or w2b.shape[0] != h1:
        raise ValueError("patch encoder weight shapes do not chain")
    x = grouped.to(cdt).contiguous()
    mats = [w.to(cdt).contiguous() for w in (w1a, w1b, w2a, w2b)]
    vecs = [v.float().contiguous() for v in (b1a, s1, t1, b1b, b2a, s2, t2, b2b)]
    _cuda.require_cuda(x, *mats, *vecs)
    out = torch.empty((B, G, cout), dtype=cdt, device=x.device)
    p = _cuda.ptr
    code = _cuda.library().psam_patch_encoder(
        p(x), B, G, K, cin,
        p(mats[0]), p(vecs[0]), p(vecs[1]), p(vecs[2]), p(mats[1]), p(vecs[3]),
        p(mats[2]), p(vecs[4]), p(vecs[5]), p(vecs[6]), p(mats[3]), p(vecs[7]),
        h0, h1, cout, p(out), int(act == "tanh"), _cuda.dtype_code(cdt),
        _cuda.stream())
    _cuda.check("psam_patch_encoder", code)
    patch_encoder_cuda.launches += 1
    return out


patch_encoder_cuda.launches = 0


def patch_encoder_fused(grouped, params, *, num_groups, group_size, cdt,
                        act: str = "erf"):
    """[B, G*K, C_in] -> [B, G, C_out]: K2 on the card, plain on the CPU."""
    run = patch_encoder_cuda if grouped.is_cuda else patch_encoder_plain
    return run(grouped, params, num_groups=num_groups, group_size=group_size,
               cdt=cdt, act=act)
