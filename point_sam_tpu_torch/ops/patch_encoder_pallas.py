"""Fused PointNet patch encoder (counterpart of
point_sam_tpu/ops/patch_encoder_pallas.py; the file keeps the reference's
name so each module's counterpart is easy to find).

``patch_encoder_fused`` runs the ``PatchEncoderFused`` autograd Function
(the counterpart of ``patch_encoder_fused_ad``):

- forward: kernel K2 (``csrc/patch_encoder.cu``) on a CUDA tensor,
  ``patch_encoder_plain`` on a CPU tensor; when a grad is needed it also
  returns, and the Function saves, both max-pools' first argmaxes;
- backward: kernel K7 (``csrc/patch_encoder_bwd.cu``, replacing
  ``patch_encoder_fused_bwd``) on a CUDA tensor,
  ``patch_encoder_bwd_plain`` on a CPU tensor, both routing the max-pool
  gradients to the saved rows.

All follow the reference kernels' numerics: matmul operands in the compute
dtype ``cdt`` with fp32 accumulation, the product rounded to ``cdt`` and
the bias added in ``cdt`` (flax Dense); fp32 two-pass LayerNorm statistics
with eps 1e-5; LN -> GELU fused in fp32 for ``act="erf"``, or the LN affine
and the tanh GELU in ``cdt`` for ``act="tanh"``. Both max-pools send their
gradient to the FIRST maximal element of each column (torch ``max`` and
the reference's ``_maxpool_bwd``); in bf16 ties among K neighbours are
common, so the routing is part of the numerics.
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


def first_max(x, dim: int):
    """Max over ``dim`` whose gradient goes wholly to the first maximal
    element (``amax`` would split it among ties)."""
    idx = x.argmax(dim, keepdim=True)
    return torch.take_along_dim(x, idx, dim).squeeze(dim)


def patch_encoder_plain(grouped, params, *, num_groups, group_size, cdt,
                        act: str = "erf", return_argmax: bool = False):
    """Plain torch version of kernel K2.

    Args:
        grouped: [B, G*K, C_in] group features.
        params: (w1a, b1a, ln1_scale, ln1_bias, w1b, b1b, w2a, b2a,
            ln2_scale, ln2_bias, w2b, b2b); matrices [in, out].
        return_argmax: also return what the backward needs of the
            max-pools (see Returns).

    Returns:
        [B, G, C_out] in cdt; with ``return_argmax``, (that, (pool, arg2,
        arg4)): pool [B, G, h0] in cdt, the max over K of the stage-1 output
        a2, and arg2 [B, G, h0] / arg4 [B, G, C_out] (int32) the first row at
        which a2 / the last Dense's output reach their max over K.
    """
    w1a, b1a, s1, t1, w1b, b1b, w2a, b2a, s2, t2, w2b, b2b = params
    B = grouped.shape[0]
    x = grouped.reshape(B, num_groups, group_size, grouped.shape[-1])
    h = _dense(x, w1a, b1a, cdt)
    h = ln_gelu(h, s1, t1, cdt, act)
    a2 = _dense(h, w1b, b1b, cdt)  # [B, G, K, h0]
    h0 = a2.shape[-1]
    # The pooled half of the stage-2 Dense is constant over K.
    pooled = first_max(a2, 2)
    up_pool = torch.matmul(pooled.to(cdt).float(), w2a[:h0].to(cdt).float())
    up_pt = torch.matmul(a2.to(cdt).float(), w2a[h0:].to(cdt).float())
    h = (up_pt + up_pool[:, :, None]).to(cdt) + b2a.to(cdt)
    h = ln_gelu(h, s2, t2, cdt, act)
    a4 = _dense(h, w2b, b2b, cdt)
    out = first_max(a4, 2).to(cdt)
    if not return_argmax:
        return out
    saved = (pooled.to(cdt), a2.argmax(2).to(torch.int32), a4.argmax(2).to(torch.int32))
    return out, tuple(t.detach() for t in saved)


@_cuda.counted
def patch_encoder_cuda(grouped, params, *, num_groups, group_size, cdt,
                       act: str = "erf", return_argmax: bool = False):
    """Kernel K2 on the card; same contract as ``patch_encoder_plain``. Without
    ``return_argmax`` the kernel stores only the output."""
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
    saved = (None, None, None)
    if return_argmax:
        saved = (torch.empty((B, G, h0), dtype=cdt, device=x.device),
                 torch.empty((B, G, h0), dtype=torch.int32, device=x.device),
                 torch.empty((B, G, cout), dtype=torch.int32, device=x.device))
    p = _cuda.ptr
    code = _cuda.library().psam_patch_encoder(
        p(x), B, G, K, cin,
        p(mats[0]), p(vecs[0]), p(vecs[1]), p(vecs[2]), p(mats[1]), p(vecs[3]),
        p(mats[2]), p(vecs[4]), p(vecs[5]), p(vecs[6]), p(mats[3]), p(vecs[7]),
        h0, h1, cout, p(out), *(p(t) for t in saved), int(act == "tanh"),
        _cuda.dtype_code(cdt), _cuda.stream())
    _cuda.check("psam_patch_encoder", code)
    _cuda.count_launch(patch_encoder_cuda, B=B, G=G, K=K, cin=cin, h0=h0, h1=h1, cout=cout,
                       cdt=str(cdt), act=act, argmax=return_argmax)
    return (out, saved) if return_argmax else out



_GELU_C0 = 0.7978845608028654  # sqrt(2/pi)
_GELU_C1 = 0.044715


def _act_and_grad(y32, act: str):
    """(GELU(y), GELU'(y)) in fp32, as the reference backward recomputes
    them from the fp32 LN output (``_act`` / ``_act_grad``)."""
    if act == "tanh":
        y2 = y32 * y32
        t = torch.tanh(_GELU_C0 * (y32 + _GELU_C1 * y32 * y2))
        du = _GELU_C0 * (1.0 + 3.0 * _GELU_C1 * y2)
        return 0.5 * y32 * (1.0 + t), 0.5 * (1.0 + t) + 0.5 * y32 * (1.0 - t * t) * du
    cdf = 0.5 * (1.0 + torch.erf(y32 * _SQRT_HALF))
    return y32 * cdf, cdf + y32 * torch.exp(-0.5 * y32 * y32) * 0.3989422804014327


def _ln_stats(a, scale, shift):
    """(fp32 LN output, mean, 1/std) with two-pass statistics."""
    x32 = a.float()
    m = x32.mean(-1, keepdim=True)
    c = x32 - m
    inv = torch.rsqrt((c * c).mean(-1, keepdim=True) + 1e-5)
    return c * inv * scale.float() + shift.float(), m, inv


def _ln_bwd(dy, a, m, inv, scale):
    """LN backward: (da fp32, dscale, dshift) summed over every row."""
    xhat = (a.float() - m) * inv
    dxhat = dy * scale.float()
    da = inv * (dxhat - dxhat.mean(-1, keepdim=True)
                - xhat * (dxhat * xhat).mean(-1, keepdim=True))
    rows = tuple(range(dy.dim() - 1))
    return da, (dy * xhat).sum(rows), dy.sum(rows)


def _maxpool_bwd(dpool, rows, k: int):
    """Backward of the max over K (dim 2) of a [B, G, K, C]: dpool [B, G, C]
    goes wholly to row ``rows`` [B, G, C] of each column, its first maximal
    row (``argmax``)."""
    hot = torch.arange(k, device=dpool.device)[None, None, :, None] == rows.long()[:, :, None]
    return hot * dpool[:, :, None, :]


def _mm(a, b, cdt):
    """fp32 product of two operands rounded to cdt (fp32 accumulation)."""
    return torch.matmul(a.to(cdt).float(), b.to(cdt).float())


def _tn(a, b):
    """sum over every leading axis of a^T b: [..., m], [..., n] -> [m, n]."""
    return torch.matmul(a.reshape(-1, a.shape[-1]).float().t(), b.reshape(-1, b.shape[-1]).float())


def patch_encoder_bwd_plain(grouped, params, dout, *, num_groups, group_size, cdt,
                            act: str = "erf", saved=None):
    """Plain torch version of kernel K7, the arithmetic of the reference's
    ``_bwd_kernel``: the forward recomputed as K2 computes it, then the
    backward chain with matmul operands rounded to cdt where the reference
    rounds them (da4c, da3, da2c, da1) and fp32 accumulation.

    Args:
        grouped: [B, G*K, C_in]; params: the 12 parameters of
            ``patch_encoder_plain``; dout: [B, G, C_out].
        saved: the forward's (pool, arg2, arg4) (``patch_encoder_plain`` /
            ``patch_encoder_cuda`` with ``return_argmax``): the max-pool
            gradients go to those rows and ``pool`` is used as it is. None:
            both max-pools and their first argmaxes are recomputed here.

    Returns:
        (dgrouped [B, G*K, C_in] in grouped's dtype, 12 fp32 parameter
        grads summed over every patch, in the parameters' shapes).
    """
    w1a, b1a, s1, t1, w1b, b1b, w2a, b2a, s2, t2, w2b, b2b = params
    B = grouped.shape[0]
    x = grouped.reshape(B, num_groups, group_size, grouped.shape[-1]).to(cdt)
    h0 = w1a.shape[1]
    w2_pool, w2_pt = w2a[:h0], w2a[h0:]
    # Forward recompute.
    a1 = _dense(x, w1a, b1a, cdt)
    l1, m1, inv1 = _ln_stats(a1, s1, t1)
    g1 = _act_and_grad(l1, act)[0].to(cdt)
    a2 = _dense(g1, w1b, b1b, cdt)
    if saved is None:
        pool, arg2 = a2.amax(2).to(cdt), a2.float().argmax(2)
    else:
        pool, arg2, arg4 = saved
        pool = pool.to(cdt)
    up = _mm(a2, w2_pt, cdt) + _mm(pool, w2_pool, cdt)[:, :, None]
    a3 = up.to(cdt) + b2a.to(cdt)
    l3, m3, inv3 = _ln_stats(a3, s2, t2)
    g3, dact3 = _act_and_grad(l3, act)
    g3 = g3.to(cdt)
    if saved is None:  # the last Dense's output matters only for its argmax
        arg4 = _dense(g3, w2b, b2b, cdt).float().argmax(2)
    # Backward.
    da4 = _maxpool_bwd(dout.float(), arg4, group_size)
    da4c = da4.to(cdt)
    dw2b = _tn(g3, da4c)
    db2b = da4.sum((0, 1, 2))
    dl3 = _mm(da4c, w2b.t(), cdt) * dact3
    da3_32, ds2, dt2 = _ln_bwd(dl3, a3, m3, inv3, s2)
    da3 = da3_32.to(cdt)
    da3_sum = da3_32.sum(2).to(cdt)  # [B, G, h1]
    dw2a = torch.cat([_tn(pool, da3_sum), _tn(a2, da3)], 0)
    db2a = da3_32.sum((0, 1, 2))
    dpool = _mm(da3_sum, w2_pool.t(), cdt)
    da2 = _mm(da3, w2_pt.t(), cdt) + _maxpool_bwd(dpool, arg2, group_size)
    da2c = da2.to(cdt)
    dw1b = _tn(g1, da2c)
    db1b = da2.sum((0, 1, 2))
    dl1 = _mm(da2c, w1b.t(), cdt) * _act_and_grad(l1, act)[1]
    da1_32, ds1, dt1 = _ln_bwd(dl1, a1, m1, inv1, s1)
    da1 = da1_32.to(cdt)
    dw1a = _tn(x, da1)
    db1a = da1_32.sum((0, 1, 2))
    dx = _mm(da1, w1a.t(), cdt).to(grouped.dtype).reshape(grouped.shape)
    return dx, (dw1a, db1a, ds1, dt1, dw1b, db1b, dw2a, db2a, ds2, dt2, dw2b, db2b)


@_cuda.counted
def patch_encoder_bwd_cuda(grouped, params, dout, *, num_groups, group_size, cdt, saved,
                           act: str = "erf", need_dx: bool = True):
    """Kernel K7 on the card; same contract as ``patch_encoder_bwd_plain``
    (dgrouped is None when ``need_dx`` is False), except that ``saved`` is
    required: K7 reads the max-pools and their argmaxes that
    ``patch_encoder_cuda(return_argmax=True)`` gave.

    The parameter grads are summed per persistent block into an fp32
    workspace slice, then the slices are added in a fixed order by a
    second launch, so the grads are the same from run to run.
    """
    w1a, b1a, s1, t1, w1b, b1b, w2a, b2a, s2, t2, w2b, b2b = params
    B, rows, cin = grouped.shape
    G, K = num_groups, group_size
    if rows != G * K:
        raise ValueError(f"grouped has {rows} rows, expected G*K = {G * K}")
    h0, h1, cout = w1a.shape[1], w2a.shape[1], w2b.shape[1]
    if w1a.shape[0] != cin or w2a.shape[0] != 2 * h0 or w2b.shape[0] != h1:
        raise ValueError("patch encoder weight shapes do not chain")
    if dout.shape != (B, G, cout):
        raise ValueError(f"dout shape {tuple(dout.shape)} != {(B, G, cout)}")
    pool, arg2, arg4 = saved
    if (pool.shape, arg2.shape, arg4.shape) != ((B, G, h0), (B, G, h0), (B, G, cout)) or \
            (arg2.dtype, arg4.dtype) != (torch.int32, torch.int32):
        raise ValueError("saved max-pools do not match: want pool, arg2 [B, G, h0] and "
                         "arg4 [B, G, C_out], the argmaxes int32")
    pool, arg2, arg4 = pool.to(cdt).contiguous(), arg2.contiguous(), arg4.contiguous()
    x = grouped.to(cdt).contiguous()
    do = dout.to(cdt).contiguous()
    # Matrices [in, out] for the forward recompute, and transposed copies
    # [out, in] for the products with the output-side gradients.
    mats = [w.to(cdt).contiguous() for w in (w1a, w1b, w2a)]
    tmats = [w.to(cdt).t().contiguous() for w in (w1a, w1b, w2a[:h0], w2a[h0:], w2b)]
    vecs = [v.float().contiguous() for v in (b1a, s1, t1, b1b, b2a, s2, t2)]
    _cuda.require_cuda(x, do, pool, arg2, arg4, *mats, *tmats, *vecs)
    sizes = [p.numel() for p in params]
    grads = torch.empty(sum(sizes), dtype=torch.float32, device=x.device)
    dx = torch.empty_like(x) if need_dx else None
    lib = _cuda.library()
    slices = lib.psam_patch_encoder_bwd_slices(B * G)
    work = torch.zeros((slices, sum(sizes)), dtype=torch.float32, device=x.device)
    da2 = torch.empty((B * G * K, h0), dtype=torch.float32, device=x.device)
    p = _cuda.ptr
    code = lib.psam_patch_encoder_bwd(
        p(x), p(do), p(pool), p(arg2), p(arg4), B, G, K, cin,
        p(mats[0]), p(vecs[0]), p(vecs[1]), p(vecs[2]), p(mats[1]), p(vecs[3]),
        p(mats[2]), p(vecs[4]), p(vecs[5]), p(vecs[6]),
        p(tmats[0]), p(tmats[1]), p(tmats[2]), p(tmats[3]), p(tmats[4]),
        h0, h1, cout, p(dx), p(da2), p(work), slices, p(grads), int(act == "tanh"),
        _cuda.dtype_code(cdt), _cuda.stream())
    _cuda.check("psam_patch_encoder_bwd", code)
    _cuda.count_launch(patch_encoder_bwd_cuda, B=B, G=G, K=K, cin=cin, h0=h0, h1=h1,
                       cout=cout, cdt=str(cdt), act=act, need_dx=need_dx)
    dparams = tuple(g.view(p_.shape) for g, p_ in zip(grads.split(sizes), params))
    if dx is not None:
        dx = dx.to(grouped.dtype)
    return dx, dparams



class PatchEncoderFused(torch.autograd.Function):
    """The fused PointNet with a kernel backward (``patch_encoder_fused_ad``):
    K2 / K7 on CUDA tensors, the plain versions on CPU tensors. When a grad
    is needed (``keep``) it saves the grouped input, the parameters and the
    forward's max-pools with their first argmaxes (each call its own); the
    backward recomputes the hidden activations. dgrouped is computed only
    when it is needed."""

    @staticmethod
    def forward(ctx, grouped, num_groups, group_size, cdt, act, keep, *params):
        cfg = dict(num_groups=num_groups, group_size=group_size, cdt=cdt, act=act)
        run = patch_encoder_cuda if grouped.is_cuda else patch_encoder_plain
        if not keep:
            return run(grouped, params, **cfg)
        ctx.cfg = cfg
        out, saved = run(grouped, params, return_argmax=True, **cfg)
        ctx.save_for_backward(grouped, *params, *saved)
        return out

    @staticmethod
    def backward(ctx, dout):
        grouped, *rest = ctx.saved_tensors
        params, saved = rest[:-3], tuple(rest[-3:])
        need_dx = ctx.needs_input_grad[0]
        if grouped.is_cuda:
            dx, dparams = patch_encoder_bwd_cuda(grouped, params, dout, need_dx=need_dx,
                                                 saved=saved, **ctx.cfg)
        else:
            dx, dparams = patch_encoder_bwd_plain(grouped, params, dout, saved=saved,
                                                  **ctx.cfg)
        dparams = tuple(d.to(p.dtype) for d, p in zip(dparams, params))
        return (dx if need_dx else None, None, None, None, None, None, *dparams)


def patch_encoder_fused(grouped, params, *, num_groups, group_size, cdt,
                        act: str = "erf"):
    """[B, G*K, C_in] -> [B, G, C_out]: K2 (forward) and K7 (backward) on
    the card, their plain versions on the CPU."""
    keep = torch.is_grad_enabled() and (grouped.requires_grad
                                        or any(p.requires_grad for p in params))
    return PatchEncoderFused.apply(grouped, num_groups, group_size, cdt, act, keep, *params)
