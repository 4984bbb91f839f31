"""Gradients of the port's kernel ops against the JAX package, on the CPU.

- K6's plain backward (``mha_packed_bwd_plain``) against the Pallas
  ``mha_packed_bwd_pallas`` in interpret mode, and the ``MhaPacked``
  autograd Function against ``jax.vjp`` of ``mha_flat`` (the CPU path
  differentiates ``mha_reference``).
- K7's plain backward (``patch_encoder_bwd_plain``) against the Pallas
  ``patch_encoder_fused_bwd`` in interpret mode, both activations, fp32 and
  bf16, and with forced ties (duplicate neighbour rows): the max-pool
  gradient goes wholly to the first duplicate, as in JAX. Each runs both
  ways: recomputing the max-pools' argmaxes, and reading them (``saved``)
  from ``patch_encoder_plain(return_argmax=True)``, as the autograd
  Function does. With the exact-erf GELU the two are bit-equal; with the
  tanh GELU the forward applies LN's affine in the compute dtype and the
  backward recomputes it in fp32 (the reference's ``_bwd_kernel`` does the
  same), so in bf16 the forward's rows differ from the recompute's in some
  columns. The backward reading them is then held to ``jax.vjp`` of the
  reference with its two max-pools routed to those rows.
- The K4 Function's recompute backward against ``jax.vjp`` of both forms
  the reference's backward recomputes: ``interp_upscale_reference_matmul``
  (its train shapes) and the gather-sum ``interp_upscale_reference``.

Tolerances: fp32 1e-5 of the largest entry (attention, patch encoder:
summation order only) and 1e-4 for the decode tail (its forward fuses
LN -> GELU where the reference does not). bf16 attention 2e-2 of the
largest entry. bf16 patch encoder: the JAX package's own XLA reference and
its Pallas backward differ by 10-20% in norm (a 1-ulp difference in a
recomputed activation moves a max-pool's first argmax to another row and
that column's gradient with it), so the port is held to 1.5x that
distance, leaf by leaf.
"""

import importlib
from contextlib import nullcontext
from unittest import mock

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from point_sam_tpu.ops import attention as JA
from point_sam_tpu.ops import patch_encoder_pallas as JPE
from point_sam_tpu.ops import upscale_pallas as JUP

A = importlib.import_module("point_sam_tpu_torch.ops.attention")
PE = importlib.import_module("point_sam_tpu_torch.ops.patch_encoder_pallas")
UP = importlib.import_module("point_sam_tpu_torch.ops.upscale_pallas")

DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def f32(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def assert_rel(got, want, rel):
    got, want = f32(got), f32(want)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= rel * np.abs(want).max() + 1e-12, (err, np.abs(want).max())


def pe_params(rng, cin, h0, h1, cout):
    def mat(i, o):
        return (rng.standard_normal((i, o)) / np.sqrt(i)).astype(np.float32)

    def vec(d, mean=0.0):
        return (mean + 0.1 * rng.standard_normal(d)).astype(np.float32)

    return (mat(cin, h0), vec(h0), vec(h0, 1.0), vec(h0), mat(h0, h0), vec(h0),
            mat(2 * h0, h1), vec(h1), vec(h1, 1.0), vec(h1), mat(h1, cout), vec(cout))


# ------------------------------------------------------------------ K6
# (dtype, B, S, heads, dh): two heads of 64 at S=128, a ragged S=200 and a
# head of 128.
K6_CASES = [(dt, *shape) for shape in ((2, 128, 2, 64), (1, 200, 2, 64), (1, 128, 2, 128))
            for dt in ("float32", "bfloat16")]


@pytest.mark.parametrize("dtype,B,S,H,dh", K6_CASES,
                         ids=["float32", "bfloat16", "float32-S200", "bfloat16-S200",
                              "float32-dh128", "bfloat16-dh128"])
def test_k6_plain_matches_pallas_backward(dtype, B, S, H, dh):
    tdt, jdt = DTYPES[dtype]
    rng = np.random.default_rng(0)
    q, k, v, do = (rng.standard_normal((B, S, H * dh)).astype(np.float32) for _ in range(4))
    want = JA.mha_packed_bwd_pallas(*(jnp.asarray(a, jdt) for a in (q, k, v, do)), H,
                                    interpret=True)
    got = A.mha_packed_bwd_plain(*(torch.from_numpy(a).to(tdt) for a in (q, k, v, do)), H)
    for g, w in zip(got, want):
        assert g.dtype == tdt
        assert_rel(g, w, 1e-5 if dtype == "float32" else 2e-2)


@pytest.mark.parametrize("H,dh", [(2, 64), (4, 32)])
def test_mha_function_grads_match_jax_vjp(H, dh):
    rng = np.random.default_rng(1)
    q, k, v, do = (rng.standard_normal((2, 96, H * dh)).astype(np.float32) for _ in range(4))
    out, vjp = jax.vjp(lambda a, b, c: JA.mha_flat(a, b, c, H, use_pallas=False),
                       *(jnp.asarray(a) for a in (q, k, v)))
    want = vjp(jnp.asarray(do))
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    got_out = A.mha_flat(*ts, H)
    assert got_out.grad_fn is not None
    assert_rel(got_out, out, 1e-5)
    got_out.backward(torch.from_numpy(do))
    for t_, w in zip(ts, want):
        assert_rel(t_.grad, w, 1e-5)


# ------------------------------------------------------------------ K7
def k7_case(rng, G=8, K=16, cin=6, cout=64, ties=False):
    params = pe_params(rng, cin, 32, 64, cout)
    x = rng.standard_normal((2, G, K, cin)).astype(np.float32)
    if ties:  # duplicate neighbour rows: exact ties in both max-pools
        x[:, :, 1] = x[:, :, 0]
        x[:, :, 7] = x[:, :, 4]
    do = rng.standard_normal((2, G, cout)).astype(np.float32)
    return x.reshape(2, G * K, cin), params, do


def pallas_bwd(x, params, do, jdt, act, G=8, K=16):
    jp = tuple(jnp.asarray(p) for p in params)
    return JPE.patch_encoder_fused_bwd(jnp.asarray(x, jdt), jp, jnp.asarray(do, jdt),
                                       num_groups=G, group_size=K, cdt=jdt, act=act,
                                       rows_target=64, interpret=True)


def forward_rows(x, params, tdt, act, G=8, K=16):
    """(pool, arg2, arg4) of ``patch_encoder_plain(return_argmax=True)``."""
    xt, pt = torch.from_numpy(x).to(tdt), tuple(torch.from_numpy(p) for p in params)
    return PE.patch_encoder_plain(xt, pt, num_groups=G, group_size=K, cdt=tdt, act=act,
                                  return_argmax=True)[1]


def port_bwd(x, params, do, tdt, act, G=8, K=16, saved=None):
    """``patch_encoder_bwd_plain``, given ``saved`` (pool, arg2, arg4) or
    recomputing them."""
    xt, pt = torch.from_numpy(x).to(tdt), tuple(torch.from_numpy(p) for p in params)
    return PE.patch_encoder_bwd_plain(xt, pt, torch.from_numpy(do).to(tdt), num_groups=G,
                                      group_size=K, cdt=tdt, act=act, saved=saved)


def reference_vjp(x, params, do, jdt, act, rows=None, G=8, K=16):
    """``jax.vjp`` of ``patch_encoder_reference``; with ``rows`` (arg2,
    arg4 [B, G, C]), its two max-pools take those rows in place of their
    own first argmax, so the gradient goes where the port's forward sent it."""
    jp = tuple(jnp.asarray(p) for p in params)
    queue = iter([] if rows is None else [jnp.asarray(r.numpy()) for r in rows])

    def take(h, axis=-2, keepdims=False):
        out = jnp.take_along_axis(h, jnp.expand_dims(next(queue), axis), axis=axis)
        return out if keepdims else jnp.squeeze(out, axis)

    with mock.patch.object(JPE, "grad_safe_max", take) if rows is not None else nullcontext():
        _, vjp = jax.vjp(lambda xx, pp: JPE.patch_encoder_reference(
            xx, pp, num_groups=G, group_size=K, cdt=jdt, act=act), jnp.asarray(x, jdt), jp)
    return vjp(jnp.asarray(do, jdt))


# (dtype, activation, saved); the recomputing cases keep their names.
K7_CASES = [pytest.param(dt, act, saved, id=f"{dt}-{act}" + ("-saved" if saved else ""))
            for saved in (False, True) for act in ("erf", "tanh")
            for dt in ("float32", "bfloat16")]


@pytest.mark.parametrize("dtype,act,saved", K7_CASES)
def test_k7_plain_matches_pallas_backward(dtype, act, saved):
    tdt, jdt = DTYPES[dtype]
    rng = np.random.default_rng(2)
    x, params, do = k7_case(rng)
    rows = forward_rows(x, params, tdt, act) if saved else None
    wdx, wdp = pallas_bwd(x, params, do, jdt, act)
    gdx, gdp = port_bwd(x, params, do, tdt, act, saved=rows)
    assert gdx.dtype == tdt and all(g.dtype == torch.float32 for g in gdp)
    if dtype == "float32":
        for g, w in zip((gdx, *gdp), (wdx, *wdp)):
            assert_rel(g, w, 1e-5)
        return
    # bf16: the reference's own XLA path is the yardstick of bf16 noise.
    rdx, rdp = reference_vjp(x, params, do, jdt, act)
    np.testing.assert_array_equal(f32(gdp[-1]), f32(wdp[-1]))  # db2b = sum of dout
    wants = [(wdx, wdp)]
    if saved:  # also the reference routed to the forward's rows; with tanh,
        # whose forward rows the Pallas backward does not take, only that.
        pinned = reference_vjp(x, params, do, jdt, act, rows=rows[1:])
        wants = [pinned] if act == "tanh" else [(wdx, wdp), pinned]
    for ydx, ydp in wants:
        for g, y, w, r in zip((gdx, *gdp), (ydx, *ydp), (wdx, *wdp), (rdx, *rdp)):
            noise = np.linalg.norm(f32(r) - f32(w))
            assert np.linalg.norm(f32(g) - f32(y)) <= 1.5 * noise + 1e-3 * np.linalg.norm(f32(y))


def check_ties_route_to_first_maximum(saved):
    """With duplicate neighbour rows, every max-pool gradient goes to the
    first duplicate (JAX's _maxpool_bwd and grad_safe_max), not split among
    the ties; the Function and the plain forward under autograd agree."""
    rng = np.random.default_rng(3)
    x, params, do = k7_case(rng, ties=True)
    wdx, wdp = pallas_bwd(x, params, do, jnp.float32, "erf")
    jp = tuple(jnp.asarray(p) for p in params)
    _, vjp = jax.vjp(lambda xx, pp: JPE.patch_encoder_reference(
        xx, pp, num_groups=8, group_size=16, cdt=jnp.float32), jnp.asarray(x), jp)
    rdx, _ = vjp(jnp.asarray(do))
    rows = forward_rows(x, params, torch.float32, "erf") if saved else None
    gdx, gdp = port_bwd(x, params, do, torch.float32, "erf", saved=rows)
    assert_rel(gdx, wdx, 1e-5)
    assert_rel(gdx, rdx, 1e-5)
    for g, w in zip(gdp, wdp):
        assert_rel(g, w, 1e-5)
    # The duplicates' gradients differ: the pooled ones went to the first.
    dx = f32(gdx).reshape(2, 8, 16, 6)
    assert np.abs(dx[:, :, 1] - dx[:, :, 0]).max() > 1e-3
    # Autograd through the Function and through the plain forward.
    for fn in (PE.patch_encoder_fused, PE.patch_encoder_plain):
        xt = torch.from_numpy(x).requires_grad_()
        pt = [torch.from_numpy(p).requires_grad_() for p in params]
        out = fn(xt, tuple(pt), num_groups=8, group_size=16, cdt=torch.float32)
        assert out.grad_fn is not None
        out.backward(torch.from_numpy(do))
        assert_rel(xt.grad, wdx, 1e-5)
        for p_, w in zip(pt, wdp):
            assert_rel(p_.grad, w, 1e-5)


def test_k7_ties_route_to_first_maximum():
    """Fault 2, with the argmaxes recomputed by the backward."""
    check_ties_route_to_first_maximum(saved=False)


def test_k7_ties_route_to_first_maximum_saved():
    """Fault 2, with the argmaxes the forward saved."""
    check_ties_route_to_first_maximum(saved=True)


def backward_rows(xt, pt, cdt, act, G=8, K=16):
    """(pool, arg2, arg4) as ``patch_encoder_bwd_plain`` recomputes them
    without ``saved`` (LN's affine and the GELU in fp32)."""
    w1a, b1a, s1, t1, w1b, b1b, w2a, b2a, s2, t2, w2b, b2b = pt
    x = xt.reshape(xt.shape[0], G, K, -1).to(cdt)
    h0 = w1a.shape[1]
    g1 = PE._act_and_grad(PE._ln_stats(PE._dense(x, w1a, b1a, cdt), s1, t1)[0], act)[0]
    a2 = PE._dense(g1.to(cdt), w1b, b1b, cdt)
    pool = a2.amax(2).to(cdt)
    up = PE._mm(a2, w2a[h0:], cdt) + PE._mm(pool, w2a[:h0], cdt)[:, :, None]
    g3 = PE._act_and_grad(PE._ln_stats(up.to(cdt) + b2a.to(cdt), s2, t2)[0], act)[0]
    a4 = PE._dense(g3.to(cdt), w2b, b2b, cdt)
    return pool, a2.float().argmax(2).int(), a4.float().argmax(2).int()


@pytest.mark.parametrize("ties", [False, True], ids=["random", "ties"])
@pytest.mark.parametrize("dtype,act", [("float32", "erf"), ("bfloat16", "erf"),
                                       ("float32", "tanh"), ("bfloat16", "tanh")])
def test_k7_saved_argmaxes_match_recompute(dtype, act, ties):
    """The backward given the forward's saved max-pools against the same
    backward recomputing them: bit-equal where both run the same arithmetic
    (erf), within fp32 rounding of pool for tanh in fp32. Given the rows its
    own recompute finds, the backward is bit-equal to recomputing them in
    every case, bf16 tanh included (whose forward rows differ: see the
    module docstring). The forward's output is bit-equal with and without
    ``return_argmax``, and the argmaxes are int32 rows in [0, K)."""
    tdt, _ = DTYPES[dtype]
    x, params, do = k7_case(np.random.default_rng(12), ties=ties)
    xt, pt = torch.from_numpy(x).to(tdt), tuple(torch.from_numpy(p) for p in params)
    kw = dict(num_groups=8, group_size=16, cdt=tdt, act=act)
    out, saved = PE.patch_encoder_plain(xt, pt, return_argmax=True, **kw)
    assert torch.equal(out, PE.patch_encoder_plain(xt, pt, **kw))
    pool, arg2, arg4 = saved
    assert pool.dtype == tdt and pool.shape == (2, 8, 32)
    assert arg2.dtype == arg4.dtype == torch.int32 and arg4.shape == (2, 8, 64)
    assert 0 <= int(arg2.min()) and int(max(arg2.max(), arg4.max())) < 16
    if ties:  # rows 1 and 7 duplicate rows 0 and 4: never the first maximum
        for arg in (arg2, arg4):
            assert not ((arg == 1) | (arg == 7)).any()
    d = torch.from_numpy(do).to(tdt)
    want = PE.patch_encoder_bwd_plain(xt, pt, d, **kw)
    own = PE.patch_encoder_bwd_plain(xt, pt, d, saved=backward_rows(xt, pt, tdt, act), **kw)
    for g, w in zip((own[0], *own[1]), (want[0], *want[1])):
        assert torch.equal(g, w)
    if (dtype, act) == ("bfloat16", "tanh"):
        return
    got = PE.patch_encoder_bwd_plain(xt, pt, d, saved=saved, **kw)
    for g, w in zip((got[0], *got[1]), (want[0], *want[1])):
        if act == "erf":
            assert torch.equal(g, w)
        else:
            assert_rel(g, w, 1e-5)


def test_patch_encoder_fused_saves_argmaxes_only_for_grads(monkeypatch):
    """The Function asks the forward for the argmaxes, and saves them with
    the inputs, only when a grad is needed; each call saves its own."""
    asked = []
    plain = PE.patch_encoder_plain

    def spy(*args, **kw):
        asked.append(kw.get("return_argmax", False))
        return plain(*args, **kw)

    monkeypatch.setattr(PE, "patch_encoder_plain", spy)
    x, params, _ = k7_case(np.random.default_rng(13))
    kw = dict(num_groups=8, group_size=16, cdt=torch.float32)
    xt = torch.from_numpy(x)
    pt = tuple(torch.from_numpy(p) for p in params)
    out = PE.patch_encoder_fused(xt, pt, **kw)
    assert out.grad_fn is None
    pt = tuple(p.requires_grad_() for p in pt)
    with torch.no_grad():
        PE.patch_encoder_fused(xt, pt, **kw)
    assert asked == [False, False]
    first = PE.patch_encoder_fused(xt, pt, **kw)
    second = PE.patch_encoder_fused(xt * 2, pt, **kw)
    assert asked == [False, False, True, True]
    for o in (first, second):  # grouped, 12 parameters, pool, arg2, arg4
        saved = o.grad_fn.saved_tensors
        assert len(saved) == 16 and saved[-1].dtype == torch.int32
    assert not torch.equal(first.grad_fn.saved_tensors[-3], second.grad_fn.saved_tensors[-3])
    assert torch.equal(out, first.detach())


# ------------------------------------------------------------------ K4
@pytest.mark.parametrize("form", ["interp_upscale_reference_matmul",
                                  "interp_upscale_reference"])
def test_k4_function_grads_match_jax_vjp(form):
    rng = np.random.default_rng(4)
    B, M, G, N, D, C = 2, 2, 24, 150, 64, 3
    h1 = rng.standard_normal((B * M, G, D)).astype(np.float32)
    idx = rng.integers(0, G, (B, N, 3)).astype(np.int32)
    idx[0, :5, 1] = idx[0, :5, 0]  # equal indices add
    w = rng.dirichlet(np.ones(3), (B, N)).astype(np.float32)
    params = ((1.0 + 0.1 * rng.standard_normal(D)).astype(np.float32),
              (0.1 * rng.standard_normal(D)).astype(np.float32),
              (rng.standard_normal((D, D)) / np.sqrt(D)).astype(np.float32),
              (0.1 * rng.standard_normal(D)).astype(np.float32))
    hyper = rng.standard_normal((B * M, C, D)).astype(np.float32)
    dout = rng.standard_normal((B * M, C, N)).astype(np.float32)

    out, vjp = jax.vjp(lambda h, p, hy: getattr(JUP, form)(
        h, jnp.asarray(idx), jnp.asarray(w), p, hy, cdt=jnp.float32),
        jnp.asarray(h1), tuple(jnp.asarray(p) for p in params), jnp.asarray(hyper))
    wh, wp, why = vjp(jnp.asarray(dout))

    th = torch.from_numpy(h1).requires_grad_()
    tp = [torch.from_numpy(p).requires_grad_() for p in params]
    thy = torch.from_numpy(hyper).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    got = UP.interp_upscale_hyper_fused(th, torch.from_numpy(idx), tw, tuple(tp), thy,
                                        cdt=torch.float32)
    assert got.grad_fn is not None
    assert_rel(got, out, 1e-4)
    got.backward(torch.from_numpy(dout))
    assert tw.grad is None  # stop-gradient geometry
    assert_rel(th.grad, wh, 1e-4)
    assert_rel(thy.grad, why, 1e-4)
    for g, want in zip(tp, wp):
        assert_rel(g.grad, want, 1e-4)
