"""Kernels K9 (fused tokenizer geometry) and K11 (decoder tail on
pre-interpolated rows) of the port against the JAX package's Pallas
kernels, and the decoder-tail routing against JAX's predicates.

- ``fps_interp_knn_plain`` against ``fps_interp_knn_pallas`` in interpret
  mode, on the inputs tests/test_ops_geometry.py gives it: every output
  equal (indices, centres, the interp triplets and their d^2 bit for bit,
  and the kNN ids).
- ``upscale_hyper_reference`` against ``upscale_hyper_fused`` in interpret
  mode at tests/test_upscale_fused.py's shapes (within 1e-4: the Pallas
  kernel's erf polynomial against torch's erf, as that file allows), and
  the K11 autograd Function's gradients against ``jax.vjp`` of
  ``upscale_hyper_ad`` (within 1e-5 of the largest entry: both recompute
  the same fp32 chain).
- the decoder tail's K4 gate ``interp_upscale_dispatch_ok`` against
  JAX's, and ``fused_geometry_ok`` against the gate of JAX's
  ``fps_with_interp_knn``, each with the TPU backend faked.

The kernels against their plain versions on the card are in
tests/test_torch_port_kernels.py, which imports no JAX.
"""

import importlib
import itertools
from functools import partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

JF = importlib.import_module("point_sam_tpu.ops.fps")
JFP = importlib.import_module("point_sam_tpu.ops.fps_pallas")
JUP = importlib.import_module("point_sam_tpu.ops.upscale_pallas")
F = importlib.import_module("point_sam_tpu_torch.ops.fps")
UP = importlib.import_module("point_sam_tpu_torch.ops.upscale_pallas")
P = importlib.import_module("point_sam_tpu_torch.models")


def t(a):
    return torch.from_numpy(np.array(a))


def n(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


def assert_rel(got, want, rel):
    """max |got - want| <= rel * max |want|."""
    err = np.abs(n(got) - n(want)).max()
    assert err <= rel * np.abs(n(want)).max(), (err, np.abs(n(want)).max())


# ------------------------------------------------------------------ K9
def k9_case(case):
    rng = np.random.default_rng(0)
    pts = rng.standard_normal((1, 1500, 3)).astype(np.float32)
    valid, l_lanes, k = None, 512, 16
    if case == "binned":  # n_pad 2048, 256 bins of 2 points: the fold decides
        pts = rng.standard_normal((1, 1800, 3)).astype(np.float32)
        l_lanes = 128
    elif case == "valid":  # the first point and a tail invalid
        valid = np.ones((1, 1500), bool)
        valid[:, 1100:] = False
        valid[:, 0] = False
    elif case == "ties":  # duplicated points: exact ties in FPS, interp and kNN
        pts = np.tile(rng.standard_normal((1, 700, 3)).astype(np.float32), (1, 2, 1))
        k = 8
    return pts, valid, l_lanes, k


@pytest.mark.parametrize("case", ["small", "binned", "valid", "ties"])
def test_k9_plain_matches_pallas(case):
    pts, valid, l_lanes, k = k9_case(case)
    jv = None if valid is None else jnp.asarray(valid)
    want = JFP.fps_interp_knn_pallas(jnp.asarray(pts), 128, k, valid=jv, l_lanes=l_lanes,
                                     interpret=True)
    got = F.fps_interp_knn_plain(t(pts), 128, k, valid=None if valid is None else t(valid),
                                 l_lanes=l_lanes)
    names = ("fps_idx", "centers", "interp_idx", "interp_d2", "knn_idx")
    for name, g, w in zip(names, got, want):
        assert g.dtype == (torch.float32 if name in ("centers", "interp_d2") else torch.int32)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    # Selection and interp are K1's.
    ref = F.fps_interp_plain(t(pts), 128, valid=None if valid is None else t(valid))
    for g, w in zip(got[:4], ref):
        assert torch.equal(g, w)


def test_bins_top_k_breaks_ties_to_the_lower_bin():
    """Equal distances (and empty +inf bins) go to the lower bin, as
    ``lax.top_k`` orders them; ids of empty bins are clamped to N - 1."""
    cd = np.array([[[2.0, 1.0, 1.0, np.inf, 0.0, 1.0, np.inf, np.inf]]], np.float32)
    ci = np.arange(8, dtype=np.int32)[None, None] * 10
    got = F.bins_top_k(t(cd), t(ci), 7, 65)
    np.testing.assert_array_equal(got.numpy(), [[[40, 10, 20, 50, 0, 30, 60]]])
    _, pos = jax.lax.top_k(-jnp.asarray(cd), 7)
    want = np.minimum(np.take_along_axis(ci, np.asarray(pos), -1), 64)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("B,N,G,k", [
    (1, 100_000, 2048, 256), (1, 16_384, 128, 5), (2, 100_000, 2048, 256),
    (1, 16_383, 2048, 256), (1, 400_001, 2048, 256), (1, 100_000, 2176, 256),
    (1, 100_000, 1000, 256), (1, 100_000, 128, 4), (1, 100_000, 128, 1025),
    (1, 100_000, 1024, 64), (1, 400_000, 2048, 1024), (1, 131_072, 4096, 32),
])
def test_fused_geometry_gate_matches_jax(monkeypatch, B, N, G, k):
    """The port's shape gate against JAX's gate with the TPU backend,
    PSAM_FUSED_GEOM=1 and its default recall target 0.9: JAX calls its
    kernel exactly where the port takes K9."""
    monkeypatch.setenv("PSAM_FUSED_GEOM", "1")
    called = []

    def fake_kernel(points, num_samples, k, *, valid=None):
        called.append(True)
        z = jnp.zeros((B, N, 3), jnp.float32)
        return (jnp.zeros((B, num_samples), jnp.int32), z[:, :num_samples], z.astype(jnp.int32),
                z + 1.0, jnp.zeros((B, num_samples, k), jnp.int32))

    monkeypatch.setattr(JFP, "fps_interp_knn_pallas", fake_kernel)
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    points = jax.ShapeDtypeStruct((B, N, 3), jnp.float32)
    out = jax.eval_shape(lambda p: JF.fps_with_interp_knn(p, G, k, recall_target=0.9), points)
    assert (out is not None) == bool(called)
    assert F.fused_geometry_ok(B, N, G, k) == bool(called)


def test_compute_geometry_on_the_cpu_composes():
    """``knn_method="approx"`` on a CPU tensor takes K9's plain version
    where the gate holds and, where it fails, K1 and the approximate
    search (K12's plain version over ``approx_bins``); "auto" composes K1
    and the exact kNN."""
    rng = np.random.default_rng(1)
    coords = t(rng.uniform(-1, 1, (1, 16_384, 3)).astype(np.float32))
    approx = P.TokenizerConfig(num_patches=128, patch_size=16, knn_method="approx")
    got = P.compute_geometry(coords, approx)
    fps_idx, centers, _, _, knn_idx = F.fps_interp_knn_plain(coords, 128, 16)
    for key, want in (("fps_idx", fps_idx), ("centers", centers), ("knn_idx", knn_idx)):
        assert torch.equal(got[key], want), key
    want = P.compute_geometry(coords, P.TokenizerConfig(num_patches=128, patch_size=16))
    for key in ("fps_idx", "centers", "interp_index", "interp_weight"):
        assert torch.equal(got[key], want[key]), key
    assert not torch.equal(got["knn_idx"], want["knn_idx"])
    small = coords[:, :2000]  # below the gate's 16384 points
    got = P.compute_geometry(small, approx)
    fps_idx, centers, idx, w = F.fps_with_interp(small, 128, with_centers=True)
    bins = importlib.import_module("point_sam_tpu_torch.ops.knn").approx_bins(2000, 16, 0.9)[0]
    assert bins < 2000
    _, knn_idx = importlib.import_module("point_sam_tpu_torch.ops.knn").knn_select_plain(
        centers, small, 16, bins=bins)
    for key, want in (("fps_idx", fps_idx), ("centers", centers), ("interp_index", idx),
                      ("interp_weight", w), ("knn_idx", knn_idx)):
        assert torch.equal(got[key], want), key


# ----------------------------------------------------------------- K11
def upscale_inputs(rng, bm=2, nq=192, d=128, c=3):
    """(x, params, hyper) as tests/test_upscale_fused.py makes them."""
    x = rng.standard_normal((bm, nq, d)).astype(np.float32)
    params = ((rng.standard_normal(d) * 0.2 + 1.0).astype(np.float32),
              (rng.standard_normal(d) * 0.1).astype(np.float32),
              (rng.standard_normal((d, d)) / np.sqrt(d)).astype(np.float32),
              (rng.standard_normal(d) * 0.1).astype(np.float32))
    hyper = rng.standard_normal((bm, c, d)).astype(np.float32)
    return x, params, hyper


@pytest.mark.parametrize("bm,nq,c", [(2, 192, 3), (1, 64, 1), (3, 104, 4)])
def test_k11_plain_matches_pallas(bm, nq, c):
    x, params, hyper = upscale_inputs(np.random.default_rng(2), bm, nq, c=c)
    want = JUP.upscale_hyper_fused(jnp.asarray(x), tuple(map(jnp.asarray, params)),
                                   jnp.asarray(hyper), cdt=jnp.float32, rows_target=64,
                                   interpret=True)
    got = UP.upscale_hyper_reference(t(x), tuple(map(t, params)), t(hyper), cdt=torch.float32)
    assert got.shape == (bm, c, nq) and got.dtype == torch.float32
    np.testing.assert_allclose(n(got), np.asarray(want), atol=1e-4, rtol=1e-4)
    # The Function's forward on the CPU is the plain version.
    fn = UP.upscale_hyper_fused(t(x), tuple(map(t, params)), t(hyper), cdt=torch.float32)
    assert torch.equal(fn, got)


def test_k11_function_grads_match_jax_vjp():
    """The Function's backward (a recompute of the reference) against
    ``jax.vjp`` of ``upscale_hyper_reference``, which ``upscale_hyper_ad``'s
    backward differentiates."""
    rng = np.random.default_rng(3)
    x, params, hyper = upscale_inputs(rng, 2, 96)
    dout = rng.standard_normal((2, 3, 96)).astype(np.float32)
    jx = (jnp.asarray(x), tuple(map(jnp.asarray, params)), jnp.asarray(hyper))
    out, vjp = jax.vjp(lambda a, p, h: JUP.upscale_hyper_reference(a, p, h, cdt=jnp.float32),
                       *jx)
    dx, dparams, dhyper = vjp(jnp.asarray(dout))
    tx, thy = t(x).requires_grad_(), t(hyper).requires_grad_()
    tparams = tuple(t(p).requires_grad_() for p in params)
    got = UP.upscale_hyper_fused(tx, tparams, thy, cdt=torch.float32)
    assert got.grad_fn is not None
    np.testing.assert_allclose(n(got), np.asarray(out), atol=1e-4, rtol=1e-4)
    got.backward(t(dout))
    for g, w in zip((tx.grad, thy.grad, *(p.grad for p in tparams)),
                    (dx, dhyper, *dparams)):
        assert_rel(g, np.asarray(w), 1e-5)


# -------------------------------------------------------------- routing
ROUTE_GRID = list(itertools.product(
    (7, 8, 1200, 131072, 100_000),   # N
    (64, 128, 1024, 2048, 2176, 4096),  # G
    (64, 128, 256, 1152),             # D
    (1, 3, 9),                        # C
    (1, 2, 8),                        # M
))


def test_tail_route_matches_jax_predicates(monkeypatch):
    """K4 exactly where JAX's decoder takes its K4; K11 wherever JAX takes
    its K11 or its module path (the port has no plain branch on the card).
    The grid reaches all three of JAX's routes."""
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    counts = {"K4": 0, "K11": 0, "module": 0}
    for N, G, D, C, M in ROUTE_GRID:
        for cdt, jdt in ((torch.bfloat16, jnp.bfloat16), (torch.float32, jnp.float32)):
            if JUP.interp_upscale_dispatch_ok(N, G, D, C, jdt, m=M):
                jax_route = "K4"
            elif JUP.upscale_dispatch_ok(N, D, C, jdt):
                jax_route = "K11"
            else:
                jax_route = "module"
            counts[jax_route] += 1
            got = UP.interp_upscale_dispatch_ok(N, G, D, C, cdt, m=M)
            assert got == (jax_route == "K4"), (N, G, D, C, M, cdt)
    assert min(counts.values()) > 0, counts


@pytest.mark.parametrize("g", [64, 128])
def test_decoder_tail_routes_and_matches_the_chain(monkeypatch, g):
    """On the CPU ``decoder_tail`` takes the route its K4 gate names and
    gives the gather-then-tail chain's logits (fp32, within 1e-5)."""
    taken = []
    for name in ("InterpUpscale", "UpscaleHyper"):
        fn = getattr(UP, name)
        monkeypatch.setattr(fn, "apply", partial(lambda f, nm, *a: (taken.append(nm), f(*a))[1],
                                                 fn.apply, name))
    rng = np.random.default_rng(4)
    h1 = t(rng.standard_normal((2, g, 128)).astype(np.float32))
    idx = t(rng.integers(0, g, (1, 300, 3)).astype(np.int32))
    w = t(rng.dirichlet(np.ones(3), (1, 300)).astype(np.float32))
    x, params, hyper = upscale_inputs(rng, 2, 300)
    params, hyper = tuple(map(t, params)), t(hyper)
    got = UP.decoder_tail(h1, idx, w, params, hyper, cdt=torch.float32)
    assert taken == (["UpscaleHyper"] if g == 64 else ["InterpUpscale"])
    assert UP.interp_upscale_dispatch_ok(300, g, 128, 3, torch.float32, m=2) == (g != 64)
    want = UP.interp_upscale_reference(h1, idx, w, params, hyper, cdt=torch.float32)
    assert_rel(got, want, 1e-5)
