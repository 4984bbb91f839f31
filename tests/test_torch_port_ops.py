"""Parity of the PyTorch port's ops (point_sam_tpu_torch.ops) with the JAX
package's, on the CPU in fp32.

Inputs come from a numpy seed and go through both packages. The JAX
kernels run as the JAX package's own tests run them: Pallas in
``interpret=True`` mode, or through their XLA references. On the CPU every
port op runs its kernel's plain torch version;
tests/test_torch_port_kernels.py holds each hand-written kernel against
that plain version on a card.
"""

import importlib
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from point_sam_tpu import ops as jops
from point_sam_tpu.ops.attention import mha_packed_pallas, mha_reference
from point_sam_tpu.ops.fps_pallas import fps_interp_pallas
from point_sam_tpu.ops.patch_encoder_pallas import (
    patch_encoder_fused as j_patch_encoder_fused,
    patch_encoder_reference,
)
from point_sam_tpu.ops.upscale_pallas import interp_upscale_hyper_fused as j_interp_upscale

from point_sam_tpu_torch import ops
# ops/__init__ re-exports functions named like their modules (fps), so
# the modules are taken from the import system, not as attributes.
A = importlib.import_module("point_sam_tpu_torch.ops.attention")
F = importlib.import_module("point_sam_tpu_torch.ops.fps")
PE = importlib.import_module("point_sam_tpu_torch.ops.patch_encoder_pallas")
UP = importlib.import_module("point_sam_tpu_torch.ops.upscale_pallas")

from tests.test_torch_port_kernels import pe_params, upscale_inputs  # noqa: E402


def t(a):
    return torch.from_numpy(np.array(a))


def n(x):
    return x.detach().cpu().numpy()


def cloud(rng, B, N):
    return rng.standard_normal((B, N, 3)).astype(np.float32)


# ------------------------------------------------------------- distance
def test_sq_dist_matches_jax(rng):
    q, k = cloud(rng, 2, 50), cloud(rng, 2, 70)
    np.testing.assert_allclose(n(ops.sq_dist(t(q), t(k))),
                               np.asarray(jops.sq_dist(q, k)), atol=2e-6)
    c = rng.standard_normal((2, 3)).astype(np.float32)
    # Explicit-difference form: same operation order, same bits.
    np.testing.assert_array_equal(n(ops.sq_dist_to_point(t(q), t(c))),
                                  np.asarray(jops.sq_dist_to_point(q, c)))


# ---------------------------------------------------------------- group
@pytest.mark.parametrize("repeats", [1, 3])
def test_group_points_matches_jax(rng, repeats):
    B, N, G, K, C = 2, 60, 8, 5, 2
    xyz = cloud(rng, B, N)
    feats = rng.standard_normal((B * repeats, N, C)).astype(np.float32)
    centers = xyz[:, :G]
    idx = rng.integers(0, N, (B, G, K)).astype(np.int32)
    fidx = np.tile(np.arange(G, dtype=np.int32), (B, 1))
    got = ops.group_points(t(xyz), t(feats), t(centers), t(idx), radius=0.5,
                           centralize_features=True, center_idx=t(fidx))
    want = jops.group_points(xyz, feats, centers, idx, radius=0.5,
                             centralize_features=True, center_idx=fidx)
    np.testing.assert_array_equal(n(got), np.asarray(want))
    np.testing.assert_array_equal(n(ops.group_features(t(feats), t(idx))),
                                  np.asarray(jops.group_features(feats, idx)))


def test_batch_index_select_and_repeat(rng):
    x = rng.standard_normal((2, 9, 4)).astype(np.float32)
    idx = rng.integers(0, 9, (2, 3, 5)).astype(np.int32)
    np.testing.assert_array_equal(n(ops.batch_index_select(t(x), t(idx))),
                                  np.asarray(jops.batch_index_select(x, idx)))
    idx2 = rng.integers(0, 4, (2, 6)).astype(np.int32)
    np.testing.assert_array_equal(
        n(ops.batch_index_select(t(x), t(idx2), axis=2)),
        np.asarray(jops.batch_index_select(x, idx2, axis=2)))
    np.testing.assert_array_equal(n(ops.repeat_interleave(t(x), 3, axis=1)),
                                  np.asarray(jops.repeat_interleave(x, 3, axis=1)))


@pytest.mark.parametrize("axis", [1, 2])
def test_batch_index_select_grad_matches_jax(rng, axis, monkeypatch):
    """The gather's backward (the port's own, a fixed summation order on
    every device) against jax.vjp of the JAX gather, with indices that hit
    the same rows many times; on the CPU it is bit-equal to autograd's
    backward of index_select."""
    import jax

    x = rng.standard_normal((2, 9, 4)).astype(np.float32)
    idx = rng.integers(0, x.shape[axis], (2, 40) if axis == 2 else (2, 40, 3)).astype(np.int32)
    out = jops.batch_index_select(x, idx, axis=axis)
    dy = rng.standard_normal(out.shape).astype(np.float32)
    _, vjp = jax.vjp(lambda a: jops.batch_index_select(a, idx, axis=axis), x)
    xt = t(x).requires_grad_()
    got = torch.autograd.grad(ops.batch_index_select(xt, t(idx), axis=axis), xt, t(dy))[0]
    np.testing.assert_allclose(n(got), np.asarray(vjp(dy)[0]), rtol=1e-6, atol=1e-6)
    # autograd's own backward of the plain index_select
    group = importlib.import_module("point_sam_tpu_torch.ops.group")
    monkeypatch.setattr(group._SelectRows, "apply", lambda flat, i: flat.index_select(0, i))
    xt = t(x).requires_grad_()
    plain = torch.autograd.grad(ops.batch_index_select(xt, t(idx), axis=axis), xt, t(dy))[0]
    assert torch.equal(got, plain)


# ------------------------------------------------------------------ kNN
@pytest.mark.parametrize("dense_max", [8192, 256])  # one-shot / key-tiled
@pytest.mark.parametrize("with_valid", [False, True])
def test_exact_knn_indices_equal(rng, dense_max, with_valid):
    q, k = cloud(rng, 2, 40), cloud(rng, 2, 700)
    valid = rng.random((2, 700)) > 0.2 if with_valid else None
    kw = dict(method="exact", dense_max=dense_max, key_tile=128)
    jd, ji = jops.knn(q, k, 16, key_valid=valid, **kw)
    td, ti = ops.knn(t(q), t(k), 16, key_valid=None if valid is None else t(valid), **kw)
    np.testing.assert_array_equal(n(ti), np.asarray(ji))
    np.testing.assert_allclose(n(td), np.asarray(jd), atol=2e-6)


def test_small_k_knn_equal(rng):
    q, k = cloud(rng, 2, 300), cloud(rng, 2, 64)
    jd, ji = jops.knn(q, k, 3)
    td, ti = ops.knn(t(q), t(k), 3)
    np.testing.assert_array_equal(n(ti), np.asarray(ji))
    np.testing.assert_allclose(n(td), np.asarray(jd), atol=2e-6)


def test_approx_knn_is_not_ported(rng):
    q = t(cloud(rng, 1, 16))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ops.knn(q, q, 4, method="approx")


# ------------------------------------------------------- K1: FPS + 3-NN
@pytest.mark.parametrize("with_valid", [False, True])
def test_fps_interp_plain_matches_pallas(rng, with_valid):
    """K1's plain version against fps_interp_pallas in interpret mode:
    indices, centres and interp indices equal; d^2 bit-equal."""
    B, N, G = 2, 1500, 128
    pts = cloud(rng, B, N)
    valid = None
    if with_valid:
        valid = np.ones((B, N), bool)
        valid[0, :7] = False  # FPS starts at the first valid point
        valid[1, 1200:] = False
    jv = None if valid is None else jnp.asarray(valid)
    want = fps_interp_pallas(jnp.asarray(pts), G, valid=jv, with_centers=True,
                             interpret=True)
    got = F.fps_interp_plain(t(pts), G, valid=None if valid is None else t(valid))
    for g_, w_ in zip(got, want):
        np.testing.assert_array_equal(n(g_), np.asarray(w_))
    np.testing.assert_array_equal(
        n(ops.fps(t(pts), G, valid=None if valid is None else t(valid))),
        np.asarray(jops.fps_xla(pts, G, valid=jv)))


def test_fps_with_interp_matches_jax_cpu(rng):
    """Weights against the JAX CPU fps_with_interp (fps_xla + 3-NN by the
    |q|^2 - 2qk + |k|^2 expansion) on a unit-sphere cloud, as the
    predictor feeds it. K1 uses the explicit difference; the expansion's
    rounding (~1e-7 |q|^2 absolute on d^2) is large relative to the small
    d^2 of points next to a centre, which moves their weights by up to
    ~5e-6: 1e-5 abs. (The bit-exact comparison is the one above.)"""
    pts = cloud(rng, 2, 1500)
    pts /= np.abs(pts).max()
    j_idx, j_ctr, j_iidx, j_w = jops.fps_with_interp(jnp.asarray(pts), 128, with_centers=True)
    idx, ctr, iidx, w = ops.fps_with_interp(t(pts), 128, with_centers=True)
    np.testing.assert_array_equal(n(idx), np.asarray(j_idx))
    np.testing.assert_array_equal(n(ctr), np.asarray(j_ctr))
    np.testing.assert_array_equal(n(iidx), np.asarray(j_iidx))
    np.testing.assert_allclose(n(w), np.asarray(j_w), atol=1e-5)


# The row lengths K1 and K8 meet: every Predictor bucket, the train rows
# (configs/large.yaml: N=10,000), and the edges of the cluster's capacity.
@pytest.mark.parametrize("N,route", [
    (1, "cluster"), (2048, "cluster"), (8192, "cluster"), (10_000, "cluster"),
    (32768, "cluster"), (131_072, "cluster"), (131_073, "grid"), (524_288, "grid")])
def test_fps_route_by_row_length(N, route):
    """K1 and K8 take the cluster route up to the serve bucket and the grid
    route above it, by the row length alone."""
    assert F.fps_route(N) == route


def test_fps_cluster_points_match_the_kernel():
    """CLUSTER_POINTS is the cluster kernel's capacity as csrc/fps_interp.cu
    computes it (16 CTAs x threads x register points), so the route never
    hands the kernel a row it refuses."""
    src = (Path(F.__file__).resolve().parents[1] / "csrc" / "fps_interp.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src)[1])

    assert re.search(r"constexpr int kClusterPoints = kMaxCluster \* kClusterThreads \* "
                     r"kRegPoints;", src)
    cap = const("kMaxCluster") * const("kClusterThreads") * const("kRegPoints")
    assert cap == F.CLUSTER_POINTS == 131_072


def test_fps_with_interp_candidates_matches_jax(rng):
    """Approximate FPS (a strided subset of 32 of 100 points, 100 / 32 not
    exact) then K10's 3-NN: indices and centres equal to JAX's two-pass
    path, weights within 1e-5 (JAX's CPU kNN forms d^2 by expansion)."""
    pts = cloud(rng, 1, 100)
    want = jops.fps_with_interp(pts, 8, candidates=32, with_centers=True)
    got = ops.fps_with_interp(t(pts), 8, candidates=32, with_centers=True)
    for i in range(3):
        np.testing.assert_array_equal(n(got[i]), np.asarray(want[i]))
    np.testing.assert_allclose(n(got[3]), np.asarray(want[3]), rtol=0, atol=1e-5)
    assert set(n(got[0]).ravel()) <= set(np.floor(np.arange(32) * (100 / 32)).astype(int))


# --------------------------------------------------------------- interp
def test_interp_matches_jax(rng):
    pts, keys = cloud(rng, 2, 200), cloud(rng, 2, 32)
    j_idx, j_w = jops.compute_interp_weights(pts, keys)
    idx, w = ops.compute_interp_weights(t(pts), t(keys))
    np.testing.assert_array_equal(n(idx), np.asarray(j_idx))
    np.testing.assert_allclose(n(w), np.asarray(j_w), rtol=1e-5, atol=1e-6)
    x = rng.standard_normal((6, 32, 8)).astype(np.float32)  # M = 3 replicas
    np.testing.assert_allclose(
        n(ops.interpolate_features_repeated(t(x), idx, w)),
        np.asarray(jops.interpolate_features_repeated(x, j_idx, j_w)), atol=1e-5)


# ------------------------------------------------ K2: PointNet encoder
@pytest.mark.parametrize("act,cdt,sizes", [
    pytest.param("erf", "float32", (2, 8, 16, 6, 32, 64, 48), id="erf"),
    pytest.param("tanh", "float32", (2, 8, 16, 6, 32, 64, 48), id="tanh"),
    pytest.param("erf", "bfloat16", (2, 8, 16, 6, 32, 64, 48), id="bf16-erf"),
    pytest.param("tanh", "bfloat16", (1, 4, 32, 131, 128, 256, 256), id="bf16-hier2-tanh"),
])
def test_patch_encoder_plain_matches_jax(rng, act, cdt, sizes):
    """K2's plain version against the Pallas kernel (interpret) and, in
    fp32, the XLA reference: fp32 within 1e-5; bf16 within 2e-2 of the
    largest output (the products sum in another order, so a value may land
    one bf16 ulp away), at small widths and at the hier level-2 widths
    (C_in = 131, h0 = 128, h1 = 256, K = 32), where the card's bf16 kernel
    pads the first Dense's depth."""
    B, G, K, cin, h0, h1, cout = sizes
    params = pe_params(rng, cin, h0, h1, cout)
    x = rng.standard_normal((B, G * K, cin)).astype(np.float32)
    kw = dict(num_groups=G, group_size=K, cdt=getattr(jnp, cdt), act=act)
    want_kernel = j_patch_encoder_fused(jnp.asarray(x), tuple(map(jnp.asarray, params)),
                                        interpret=True, **kw)
    got = PE.patch_encoder_plain(t(x), tuple(map(t, params)), num_groups=G, group_size=K,
                                 cdt=getattr(torch, cdt), act=act)
    if cdt == "bfloat16":
        assert got.dtype == torch.bfloat16 and got.shape == (B, G, cout)
        got, want = n(got.float()), np.asarray(want_kernel.astype(jnp.float32))
        assert np.abs(got - want).max() <= 2e-2 * np.abs(want).max()
        return
    want_ref = patch_encoder_reference(jnp.asarray(x), tuple(map(jnp.asarray, params)), **kw)
    np.testing.assert_allclose(n(got), np.asarray(want_kernel), atol=1e-5)
    np.testing.assert_allclose(n(got), np.asarray(want_ref), atol=1e-5)


# ---------------------------------------------------------- K3: attention
def test_mha_plain_matches_packed_pallas(rng):
    """S=128, D=128, H=2 (dh=64: the power-of-two scale is folded)."""
    q, k, v = (rng.standard_normal((2, 128, 128)).astype(np.float32) for _ in range(3))
    want = mha_packed_pallas(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 2,
                             interpret=True)
    got = A.mha_plain(t(q), t(k), t(v), 2)
    np.testing.assert_allclose(n(got), np.asarray(want), atol=1e-5)


def test_mha_plain_matches_reference_dh32(rng):
    """dh=32 (the tiny ViT): the scale is not a power of two."""
    B, S, H, dh = 2, 40, 4, 32
    q, k, v = (rng.standard_normal((B, S, H * dh)).astype(np.float32) for _ in range(3))
    split = lambda a: jnp.asarray(a).reshape(B, S, H, dh).transpose(0, 2, 1, 3)  # noqa: E731
    want = mha_reference(split(q), split(k), split(v)).transpose(0, 2, 1, 3).reshape(B, S, -1)
    got = ops.mha_flat(t(q), t(k), t(v), H)
    np.testing.assert_allclose(n(got), np.asarray(want), atol=1e-5)


# ------------------------------------------------- K4: decode tail
def test_interp_upscale_plain_matches_pallas(rng):
    """K4's plain version against interp_upscale_hyper_fused (interpret,
    fp32), M=2 replicas, C=3, within 1e-4."""
    h1, idx, w, params, hyper = upscale_inputs(rng)
    want = j_interp_upscale(jnp.asarray(h1), jnp.asarray(idx), jnp.asarray(w),
                            tuple(map(jnp.asarray, params)), jnp.asarray(hyper),
                            cdt=jnp.float32, interpret=True)
    got = UP.interp_upscale_plain(t(h1), t(idx), t(w), tuple(map(t, params)), t(hyper),
                                  cdt=torch.float32)
    assert got.shape == (4, 3, 300)
    np.testing.assert_allclose(n(got), np.asarray(want), atol=1e-4)


# The decoder tail's shapes on every path (D, C, compute dtype): the ViT-L,
# voronoi and fused-geometry serving paths and training (D=256), hier and
# hier4096 (D=128; K11 there), at the first click's C=3 and a refining
# click's C=1; the tiny fp32 models on the card; bf16 off the mma shapes.
@pytest.mark.parametrize("D,C,cdt,route", [
    (256, 3, torch.bfloat16, "mma"), (256, 1, torch.bfloat16, "mma"),
    (128, 3, torch.bfloat16, "mma"), (128, 1, torch.bfloat16, "mma"),
    (256, 8, torch.bfloat16, "mma"), (64, 3, torch.bfloat16, "fma"),
    (192, 3, torch.bfloat16, "fma"),
    (256, 3, torch.float32, "fma"), (128, 1, torch.float32, "fma"),
    (384, 3, torch.bfloat16, "fma"), (512, 3, torch.bfloat16, "fma"),
    (320, 1, torch.bfloat16, "fma"), (96, 3, torch.bfloat16, "fma"),
    (256, 9, torch.bfloat16, "fma")])
def test_upscale_route_by_shape(D, C, cdt, route):
    """K4 and K11 take the mma route for bf16 at D = 128 or 256 and
    C <= 8, the fma route otherwise (fp32, other widths)."""
    assert UP.upscale_route(D, C, cdt) == route


def test_upscale_route_matches_the_kernel():
    """The mma route's limits are what csrc/upscale.cu instantiates and
    accepts (the widths of its switch, kMaxC), so the route never hands the
    kernel a shape it refuses."""
    src = (Path(UP.__file__).resolve().parents[1] / "csrc" / "upscale.cu").read_text()
    widths = {int(d) for d in re.findall(r"return launch_mma<(\d+), kGather>", src)}
    assert widths == {d for d in range(1, 1025) if UP.upscale_route(d, 1, torch.bfloat16) == "mma"}
    assert int(re.search(r"constexpr int kMaxC = (\d+);", src)[1]) == UP.MMA_MAX_C
