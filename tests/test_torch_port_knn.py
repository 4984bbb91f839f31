"""The kNN search of the port (point_sam_tpu_torch/ops/knn.py) and kernel
K12 (csrc/knn.cu), against the JAX package and independent oracles.

- ``approx_bins`` against XLA's ``ApproxTopKReductionOutputSize``.
- ``fma_f32`` (one rounding, as __fmaf_rn) against exact rational
  arithmetic, on cases where an fp64 sum cast to fp32 rounds twice.
- ``knn_select_plain`` exact mode against JAX ``knn(method="exact")``
  (one-shot and key-tiled): indices equal, d^2 within 2e-6.
- approximate mode against a numpy oracle of "strided bin minima, then the
  k smallest" (indices equal), and against JAX ``knn(method="approx")``,
  which XLA runs exactly on the CPU: recall at least the formula's
  expected recall exp(-(k - 1) / L) less 0.02, and equal to the exact
  result where XLA reduces nothing (r = 0). XLA's CPU fallback orders tied
  distances larger index first, so that comparison is tie-aware.
- ``compute_geometry`` with ``knn_method="approx"`` at recall targets 0.9
  (K9's gate holds) and 0.95 (K1, then K12's approximate mode) against
  JAX's, and K9's gate against JAX's at both targets.
- a tiny ``ab_approx`` run (2 scenes of 240 points, 3 overfit steps).
- K12's launch plan (``k12_plan``) at every shape the paths and the card
  cases launch, and at Nq = 1, 7, 2047: shared memory within 232,448
  bytes and equal to ``k12_smem_bytes``, every (batch, query) row taken by
  exactly one block slot, a partial last group idle past Nq, the sample
  and the buffer consistent.
- ``cuda``-marked: K12 against ``knn_select_plain`` bit for bit (skipped
  without a card). This module imports JAX only inside its CPU tests, so
  on a machine with a card and no JAX it runs alone:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_port_knn.py

Torch runs on one intra-op thread here (a module fixture).
"""

import functools
import importlib
import math
from fractions import Fraction

import numpy as np
import pytest
import torch

K = importlib.import_module("point_sam_tpu_torch.ops.knn")
F = importlib.import_module("point_sam_tpu_torch.ops.fps")
P = importlib.import_module("point_sam_tpu_torch.models")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the ops are small, and the test files run in
    parallel processes that already hold every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def cloud(rng, B, N):
    return rng.standard_normal((B, N, 3)).astype(np.float32)


def jax_knn():
    return importlib.import_module("point_sam_tpu.ops.knn").knn


# ---------------------------------------------------------------- bins
@pytest.mark.parametrize("rt", [0.8, 0.85, 0.9, 0.93, 0.95, 0.99])
def test_approx_bins_matches_xla(rt):
    from jax._src.lib import _jax

    xla = _jax.approx_top_k_reduction_output_size
    for n in (700, 1000, 2048, 4095, 8192, 10_000, 33_333, 65_536, 100_000, 131_072):
        for k in (8, 16, 32, 64, 128, 256, 512):
            if k <= n:
                assert K.approx_bins(n, k, rt) == tuple(xla(n, 2, k, rt, False, -1)), (n, k)


def test_approx_bins_known_values():
    """The values the serve, train and hier shapes take."""
    assert K.approx_bins(100_000, 256, 0.9) == (3200, 5)
    assert K.approx_bins(131_072, 256, 0.9) == (4096, 5)
    assert K.approx_bins(131_072, 256, 0.95) == (8192, 4)
    assert K.approx_bins(10_000, 256, 0.9) == (2560, 2)
    assert K.approx_bins(128, 8, 0.9) == (128, 0)
    with pytest.raises(ValueError, match="recall_target"):
        K.approx_bins(1000, 8, 1.0)


# ----------------------------------------------------------------- fma
def exact_fma(a, b, c):
    """fp32 a * b + c rounded once to nearest, ties to even, in rationals."""
    want = Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c))
    r = np.float32(float(want))
    cands = (np.nextafter(r, np.float32(-np.inf)), r, np.nextafter(r, np.float32(np.inf)))
    err = [abs(Fraction(float(x)) - want) for x in cands]
    best = min(err)
    ties = [x for x, e in zip(cands, err) if e == best]
    return min(ties, key=lambda x: int(np.array(x).view(np.int32)) & 1)


def test_fma_f32_rounds_once():
    rng = np.random.default_rng(3)
    one = np.float32(1.0)
    u = np.float32(2.0 ** -23)
    # a * b + c = 1 + 2^-23 + 2^-24 - 2^-70: the fp64 sum is the midpoint of
    # 1 + 2^-23 and 1 + 2^-22, which a cast would round to even (up); the
    # one rounding goes down. Its mirror, and random cases besides.
    a = np.array([one + u, -(one + u)], np.float32)
    b = np.array([np.float32(2.0 ** -24) * (one - u)] * 2, np.float32)
    c = np.array([one + u, -(one + u)], np.float32)
    naive = (a.astype(np.float64) * b + c).astype(np.float32)
    a = np.concatenate([a, rng.standard_normal(3000).astype(np.float32)])
    b = np.concatenate([b, (rng.standard_normal(3000) * 2.0 ** rng.integers(-30, 4, 3000))
                        .astype(np.float32)])
    c = np.concatenate([c, rng.standard_normal(3000).astype(np.float32)])
    got = K.fma_f32(t(a), t(b), t(c)).numpy()
    want = np.array([exact_fma(*x) for x in zip(a, b, c)], np.float32)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    assert not np.array_equal(naive, want[:2])  # the crafted cases do round twice


# ---------------------------------------------------------- exact mode
@pytest.mark.parametrize("dense_max", [8192, 256])  # JAX one-shot / key-tiled
@pytest.mark.parametrize("with_valid", [False, True])
@pytest.mark.parametrize("B,nq,nk,k", [(2, 40, 700, 16), (1, 120, 5000, 64)])
def test_select_plain_exact_matches_jax(B, nq, nk, k, with_valid, dense_max):
    rng = np.random.default_rng(nk + with_valid)
    q, kk = cloud(rng, B, nq), cloud(rng, B, nk)
    valid = rng.random((B, nk)) > 0.2 if with_valid else None
    jd, ji = jax_knn()(q, kk, k, key_valid=valid, method="exact", dense_max=dense_max,
                       key_tile=128)
    td, ti = K.knn_select_plain(t(q), t(kk), k, key_valid=t(valid))
    assert ti.dtype == torch.int32 and td.dtype == torch.float32
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=2e-6, rtol=0)
    # knn(method="exact") and "auto" at k > 4 are this selection.
    for method in ("exact", "auto"):
        d, i = K.knn(t(q), t(kk), k, key_valid=t(valid), method=method)
        assert torch.equal(i, ti) and torch.equal(d, td)


def test_select_plain_exact_ties_and_invalid():
    """Duplicated keys go to the smaller index; with fewer valid keys than
    k the rest are the invalid keys at +inf, by index."""
    rng = np.random.default_rng(5)
    base = cloud(rng, 1, 50)
    kk = np.concatenate([base, base, base], 1)  # every key three times
    q = base[:, :7] + np.float32(1e-3)
    d, i = K.knn_select_plain(t(q), t(kk), 6)
    for row in range(7):
        # Each distance comes in threes (50 apart), the smaller index first.
        assert (np.diff(i[0, row].numpy().reshape(2, 3)) == 50).all()
        assert torch.equal(d[0, row, 0::3], d[0, row, 2::3])
    valid = np.zeros((1, 150), bool)
    valid[0, [149, 3, 77]] = True
    d, i = K.knn_select_plain(t(q), t(kk), 5, key_valid=t(valid))
    assert set(i[0, 0, :3].tolist()) == {3, 77, 149} and torch.isfinite(d[0, :, :3]).all()
    assert i[0, 0, 3:].tolist() == [0, 1] and torch.isinf(d[0, :, 3:]).all()


# ---------------------------------------------------- approximate mode
def oracle_binned(q, kk, k, valid, L):
    """numpy: each strided bin's smallest (d^2, index), then the k smallest
    of the bins by the same order. d^2 from the exact mode's full sort."""
    B, nq, nk = q.shape[0], q.shape[1], kk.shape[1]
    d_all, i_all = K.knn_select_plain(t(q), t(kk), nk, key_valid=t(valid))
    d2 = np.empty((B, nq, nk), np.float32)
    np.put_along_axis(d2, i_all.numpy().astype(np.int64), d_all.numpy(), axis=-1)
    out = np.empty((B, nq, k), np.int64)
    for b in range(B):
        for r in range(nq):
            best = []
            for j in range(min(L, nk)):
                members = np.arange(j, nk, L)
                m = members[np.lexsort((members, d2[b, r, members]))[0]]
                best.append((d2[b, r, m], m))
            best.sort()
            out[b, r] = [m for _, m in best[:k]]
    return out


@pytest.mark.parametrize("nk,k,L,with_valid", [
    (700, 16, 256, False), (700, 8, 128, True), (5000, 64, 1280, True),
    (700, 8, 1024, False),  # more bins than keys: 324 empty bins
    (700, 16, 256, "few"),  # 10 valid keys: the +inf bins follow, by index
])
def test_select_plain_approx_matches_oracle(nk, k, L, with_valid):
    rng = np.random.default_rng(nk + k)
    q, kk = cloud(rng, 2, 12), cloud(rng, 2, nk)
    valid = None
    if with_valid == "few":
        valid = np.zeros((2, nk), bool)
        valid[:, rng.choice(nk, 10, replace=False)] = True
    elif with_valid:
        valid = rng.random((2, nk)) > 0.3
    d, i = K.knn_select_plain(t(q), t(kk), k, key_valid=t(valid), bins=L)
    np.testing.assert_array_equal(i.numpy(), oracle_binned(q, kk, k, valid, L))
    assert (d[..., 1:] >= d[..., :-1]).all()


def tie_aware_equal(got_d, got_i, want_d, want_i):
    """Equal distances row by row, and equal index sets."""
    np.testing.assert_array_equal(got_d, want_d)
    assert (np.sort(got_i, -1) == np.sort(want_i, -1)).all()


@pytest.mark.parametrize("nk,k,rt,with_valid", [
    (10_000, 256, 0.9, False), (5000, 64, 0.95, True), (700, 8, 0.99, False),
])
def test_approx_matches_jax_approx(nk, k, rt, with_valid):
    """JAX's approx_min_k runs exactly on the CPU: the port's binned search
    keeps at least exp(-(k - 1) / L) - 0.02 of its neighbours, and equals
    it where XLA reduces nothing (r = 0)."""
    rng = np.random.default_rng(7)
    q, kk = cloud(rng, 1, 64), cloud(rng, 1, nk)
    valid = rng.random((1, nk)) > 0.1 if with_valid else None
    jd, ji = jax_knn()(q, kk, k, key_valid=valid, method="approx", recall_target=rt)
    d, i = K.knn(t(q), t(kk), k, key_valid=t(valid), method="approx", recall_target=rt)
    L, r = K.approx_bins(nk, k, rt)
    if r == 0:
        tie_aware_equal(d.numpy(), i.numpy(), np.asarray(jd), np.asarray(ji))
        return
    want = np.asarray(ji)
    hit = np.mean([np.isin(i[0, g].numpy(), want[0, g]).mean() for g in range(64)])
    assert hit >= math.exp(-(k - 1) / L) - 0.02, (hit, L)
    assert hit < 1.0  # the bins do reduce
    assert torch.equal(K.knn_select_plain(t(q), t(kk), k, key_valid=t(valid), bins=L)[1], i)


# ------------------------------------------------------------ tokenizer
@pytest.mark.parametrize("rt", [0.9, 0.95])
def test_compute_geometry_approx_matches_jax(rt):
    """JAX's composed geometry (K9's gate needs the TPU), its kNN exact on
    the CPU, against the port's: fps, centres and interp indices equal
    (weights 1e-5: JAX's CPU interp ranks by the kNN expansion, K1 by
    explicit differences); the kNN by K9 (rt 0.9, 4096 bins) or K12's
    approximate mode (rt 0.95), its recall at least the expected recall of
    its bins less 0.02."""
    J = importlib.import_module("point_sam_tpu.models.tokenizer")
    rng = np.random.default_rng(1)
    coords = rng.uniform(-1, 1, (1, 16_384, 3)).astype(np.float32)
    G, k = 128, 16
    want = J.compute_geometry(coords, J.TokenizerConfig(G, k, knn_method="approx",
                                                        knn_recall_target=rt))
    got = P.compute_geometry(t(coords), P.TokenizerConfig(G, k, knn_method="approx",
                                                          knn_recall_target=rt))
    for key in ("fps_idx", "centers", "interp_index"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]), err_msg=key)
    np.testing.assert_allclose(got["interp_weight"].numpy(), np.asarray(want["interp_weight"]),
                               atol=1e-5)
    if rt <= 0.93:  # K9's plain version
        assert torch.equal(got["knn_idx"], F.fps_interp_knn_plain(t(coords), G, k)[4])
        L = 4096
    else:
        L = K.approx_bins(16_384, k, rt)[0]
        _, ids = K.knn_select_plain(got["centers"], t(coords), k, bins=L)
        assert torch.equal(got["knn_idx"], ids)
    w = np.asarray(want["knn_idx"])
    hit = np.mean([np.isin(got["knn_idx"][0, g].numpy(), w[0, g]).mean() for g in range(G)])
    assert hit >= math.exp(-(k - 1) / L) - 0.02, (hit, L)


@pytest.mark.parametrize("rt", [0.9, 0.95])
def test_fused_gate_takes_the_recall_target(monkeypatch, rt):
    """``fused_geometry_ok`` against JAX's gate (TPU backend and
    PSAM_FUSED_GEOM=1 faked) at the serve shape and both targets."""
    import jax
    import jax.numpy as jnp

    JF = importlib.import_module("point_sam_tpu.ops.fps")
    JFP = importlib.import_module("point_sam_tpu.ops.fps_pallas")
    monkeypatch.setenv("PSAM_FUSED_GEOM", "1")
    called = []

    def fake_kernel(points, num_samples, k, *, valid=None):
        called.append(True)
        z = jnp.zeros((1, 100_000, 3), jnp.float32)
        return (jnp.zeros((1, num_samples), jnp.int32), z[:, :num_samples], z.astype(jnp.int32),
                z + 1.0, jnp.zeros((1, num_samples, k), jnp.int32))

    monkeypatch.setattr(JFP, "fps_interp_knn_pallas", fake_kernel)
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    points = jax.ShapeDtypeStruct((1, 100_000, 3), jnp.float32)
    jax.eval_shape(lambda p: JF.fps_with_interp_knn(p, 2048, 256, recall_target=rt), points)
    assert F.fused_geometry_ok(1, 100_000, 2048, 256, rt) == bool(called) == (rt <= 0.93)


# ----------------------------------------------------------- ab_approx
def test_ab_approx_tiny_run(monkeypatch):
    """``main`` end to end on 2 scenes of 240 points (bucket 256), 3 overfit
    steps, 2 clicks: the report's keys, finite deltas, and FPS coverage
    equal to JAX's surrogate on the same scenes (the FPS picks and the
    exact 1-NN distances are bit-equal)."""
    AB = importlib.import_module("point_sam_tpu_torch.evalsuite.ab_approx")
    JAB = importlib.import_module("point_sam_tpu.evalsuite.ab_approx")
    monkeypatch.setattr(AB, "miou_run", functools.partial(AB.miou_run, point_buckets=(256,)))
    report = AB.main(["--device", "cpu", "--scenes", "2", "--points", "240", "--train-steps",
                      "3", "--clicks", "2", "--geom-patches", "64", "--geom-patch-size", "16",
                      "--fps-candidates", "128"])
    assert set(report) == {"device", "corpus", "geometry_surrogates", "miou_per_click",
                           "paired_delta_vs_base"}
    names = [AB.BASE, "knn exact", "knn rt=0.95", "gk reference", "fps candidates=128"]
    assert list(report["miou_per_click"]) == names
    assert report["corpus"]["scenes"] == 2
    for d in report["paired_delta_vs_base"].values():
        assert np.isfinite(d["mean"]).all() and np.isfinite(d["ci95"]).all()
    scenes = [s[0] for s in AB.make_scenes(2, 240)]
    want = JAB.geometry_surrogates(scenes, num_patches=60, patch_size=16, candidates=128)
    got = report["geometry_surrogates"]
    assert got["fps_coverage_ratio"] == want["fps_coverage_ratio"]
    assert 0.0 < got["knn_recall"] <= 1.0


def test_geometry_surrogates_default_to_the_card(monkeypatch):
    """``geometry_surrogates`` resolves its device as every entry point
    does: the card unless another is named, and no silent CPU fallback (no
    card here: it raises); with ``device="cpu"`` its FPS coverage equals
    JAX's on the same scenes."""
    AB = importlib.import_module("point_sam_tpu_torch.evalsuite.ab_approx")
    JAB = importlib.import_module("point_sam_tpu.evalsuite.ab_approx")
    scenes = [s[0] for s in AB.make_scenes(1, 240)]
    kw = dict(num_patches=32, patch_size=8, candidates=128)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        AB.geometry_surrogates(scenes, **kw)
    got = AB.geometry_surrogates(scenes, device="cpu", **kw)
    want = JAB.geometry_surrogates(scenes, **kw)
    assert got["fps_coverage_ratio"] == want["fps_coverage_ratio"]
    assert 0.0 < got["knn_recall"] <= 1.0


# ------------------------------------------------------------ K12 plan
# (B, Nq, Nk, k, bins): the paths' launches (serve / eval, hier and
# hier4096 at both levels, train, hier-train, eval-approx95, K9's fallback
# at rt 0.9), the card cases below, and ragged query counts.
PLAN_SHAPES = [
    (1, 2048, 131072, 256, None), (1, 2048, 131072, 32, None), (1, 512, 2048, 32, None),
    (1, 4096, 131072, 32, None), (1, 512, 4096, 32, None), (2, 1024, 10000, 256, None),
    (2, 2048, 10000, 32, None), (2, 512, 2048, 32, None), (1, 2048, 131072, 256, 8192),
    (1, 2048, 131072, 256, 4096), (1, 2048, 131072, 256, 26624), (1, 64, 2048, 32, None),
    (1, 64, 10000, 256, None), (1, 64, 131072, 256, None), (2, 64, 20000, 1024, None),
    (1, 64, 131072, 1024, None), (1, 64, 131072, 256, 1024), (1, 64, 10000, 64, None),
    (1, 256, 131072, 256, None), (1, 1, 131072, 256, None), (1, 7, 131072, 256, None),
    (1, 2047, 131072, 256, None), (2, 7, 10000, 32, None), (2, 2047, 131072, 32, 4096),
    (1, 12, 700, 16, 256), (2, 12, 5000, 64, 1280), (1, 12, 700, 8, 1024), (1, 3, 8, 8, None),
]


@pytest.mark.parametrize("B,nq,nk,k,bins", PLAN_SHAPES)
def test_k12_plan_fits_and_covers(B, nq, nk, k, bins):
    plan = K.k12_plan(B, nq, nk, k, bins)
    w, qw, qpb, cap = plan["warps"], plan["qw"], plan["queries"], plan["cap"]
    assert w in (1, 2, 4, 8) and qw in (2, 4) and plan["threads"] == 32 * (w + 2)
    assert qpb == qw * w
    assert plan["smem"] == K.k12_smem_bytes(w, qw, cap, plan["tile"], plan["sample"], bins or 0)
    assert plan["smem"] <= K.K12_SMEM_LIMIT == 232_448
    # Block blk takes batch row blk // groups, queries (blk % groups) * qpb + [0, qpb).
    groups = plan["groups"]
    assert groups == -(-nq // qpb) and plan["grid"] == B * groups
    blk = np.arange(plan["grid"])[:, None]
    b, q = blk // groups, (blk % groups) * qpb + np.arange(qpb)[None, :]
    live = q < nq
    rows = (b * nq + q)[live]
    np.testing.assert_array_equal(np.sort(rows), np.arange(B * nq))  # each row once
    assert (~live).sum() == B * (groups * qpb - nq)  # a partial last group idles past Nq
    assert live[:, 0].all()  # no block without a query
    # The tile: the staging warps convert 4 keys a lane at once; a scoring
    # lane takes two keys a step, one hit bit each for every query.
    assert plan["tile"] == 1024
    # The buffer: a power of two holding k; where keys can overflow it, room
    # for a step's 64 appends after a cut to k.
    assert cap & (cap - 1) == 0 and k <= cap <= 2048
    if nk > cap:
        assert cap >= k + 64
    S, st, r = plan["sample"], plan["stride"], plan["rank"]
    if S:
        assert (S - 1) * st < nk <= S * st and 1 <= r <= 128 and r <= S
        assert nk > 1024
    else:
        assert st == r == 0
    assert K.k12_plan(B, nq, nk, k, bins) == plan  # a pure function of its arguments


def test_k12_plan_raises_outside_k12():
    with pytest.raises(ValueError, match="k <= 1024"):
        K.k12_plan(1, 4, 4096, 1025)
    with pytest.raises(ValueError, match="bins"):
        K.k12_plan(1, 4, 40_000, 8, 32_768)
    with pytest.raises(ValueError, match="bins >= k"):
        K.k12_plan(1, 4, 4096, 64, 32)


# ----------------------------------------------------------------- K12
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def k12_inputs(case):
    """(query, key, k, valid, bins) on the CPU for a K12 case."""
    rng = np.random.default_rng(11)
    B, nq, nk, k, bins = 1, 64, 10_000, 256, None
    valid = None
    if case == "sort-all":  # Nk <= 1024: every key a candidate, no sample
        nk, k = 1000, 32
    elif case == "valid":  # the serve cloud's padding: the tail invalid
        nk = 131_072
        valid = np.zeros((1, nk), bool)
        valid[:, :100_000] = True
    elif case == "batch-k1024":
        B, nk, k = 2, 20_000, 1024
    elif case == "ties":  # every key four times
        key = np.tile(cloud(rng, 1, 2500), (1, 4, 1))
        return t(key[:, :nq] + np.float32(1e-3)), t(key), 64, None, None
    elif case == "few-valid":  # all but k keys invalid
        valid = np.zeros((1, nk), bool)
        valid[:, rng.choice(nk, k, replace=False)] = True
    elif case.startswith(("sample-high", "sample-low")):
        # The sampled keys (every k12_plan stride-th at 131072) all far
        # ("high": the bound takes almost every key, the buffers fill and
        # are cut again and again) or all near ("low": fewer than k keys
        # below the bound, so the block scans again with every key).
        nk, k = 131_072, int(case.rsplit("k", 1)[1]) if "-k" in case else 256
        key = cloud(rng, 1, nk)
        far = np.arange(nk) % K.k12_plan(1, nq, nk, k)["stride"] == 0
        key[0, far] = key[0, far] * (50.0 if "high" in case else 1e-3)
        return t(np.zeros((1, nq, 3), np.float32)), t(key), k, None, None
    elif case.startswith("bins"):  # approximate mode, L <= 2048 and above
        nk, bins = 131_072, int(case[4:])
    elif case.startswith("nq"):  # a partial last group of queries
        nq, nk = int(case[2:]), 131_072
    elif case == "rows":  # two batch rows, each its own valid mask
        B, nk, k = 2, 131_072, 32
        valid = rng.random((B, nk)) < np.array([[0.76], [0.3]])
    elif case == "k1024":  # the largest k: 2048-key buffers, sorted through shared memory
        nk, k = 131_072, 1024
        valid = np.zeros((1, nk), bool)
        valid[:, :100_000] = True
    key = cloud(rng, B, nk)
    query = key[:, rng.choice(100_000 if case == "valid" else nk, nq, replace=False)]
    return t(query), t(key), k, t(valid), bins


K12_CASES = ["sort-all", "train", "valid", "batch-k1024", "ties", "few-valid", "sample-high",
             "sample-low", "bins1024", "bins4096", "bins8192", "nq1", "nq7", "nq2047", "rows",
             "sample-high-k32", "sample-low-k32", "k1024"]


@pytest.mark.cuda
@pytest.mark.parametrize("case", K12_CASES)
def test_k12_kernel_matches_plain(cuda, case):
    query, key, k, valid, bins = k12_inputs(case)
    query, key = query.to(cuda), key.to(cuda)
    valid = None if valid is None else valid.to(cuda)
    before = K.knn_select_cuda.launches
    d, i = K.knn_select_cuda(query, key, k, key_valid=valid, bins=bins)
    torch.cuda.synchronize()
    assert K.knn_select_cuda.launches == before + 1
    want_d, want_i = K.knn_select_plain(query, key, k, key_valid=valid, bins=bins)
    assert torch.equal(i, want_i)
    assert torch.equal(d.view(torch.int32), want_d.view(torch.int32))
    if bins is None:  # knn(method="exact") on CUDA tensors is this launch
        _, i2 = K.knn(query, key, k, key_valid=valid, method="exact")
        assert torch.equal(i2, i) and K.knn_select_cuda.launches == before + 2


@pytest.mark.cuda
def test_k12_kernel_raises_outside_its_shapes(cuda):
    q = torch.zeros((1, 4, 3), device=cuda)
    key = torch.zeros((1, 4096, 3), device=cuda)
    with pytest.raises(ValueError, match="k <= 1024"):
        K.knn_select_cuda(q, key, 1025)
    with pytest.raises(ValueError, match="bins"):
        K.knn_select_cuda(q, torch.zeros((1, 40_000, 3), device=cuda), 8, bins=32_768)
