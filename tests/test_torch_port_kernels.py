"""The hand-written CUDA kernels K1-K11 of point_sam_tpu_torch against
their plain torch versions.

The ``cuda``-marked tests need a card and skip without one. This file
imports neither JAX nor the JAX package, so on a machine with a card (and
no JAX) it runs on its own:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_port_kernels.py

Tolerances: fp32 kernels sum in another order than torch's matmuls
(1e-5 attention, 1e-4 for the deeper PointNet / decode-tail chains); bf16
kernels round where the reference rounds but accumulate in another order
(2e-2 relative, the bound the JAX package's chip smoke uses for its bf16
kernels); K5 as K3. K1 and K8 are exact: indices equal and d^2 bit-equal.
K10: indices equal, weights within 1e-6 (the same fp32 operations; only
the division may round differently). K9 is exact (K1's outputs and the
kNN ids). K11 as K4. The backward
kernels: K6 1e-5 (fp32) / 2e-2 (bf16) of the largest grad; K7 in fp32 1e-4
of each grad's largest entry, in bf16 5e-2 in norm (||diff|| / ||plain||):
both sides route the max-pool grads to the rows K2 saved, but K7
recomputes the activations in another summation order; K7's pass D alone,
given the da2 the kernel wrote, 1e-2 in norm against its plain version
(no routing or stage-2 recompute in play). K2's argmax
outputs: in fp32 on integer-valued inputs the rows equal plain's; in bf16
the plain value at each row lies within one ulp of its column's max.
"""

import importlib

import numpy as np
import pytest
import torch

A = importlib.import_module("point_sam_tpu_torch.ops.attention")
F = importlib.import_module("point_sam_tpu_torch.ops.fps")
IW = importlib.import_module("point_sam_tpu_torch.ops.interp_pallas")
PE = importlib.import_module("point_sam_tpu_torch.ops.patch_encoder_pallas")
UP = importlib.import_module("point_sam_tpu_torch.ops.upscale_pallas")
_cuda = importlib.import_module("point_sam_tpu_torch.ops._cuda")


def pe_params(rng, cin, h0, h1, cout):
    """Patch-encoder parameters in the fused op's order; matrices [in, out]."""
    def mat(i, o):
        return (rng.standard_normal((i, o)) / np.sqrt(i)).astype(np.float32)

    def vec(d, mean=0.0):
        return (mean + 0.1 * rng.standard_normal(d)).astype(np.float32)

    return (mat(cin, h0), vec(h0), vec(h0, 1.0), vec(h0), mat(h0, h0), vec(h0),
            mat(2 * h0, h1), vec(h1), vec(h1, 1.0), vec(h1), mat(h1, cout), vec(cout))


def upscale_inputs(rng, b=2, m=2, g=32, nq=300, d=64, c=3):
    """(h1, index, weight, params, hyper) for the decode tail."""
    h1 = rng.standard_normal((b * m, g, d)).astype(np.float32)
    idx = rng.integers(0, g, (b, nq, 3)).astype(np.int32)
    idx[0, :5, 1] = idx[0, :5, 0]  # duplicate neighbours add
    w = rng.dirichlet(np.ones(3), (b, nq)).astype(np.float32)
    params = ((1.0 + 0.1 * rng.standard_normal(d)).astype(np.float32),
              (0.1 * rng.standard_normal(d)).astype(np.float32),
              (rng.standard_normal((d, d)) / np.sqrt(d)).astype(np.float32),
              (0.1 * rng.standard_normal(d)).astype(np.float32))
    hyper = rng.standard_normal((b * m, c, d)).astype(np.float32)
    return h1, idx, w, params, hyper


def to(x, device, dtype=None):
    """numpy array or tuple of them -> tensor(s) on ``device``."""
    if isinstance(x, tuple):
        return tuple(to(a, device, dtype) for a in x)
    t = torch.from_numpy(np.array(x)).to(device)
    return t.to(dtype) if dtype is not None and t.is_floating_point() else t


def n(x):
    return x.detach().float().cpu().numpy()


def assert_rel(got, want, rel):
    """max |got - want| <= rel * max |want|."""
    err = np.abs(n(got) - n(want)).max()
    assert err <= rel * np.abs(n(want)).max(), (err, np.abs(n(want)).max())


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


WRAPPERS = (F.fps_interp_cuda, A.mha_cuda, PE.patch_encoder_cuda, UP.interp_upscale_cuda,
            A.mha_heads_cuda, A.mha_packed_bwd_cuda, PE.patch_encoder_bwd_cuda, F.fps_cuda,
            IW.interp_weights_cuda, F.fps_interp_knn_cuda, UP.upscale_hyper_cuda)


def test_launch_counters_tally_by_shape():
    """Each wrapper counts its launches in all and by shape and dtype."""
    def wrapper():
        pass

    _cuda.counted(wrapper)
    for b in (1, 2, 1):
        _cuda.count_launch(wrapper, B=b, dtype="torch.bfloat16")
    assert wrapper.launches == 3
    assert wrapper.shapes == {(("B", 1), ("dtype", "torch.bfloat16")): 2,
                              (("B", 2), ("dtype", "torch.bfloat16")): 1}
    for w in WRAPPERS:
        assert isinstance(w.launches, int) and isinstance(w.shapes, dict)


def test_wrappers_refuse_cpu_tensors():
    """A kernel wrapper launches on CUDA tensors or raises; it never falls
    back to the plain version, and counts no launch."""
    counts = [(w.launches, dict(w.shapes)) for w in WRAPPERS]
    rng = np.random.default_rng(0)
    x = to(rng.standard_normal((1, 64, 3)).astype(np.float32), "cpu")
    with pytest.raises(ValueError, match="CUDA"):
        F.fps_interp_cuda(x, 8)
    with pytest.raises(ValueError, match="CUDA"):
        A.mha_cuda(x, x, x, 1)
    with pytest.raises(ValueError, match="CUDA"):
        PE.patch_encoder_cuda(to(rng.standard_normal((1, 32, 6)).astype(np.float32), "cpu"),
                              to(pe_params(rng, 6, 8, 16, 8), "cpu"), num_groups=4,
                              group_size=8, cdt=torch.float32)
    with pytest.raises(ValueError, match="CUDA"):
        UP.interp_upscale_cuda(*to(upscale_inputs(rng), "cpu"), cdt=torch.float32)
    with pytest.raises(ValueError, match="CUDA"):
        A.mha_heads_cuda(x[None], x[None], x[None])
    with pytest.raises(ValueError, match="CUDA"):
        F.fps_cuda(x, 8)
    with pytest.raises(ValueError, match="CUDA"):
        IW.interp_weights_cuda(x, x[:, :8])
    with pytest.raises(ValueError, match="CUDA"):
        A.mha_packed_bwd_cuda(x, x, x, x, 1)
    with pytest.raises(ValueError, match="CUDA"):
        PE.patch_encoder_bwd_cuda(
            to(rng.standard_normal((1, 32, 6)).astype(np.float32), "cpu"),
            to(pe_params(rng, 6, 8, 16, 8), "cpu"),
            to(rng.standard_normal((1, 4, 8)).astype(np.float32), "cpu"), num_groups=4,
            group_size=8, cdt=torch.float32,
            saved=(torch.zeros(1, 4, 8), *(torch.zeros(1, 4, 8, dtype=torch.int32),) * 2))
    with pytest.raises(ValueError, match="CUDA"):
        F.fps_interp_knn_cuda(to(rng.standard_normal((1, 4096, 3)).astype(np.float32), "cpu"),
                              8, 8)
    h1, _, _, params, hyper = to(upscale_inputs(rng), "cpu")
    with pytest.raises(ValueError, match="CUDA"):
        UP.upscale_hyper_cuda(h1, params, hyper, cdt=torch.float32)
    assert [(w.launches, w.shapes) for w in WRAPPERS] == counts


@pytest.mark.cuda
@pytest.mark.parametrize("B,N,G,with_valid", [(2, 1500, 128, False), (2, 1500, 128, True),
                                              (1, 2048, 32, True), (1, 20000, 512, True)])
def test_k1_kernel_matches_plain(cuda, B, N, G, with_valid):
    rng = np.random.default_rng(1)
    pts = to(rng.standard_normal((B, N, 3)).astype(np.float32), cuda)
    valid = None
    if with_valid:
        v = rng.random((B, N)) > 0.1
        v[0, :3] = False
        valid = to(v, cuda)
    got = F.fps_interp_cuda(pts, G, valid=valid)
    want = F.fps_interp_plain(pts, G, valid=valid)
    torch.cuda.synchronize()
    for g_, w_ in zip(got, want):
        np.testing.assert_array_equal(n(g_), n(w_))


def k2_case(params):
    """pytest.param of (G, K, cin, cout, h0, h1, B, ties) named by its sizes;
    the first cases' names predate the widths, B and ties columns."""
    G, K, cin, cout, h0, h1, B, ties = params
    name = f"{G}-{K}-{cin}-{cout}"
    if (h0, h1, B, ties) != (128, 512, 2, False):
        name += f"-h{h0}-{h1}-B{B}" + ("-ties" if ties else "")
    return pytest.param(*params, id=name)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("act", ["erf", "tanh"])
@pytest.mark.parametrize("G,K,cin,cout,h0,h1,B,ties", [k2_case(c) for c in [
    (32, 16, 6, 512, 128, 512, 2, False), (8, 20, 4, 256, 128, 512, 2, False),
    (4, 24, 6, 40, 128, 512, 2, False),
    # The bf16 tensor-core kernel's edges: the hier level-1 and level-2
    # widths at K = 32 (C_in = 131 pads the first Dense to 144), K = 256 at
    # both output widths (4 row chunks of a2), K = 77 (a ragged last chunk),
    # a grid of 320 blocks (above one wave on 132 SMs), duplicated input
    # rows (exact ties in both max-pools).
    (16, 32, 6, 128, 64, 128, 2, False), (8, 32, 131, 512, 128, 256, 2, False),
    (8, 32, 131, 256, 128, 256, 2, False), (4, 256, 6, 512, 128, 512, 2, False),
    (4, 256, 4, 256, 128, 512, 2, False), (6, 77, 4, 256, 128, 512, 2, False),
    (160, 32, 4, 128, 64, 128, 2, False), (8, 32, 6, 512, 128, 512, 2, True)]])
def test_k2_kernel_matches_plain(cuda, dtype, tol, act, G, K, cin, cout, h0, h1, B, ties):
    rng = np.random.default_rng(2)
    params = to(pe_params(rng, cin, h0, h1, cout), cuda)
    x = rng.standard_normal((B, G, K, cin)).astype(np.float32)
    if ties:
        x[:, :, 1] = x[:, :, 0]
        x[:, :, 5] = x[:, :, 3]
    x = to(x.reshape(B, G * K, cin), cuda)
    kw = dict(num_groups=G, group_size=K, cdt=dtype, act=act)
    got = PE.patch_encoder_cuda(x, params, **kw)
    assert got.dtype == dtype and got.shape == (B, G, cout)
    assert_rel(got, PE.patch_encoder_plain(x, params, **kw), tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k2_kernel_repeats_bit_for_bit(cuda, dtype):
    """Two calls at the serve shape [1, 2048 * 256, 6] -> 512 return the same
    bits: every sum runs in a fixed order (no atomics)."""
    rng = np.random.default_rng(22)
    params = to(pe_params(rng, 6, 128, 512, 512), cuda)
    x = to(rng.standard_normal((1, 2048 * 256, 6)).astype(np.float32), cuda)
    kw = dict(num_groups=2048, group_size=256, cdt=dtype)
    first = PE.patch_encoder_cuda(x, params, **kw)
    second = PE.patch_encoder_cuda(x, params, **kw)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


# (B, G, K, C_in, h0, h1, C_out): a serve, a hier level-2, a hier level-1 and
# a train shape.
K2_ARGMAX_SHAPES = [pytest.param(1, 2048, 256, 6, 128, 512, 512, id="serve"),
                    pytest.param(1, 512, 32, 131, 128, 256, 512, id="hier"),
                    pytest.param(1, 2048, 32, 6, 64, 128, 128, id="hier1"),
                    pytest.param(4, 1024, 256, 4, 128, 512, 256, id="train")]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,G,K,cin,h0,h1,cout", K2_ARGMAX_SHAPES)
def test_k2_argmax_outputs_leave_out_unchanged(cuda, dtype, B, G, K, cin, h0, h1, cout):
    """Asking K2 for the max-pools' argmaxes (the FMA kernel in fp32, the
    mma kernel in bf16) leaves its output bit-equal."""
    rng = np.random.default_rng(23)
    params = to(pe_params(rng, cin, h0, h1, cout), cuda)
    x = to(rng.standard_normal((B, G * K, cin)).astype(np.float32), cuda)
    kw = dict(num_groups=G, group_size=K, cdt=dtype)
    out, (pool, arg2, arg4) = PE.patch_encoder_cuda(x, params, return_argmax=True, **kw)
    assert pool.shape == arg2.shape == (B, G, h0) and arg4.shape == (B, G, cout)
    assert pool.dtype == dtype and arg2.dtype == arg4.dtype == torch.int32
    assert torch.equal(out, PE.patch_encoder_cuda(x, params, **kw))


def pe_ties(x):
    """Duplicate rows of x [B, G, K, C_in] in place: row 1 = row 0 (one
    fragment), 5 = 3, and for longer patches 40 = 3 (another row group) and
    70 = 10 (another 64-row chunk). None of 1, 5, 40, 70 is ever a first
    maximum."""
    x[:, :, 1] = x[:, :, 0]
    x[:, :, 5] = x[:, :, 3]
    if x.shape[2] > 70:
        x[:, :, 40] = x[:, :, 3]
        x[:, :, 70] = x[:, :, 10]
    return (1, 5, 40, 70)


def pe_stages(x, params, G, K, cdt, act):
    """The plain forward's a2 [B, G, K, h0] and a4 [B, G, K, C_out]."""
    w1a, b1a, s1, t1, w1b, b1b, w2a, b2a, s2, t2, w2b, b2b = params
    x = x.reshape(x.shape[0], G, K, -1)
    a2 = PE._dense(PE.ln_gelu(PE._dense(x, w1a, b1a, cdt), s1, t1, cdt, act), w1b, b1b, cdt)
    h0 = a2.shape[-1]
    pooled = PE.first_max(a2, 2)
    up = (torch.matmul(a2.float(), w2a[h0:].to(cdt).float())
          + torch.matmul(pooled.float(), w2a[:h0].to(cdt).float())[:, :, None])
    a3 = up.to(cdt) + b2a.to(cdt)
    return a2, PE._dense(PE.ln_gelu(a3, s2, t2, cdt, act), w2b, b2b, cdt)


# (G, K, C_in, h0, h1, C_out)
K2_TIE_SHAPES = [(8, 32, 6, 64, 128, 128), (4, 77, 4, 128, 512, 256), (2, 256, 6, 128, 512, 512)]


@pytest.mark.cuda
@pytest.mark.parametrize("act", ["erf", "tanh"])
@pytest.mark.parametrize("G,K,cin,h0,h1,cout", K2_TIE_SHAPES)
def test_k2_argmax_fp32_equals_plain(cuda, act, G, K, cin, h0, h1, cout):
    """fp32 (the FMA kernel) on integer-valued inputs with duplicated rows:
    arg2 and arg4 equal the plain version's exactly, pool within 1e-4."""
    rng = np.random.default_rng(24)
    params = to(pe_params(rng, cin, h0, h1, cout), cuda)
    x = rng.integers(-3, 4, (2, G, K, cin)).astype(np.float32)
    dup = pe_ties(x)
    x = to(x.reshape(2, G * K, cin), cuda)
    kw = dict(num_groups=G, group_size=K, cdt=torch.float32, act=act, return_argmax=True)
    _, got = PE.patch_encoder_cuda(x, params, **kw)
    _, want = PE.patch_encoder_plain(x, params, **kw)
    assert_rel(got[0], want[0], 1e-4)
    for g_, w_ in zip(got[1:], want[1:]):
        assert torch.equal(g_, w_)
        assert not any(bool((g_ == r).any()) for r in dup)


@pytest.mark.cuda
@pytest.mark.parametrize("act", ["erf", "tanh"])
@pytest.mark.parametrize("G,K,cin,h0,h1,cout", K2_TIE_SHAPES)
def test_k2_argmax_bf16_rows_hold_the_max(cuda, act, G, K, cin, h0, h1, cout):
    """bf16 (the mma kernel), duplicated rows: at each column's arg2 / arg4
    row the plain version's a2 / a4 lies within one bf16 ulp of that
    column's plain maximum; pool too; no later duplicate is ever chosen
    (the first row wins at every level of the reduction)."""
    rng = np.random.default_rng(25)
    params = to(pe_params(rng, cin, h0, h1, cout), cuda)
    x = rng.standard_normal((2, G, K, cin)).astype(np.float32)
    dup = pe_ties(x)
    x = to(x.reshape(2, G * K, cin), cuda, torch.bfloat16)
    kw = dict(num_groups=G, group_size=K, cdt=torch.bfloat16, act=act)
    _, (pool, arg2, arg4) = PE.patch_encoder_cuda(x, params, return_argmax=True, **kw)
    a2, a4 = (a.float() for a in pe_stages(x, params, G, K, torch.bfloat16, act))
    for a, arg in ((a2, arg2), (a4, arg4)):
        top = a.amax(2)
        at = torch.take_along_dim(a, arg.long()[:, :, None], 2).squeeze(2)
        ulp = torch.exp2(torch.floor(torch.log2(top.abs().clamp_min(1e-30))) - 7)
        assert bool((at >= top - ulp).all())
        assert not any(bool((arg == r).any()) for r in dup)
    top = a2.amax(2)
    ulp = torch.exp2(torch.floor(torch.log2(top.abs().clamp_min(1e-30))) - 7)
    assert bool(((pool.float() - top).abs() <= ulp).all())


def qkv_inputs(rng, shape, big):
    """Seeded q, k, v of ``shape`` [B, H, S, dh]. ``big``: q * 20 and keys
    growing along S, so that the logits are large, the running max moves in
    late key tiles and the online softmax rescales its partial sums."""
    q, k, v = (rng.standard_normal(shape).astype(np.float32) for _ in range(3))
    if big:
        q *= 20
        k *= np.linspace(0.5, 1.5, shape[2], dtype=np.float32)[:, None]
    return q, k, v


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("B,S,H,dh,big", [(1, 32, 4, 32, False), (2, 200, 2, 64, False),
                                          (1, 64, 1, 88, False), (1, 130, 1, 128, False),
                                          (1, 2049, 2, 64, False), (1, 2048, 16, 64, False),
                                          (1, 2048, 16, 64, True)])
def test_k3_kernel_matches_plain(cuda, dtype, tol, B, S, H, dh, big):
    """Ragged S, every padded head size, the ViT-L serve shape; ``big``:
    large logits (see ``qkv_inputs``)."""
    q, k, v = (to(t.swapaxes(1, 2).reshape(B, S, H * dh), cuda, dtype)
               for t in qkv_inputs(np.random.default_rng(3), (B, H, S, dh), big))
    got = A.mha_cuda(q, k, v, H)
    assert got.dtype == dtype
    assert_rel(got, A.mha_plain(q, k, v, H), tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("B,H,S,dh,big", [(1, 2, 64, 88, False), (2, 3, 200, 88, False),
                                          (1, 4, 130, 32, False), (1, 1, 77, 64, False),
                                          (1, 2, 64, 128, False), (1, 2, 2049, 88, False),
                                          (1, 16, 2048, 88, False), (1, 16, 2048, 88, True)])
def test_k5_kernel_matches_plain(cuda, dtype, tol, B, H, S, dh, big):
    """Ragged S, every padded head size, the voronoi EVA-giant shape;
    ``big``: large logits (see ``qkv_inputs``)."""
    q, k, v = (to(t, cuda, dtype) for t in qkv_inputs(np.random.default_rng(5), (B, H, S, dh), big))
    got = A.mha_heads_cuda(q, k, v)
    assert got.dtype == dtype and got.shape == q.shape
    assert_rel(got, A.mha_heads_plain(q, k, v), tol)


@pytest.mark.cuda
@pytest.mark.parametrize("B,N,G,with_valid", [(2, 1500, 128, False), (2, 1500, 128, True),
                                              (1, 5000, 1, True), (1, 40000, 2048, True)])
def test_k8_kernel_matches_plain(cuda, B, N, G, with_valid):
    rng = np.random.default_rng(8)
    pts = to(rng.standard_normal((B, N, 3)).astype(np.float32), cuda)
    valid = None
    if with_valid:
        v = rng.random((B, N)) > 0.1
        v[0, :3] = False
        valid = to(v, cuda)
    got = F.fps_cuda(pts, G, valid=valid)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(n(got), n(F.fps_plain(pts, G, valid=valid)))


@pytest.mark.cuda
@pytest.mark.parametrize("B,N,G,grid", [(2, 3000, 64, False), (1, 5000, 2048, False),
                                        (2, 700, 3, False), (1, 4000, 512, True)])
def test_k10_kernel_matches_plain(cuda, B, N, G, grid):
    rng = np.random.default_rng(10)
    q = rng.standard_normal((B, N, 3)).astype(np.float32)
    k = rng.standard_normal((B, G, 3)).astype(np.float32)
    if grid:  # coordinates on a 1/8 grid: exact distance ties
        q, k = np.round(q * 8) / 8, np.round(k * 8) / 8
    q, k = to(q, cuda), to(k, cuda)
    gi, gw = IW.interp_weights_cuda(q, k)
    wi, ww = IW.interp_weights_plain(q, k)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(n(gi), n(wi))
    np.testing.assert_allclose(n(gw), n(ww), atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("m,c,nq", [(2, 3, 300), (1, 1, 33)])
def test_k4_kernel_matches_plain(cuda, dtype, tol, m, c, nq):
    rng = np.random.default_rng(4)
    h1, idx, w, params, hyper = upscale_inputs(rng, m=m, c=c, nq=nq, d=256)
    h1, hyper = to(h1, cuda, dtype), to(hyper, cuda, dtype)
    idx, w, params = to(idx, cuda), to(w, cuda), to(params, cuda)
    got = UP.interp_upscale_cuda(h1, idx, w, params, hyper, cdt=dtype)
    assert got.dtype == torch.float32 and got.shape == (2 * m, c, nq)
    assert_rel(got, UP.interp_upscale_plain(h1, idx, w, params, hyper, cdt=dtype), tol)


def assert_norm(got, want, rel):
    """||got - want|| <= rel * ||want||."""
    err = np.linalg.norm(n(got) - n(want))
    assert err <= rel * np.linalg.norm(n(want)), (err, np.linalg.norm(n(want)))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("B,S,H,dh,big", [(1, 100, 2, 32, False), (2, 130, 2, 64, False),
                                          (1, 77, 1, 128, False), (1, 64, 1, 88, False),
                                          (1, 200, 2, 36, False), (1, 2049, 2, 64, False),
                                          (2, 1024, 16, 64, False),
                                          (2, 1024, 16, 64, True)])
def test_k6_kernel_matches_plain(cuda, dtype, tol, B, S, H, dh, big):
    """Ragged S, every padded head size, dh = 36 (not a multiple of 8, so the
    bf16 kernels load and store element by element), the ViT-L train shape;
    ``big``: large logits, as ``qkv_inputs`` makes them."""
    rng = np.random.default_rng(6)
    q, k, v, do = (rng.standard_normal((B, S, H * dh)).astype(np.float32) for _ in range(4))
    if big:
        q *= 20
        k *= np.linspace(0.5, 1.5, S, dtype=np.float32)[:, None]
    q, k, v, do = (to(t, cuda, dtype) for t in (q, k, v, do))
    got = A.mha_packed_bwd_cuda(q, k, v, do, H)
    want = A.mha_packed_bwd_plain(q, k, v, do, H)
    torch.cuda.synchronize()
    for g_, w_ in zip(got, want):
        assert g_.dtype == dtype and g_.shape == q.shape
        assert_rel(g_, w_, tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k6_kernel_repeats_bit_for_bit(cuda, dtype):
    """Two calls at the ViT-L train shape return the same bits: every grad
    element is summed by one thread in a fixed order (no atomics)."""
    rng = np.random.default_rng(66)
    q, k, v, do = (to(rng.standard_normal((2, 1024, 1024)).astype(np.float32), cuda, dtype)
                   for _ in range(4))
    first = A.mha_packed_bwd_cuda(q, k, v, do, 16)
    second = A.mha_packed_bwd_cuda(q, k, v, do, 16)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def pe_bwd_case(rng, device, dtype, G, K, cin, cout, ties=False, h0=128, h1=512):
    params = to(pe_params(rng, cin, h0, h1, cout), device)
    x = rng.standard_normal((2, G, K, cin)).astype(np.float32)
    if ties:  # duplicate neighbour rows: exact ties in every max-pool
        x[:, :, 1] = x[:, :, 0]
        x[:, :, 5] = x[:, :, 3]
    x = to(x.reshape(2, G * K, cin), device, dtype)
    do = to(rng.standard_normal((2, G, cout)).astype(np.float32), device, dtype)
    return x, params, do


def k7_route(K, cin, h0, h1, cout, dtype):
    """The route K7 should take: "mma" (bf16 passes C and D on mma.sync
    tiles, each a launch of its own) at K2's mma widths where the pass-C
    kernel's shared memory fits (K <= 256 at h(128, 512)) and pass D's dw1a
    tiles fit its registers (C_in <= 160 at h0 = 128), else "single" (one
    launch)."""
    mma = (dtype == torch.bfloat16 and h0 % 16 == 0 and h0 <= 128 and h1 % 16 == 0
           and cout % 16 == 0 and K <= 256 and (cin + 15) // 16 * (h0 // 16) <= 80)
    return "mma" if mma else "single"


def k7_launch_route():
    """The route of K7's one counted launch since its counts were reset."""
    (key,) = PE.patch_encoder_bwd_cuda.shapes
    return dict(key)["route"]


# (G, K, C_in, C_out, h0, h1): the first three keep their old IDs; then the
# bf16 mma route's shapes: the train shapes at K = 256 (-> 256, -> 512), a
# ragged last 64-row chunk (K = 77), the hier level-2 (C_in = 131) and
# level-1 widths at K = 32, and h0 = 96 (pass D's row tiles use three of
# their four column groups).
K7_SHAPES = [pytest.param(8, 20, 6, 40, 128, 512, id="8-20-6-40"),
             pytest.param(4, 24, 4, 256, 128, 512, id="4-24-4-256"),
             pytest.param(6, 20, 6, 512, 128, 512, id="6-20-6-512"),
             pytest.param(3, 256, 4, 256, 128, 512, id="train256"),
             pytest.param(2, 256, 6, 512, 128, 512, id="train512"),
             pytest.param(6, 77, 4, 256, 128, 512, id="ragged77"),
             pytest.param(8, 32, 131, 256, 128, 256, id="hier2"),
             pytest.param(16, 32, 4, 128, 64, 128, id="hier1-4"),
             pytest.param(16, 32, 6, 128, 64, 128, id="hier1-6"),
             pytest.param(96, 64, 6, 128, 96, 256, id="h0-96")]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("act", ["erf", "tanh"])
@pytest.mark.parametrize("G,K,cin,cout,h0,h1", K7_SHAPES)
def test_k7_kernel_matches_plain(cuda, dtype, act, G, K, cin, cout, h0, h1):
    """K7 given K2's saved max-pools against the plain backward given the
    same ones, on the route its sizes select (the launch counter records
    it)."""
    rng = np.random.default_rng(7)
    x, params, do = pe_bwd_case(rng, cuda, dtype, G, K, cin, cout, h0=h0, h1=h1)
    kw = dict(num_groups=G, group_size=K, cdt=dtype, act=act)
    _, saved = PE.patch_encoder_cuda(x, params, return_argmax=True, **kw)
    PE.patch_encoder_bwd_cuda.shapes = {}
    gdx, gdp = PE.patch_encoder_bwd_cuda(x, params, do, saved=saved, **kw)
    assert k7_launch_route() == k7_route(K, cin, h0, h1, cout, dtype)
    wdx, wdp = PE.patch_encoder_bwd_plain(x, params, do, saved=saved, **kw)
    torch.cuda.synchronize()
    assert gdx.dtype == dtype and gdx.shape == x.shape
    for g_, w_ in zip((gdx, *gdp), (wdx, *wdp)):
        assert g_.shape == w_.shape
        if dtype == torch.float32:
            assert_rel(g_, w_, 1e-4)
        else:
            assert_norm(g_, w_, 5e-2)
    # dx is optional and the parameter grads do not depend on it.
    ndx, ndp = PE.patch_encoder_bwd_cuda(x, params, do, need_dx=False, saved=saved, **kw)
    assert ndx is None
    for a, b in zip(ndp, gdp):
        assert torch.equal(a, b)


# (B, G, K, C_in, h0, h1, C_out): pass D on the mma route at the train
# shapes, a ragged last chunk, the hier level-2 and level-1 widths, h0 = 96.
K7_PASS_D_SHAPES = [pytest.param(2, 64, 256, 4, 128, 512, 256, id="train256"),
                    pytest.param(2, 32, 256, 6, 128, 512, 512, id="train512"),
                    pytest.param(2, 48, 77, 4, 128, 512, 256, id="ragged77"),
                    pytest.param(2, 96, 32, 131, 128, 256, 256, id="hier2"),
                    pytest.param(2, 160, 32, 6, 64, 128, 128, id="hier1"),
                    pytest.param(2, 96, 64, 6, 96, 256, 128, id="h0-96")]


@pytest.mark.cuda
@pytest.mark.parametrize("need_dx", [True, False], ids=["dx", "no-dx"])
@pytest.mark.parametrize("act", ["erf", "tanh"])
@pytest.mark.parametrize("B,G,K,cin,h0,h1,cout", K7_PASS_D_SHAPES)
def test_k7_pass_d_matches_plain_given_da2(cuda, B, G, K, cin, h0, h1, cout, act, need_dx):
    """Pass D alone: the kernel's stage-1 grads (and dx) against
    ``patch_encoder_bwd_stage1_plain`` given the da2 that pass C wrote and
    pass D read, each within 1e-2 in norm (one-ulp flips of the recomputed
    a1, g1 or da1 where the two sum in other orders; no max-pool routing
    or stage-2 recompute is in play, so the bound is five times K7's)."""
    rng = np.random.default_rng(17)
    params = to(pe_params(rng, cin, h0, h1, cout), cuda)
    x = to(rng.standard_normal((B, G * K, cin)).astype(np.float32), cuda, torch.bfloat16)
    do = to(rng.standard_normal((B, G, cout)).astype(np.float32), cuda, torch.bfloat16)
    kw = dict(num_groups=G, group_size=K, cdt=torch.bfloat16, act=act)
    _, saved = PE.patch_encoder_cuda(x, params, return_argmax=True, **kw)
    dx, grads, route, da2 = PE._bwd_launch(x, params, do, saved=saved, need_dx=need_dx,
                                           return_da2=True, **kw)
    assert route == "mma" and da2.shape == (B * G * K, h0)
    wdx, wgrads = PE.patch_encoder_bwd_stage1_plain(x.reshape(-1, cin), params, da2,
                                                    cdt=torch.bfloat16, act=act, need_dx=need_dx)
    torch.cuda.synchronize()
    assert (dx is None) == (not need_dx)
    pairs = list(zip(grads[:6], wgrads)) + ([(dx.reshape(-1, cin), wdx)] if need_dx else [])
    for g_, w_ in pairs:
        assert g_.shape == w_.shape
        assert_norm(g_, w_, 1e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("act", ["erf", "tanh"])
def test_k7_mma_route_ties_match_plain(cuda, act):
    """bf16 on the mma route with duplicated neighbour rows (exact ties in
    both max-pools): K7 given K2's rows against plain given the same rows."""
    rng = np.random.default_rng(71)
    x, params, do = pe_bwd_case(rng, cuda, torch.bfloat16, 8, 32, 6, 512, ties=True)
    kw = dict(num_groups=8, group_size=32, cdt=torch.bfloat16, act=act)
    _, saved = PE.patch_encoder_cuda(x, params, return_argmax=True, **kw)
    PE.patch_encoder_bwd_cuda.shapes = {}
    gdx, gdp = PE.patch_encoder_bwd_cuda(x, params, do, saved=saved, **kw)
    assert k7_launch_route() == "mma"
    wdx, wdp = PE.patch_encoder_bwd_plain(x, params, do, saved=saved, **kw)
    for g_, w_ in zip((gdx, *gdp), (wdx, *wdp)):
        assert_norm(g_, w_, 5e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k7_kernel_repeats_bit_for_bit(cuda, dtype):
    """K2 (with its argmaxes) then K7, twice, at [2, 64 * 256, 4] h(128, 512)
    -> 256: the same bits (fixed summation orders, no atomics on floats); in
    bf16 on the mma route."""
    x, params, do = pe_bwd_case(np.random.default_rng(77), cuda, dtype, 64, 256, 4, 256)
    kw = dict(num_groups=64, group_size=256, cdt=dtype)
    runs = []
    for _ in range(2):
        out, saved = PE.patch_encoder_cuda(x, params, return_argmax=True, **kw)
        PE.patch_encoder_bwd_cuda.shapes = {}
        runs.append((out, *saved, *PE.patch_encoder_bwd_cuda(x, params, do, saved=saved,
                                                               need_dx=False, **kw)[1]))
        assert k7_launch_route() == k7_route(256, 4, 128, 512, 256, dtype)
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_batch_index_select_backward_repeats_bit_for_bit(cuda):
    """The gather's backward on the card (the decoder tail's 3-NN
    interpolation at the ViT-L train shape: 3 x 10,000 points onto 1,024
    token rows) returns the same bits twice: index_put_ with accumulate
    sums each row in sorted-index order, where index_add_ adds with
    atomics."""
    G_ = importlib.import_module("point_sam_tpu_torch.ops.group")
    rng = np.random.default_rng(12)
    x = to(rng.standard_normal((2, 1024, 512)).astype(np.float32), cuda).requires_grad_()
    idx = to(rng.integers(0, 1024, (2, 10000, 3)).astype(np.int32), cuda)
    dy = to(rng.standard_normal((2, 10000, 3, 512)).astype(np.float32), cuda)
    first, second = (torch.autograd.grad(G_.batch_index_select(x, idx), x, dy)[0]
                     for _ in range(2))
    assert torch.equal(first, second)
    want = torch.zeros_like(x).reshape(-1, 512).index_add_(
        0, (idx.long() + 1024 * torch.arange(2, device=cuda)[:, None, None]).reshape(-1),
        dy.reshape(-1, 512)).reshape(x.shape)
    assert_rel(first, want, 1e-5)


@pytest.mark.cuda
def test_k7_kernel_routes_ties_to_first_row(cuda):
    rng = np.random.default_rng(8)
    x, params, do = pe_bwd_case(rng, cuda, torch.float32, 4, 16, 6, 64, ties=True)
    kw = dict(num_groups=4, group_size=16, cdt=torch.float32, act="erf")
    _, saved = PE.patch_encoder_cuda(x, params, return_argmax=True, **kw)
    gdx, gdp = PE.patch_encoder_bwd_cuda(x, params, do, saved=saved, **kw)
    wdx, wdp = PE.patch_encoder_bwd_plain(x, params, do, **kw)
    for g_, w_ in zip((gdx, *gdp), (wdx, *wdp)):
        assert_rel(g_, w_, 1e-4)
    dx = n(gdx).reshape(2, 4, 16, 6)
    # Every max of a tied pair is credited to the first row of the pair.
    assert np.abs(dx[:, :, 1] - dx[:, :, 0]).max() > 0


@pytest.mark.cuda
def test_kernel_outputs_carry_grad_fn(cuda):
    """Under autograd on the card the outputs of K2, K3, K4 and K5 are
    differentiable (their backward is K7, K6 and the recomputes)."""
    rng = np.random.default_rng(9)
    q = to(rng.standard_normal((1, 64, 128)).astype(np.float32), cuda).requires_grad_()
    out = A.mha_flat(q, q, q, 2)
    assert out.grad_fn is not None
    out.sum().backward()
    assert q.grad is not None and torch.isfinite(q.grad).all()
    q88 = to(rng.standard_normal((1, 64, 176)).astype(np.float32), cuda).requires_grad_()
    A.mha_heads_cuda.launches = 0
    out = A.mha_flat(q88, q88, q88, 2)  # dh=88: head-split, K5
    assert A.mha_heads_cuda.launches == 1 and out.grad_fn is not None
    out.sum().backward()
    assert torch.isfinite(q88.grad).all()
    params = tuple(p.requires_grad_() for p in to(pe_params(rng, 6, 128, 512, 64), cuda))
    x = to(rng.standard_normal((1, 4 * 16, 6)).astype(np.float32), cuda)
    out = PE.patch_encoder_fused(x, params, num_groups=4, group_size=16, cdt=torch.float32)
    assert out.grad_fn is not None
    out.sum().backward()
    assert all(p.grad is not None for p in params)
    h1, idx, w, uparams, hyper = upscale_inputs(rng, d=256)
    h1 = to(h1, cuda).requires_grad_()
    out = UP.interp_upscale_hyper_fused(h1, to(idx, cuda), to(w, cuda), to(uparams, cuda),
                                        to(hyper, cuda), cdt=torch.float32)
    assert out.grad_fn is not None
    out.sum().backward()
    assert h1.grad is not None and torch.isfinite(h1.grad).all()


# ------------------------------------------------------------ K9, K11
def k9_inputs(case):
    """(points, valid, l_lanes, k): the inputs the JAX package's K9 tests
    use (tests/test_ops_geometry.py), and a larger cloud with 32 points per
    bin."""
    rng = np.random.default_rng(0)
    pts = rng.standard_normal((1, 1500, 3)).astype(np.float32)
    valid, l_lanes, k = None, 512, 16
    if case == "binned":
        pts = rng.standard_normal((1, 1800, 3)).astype(np.float32)
        l_lanes = 128
    elif case == "valid":
        valid = np.ones((1, 1500), bool)
        valid[:, 1100:] = False
        valid[:, 0] = False
    elif case == "ties":
        pts = np.tile(rng.standard_normal((1, 700, 3)).astype(np.float32), (1, 2, 1))
        k = 8
    elif case == "large":
        pts = rng.standard_normal((1, 131_072, 3)).astype(np.float32)
        valid = np.ones((1, 131_072), bool)
        valid[:, 100_000:] = False
        k = 64
    return pts, valid, l_lanes, k


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["small", "binned", "valid", "ties", "large"])
def test_k9_kernel_matches_plain(cuda, case):
    pts, valid, l_lanes, k = k9_inputs(case)
    pts = to(pts, cuda)
    valid = None if valid is None else to(valid, cuda)
    got = F.fps_interp_knn_cuda(pts, 128, k, valid=valid, l_lanes=l_lanes)
    torch.cuda.synchronize()
    want = F.fps_interp_knn_plain(pts, 128, k, valid=valid, l_lanes=l_lanes)
    for name, g, w in zip(("fps_idx", "centers", "interp_idx", "interp_d2", "knn_idx"), got,
                          want):
        assert torch.equal(g, w), name
    ref = F.fps_interp_cuda(pts, 128, valid=valid)  # selection and interp are K1's
    for g, w in zip(got[:4], ref):
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
def test_k11_kernel_matches_plain(cuda, dtype, tol):
    rng = np.random.default_rng(10)
    x = to(rng.standard_normal((2, 1000, 128)).astype(np.float32), cuda, dtype)
    _, _, _, params, hyper = to(upscale_inputs(rng, b=1, m=2, d=128), cuda)
    got = UP.upscale_hyper_cuda(x, params, hyper, cdt=dtype)
    torch.cuda.synchronize()
    assert got.shape == (2, 3, 1000) and got.dtype == torch.float32
    assert_rel(got, UP.upscale_hyper_reference(x, params, hyper, cdt=dtype), tol)


@pytest.mark.cuda
def test_decoder_tail_launches_k11_where_k4_gate_fails(cuda):
    """G=64 fails K4's gate: the gather and K11, matching the plain chain."""
    rng = np.random.default_rng(11)
    h1, idx, w, params, hyper = to(upscale_inputs(rng, b=1, m=2, g=64, nq=500, d=128), cuda)
    before = (UP.upscale_hyper_cuda.launches, UP.interp_upscale_cuda.launches)
    got = UP.decoder_tail(h1, idx, w, params, hyper, cdt=torch.float32)
    torch.cuda.synchronize()
    assert (UP.upscale_hyper_cuda.launches, UP.interp_upscale_cuda.launches) == (
        before[0] + 1, before[1])
    assert_rel(got, UP.interp_upscale_reference(h1, idx, w, params, hyper, cdt=torch.float32),
               1e-4)
