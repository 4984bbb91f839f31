"""The hand-written CUDA kernels K1-K4 of point_sam_tpu_torch against their
plain torch versions.

The ``cuda``-marked tests need a card and skip without one. This file
imports neither JAX nor the JAX package, so on a machine with a card (and
no JAX) it runs on its own:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_port_kernels.py

Tolerances: fp32 kernels sum in another order than torch's matmuls
(1e-5 attention, 1e-4 for the deeper PointNet / decode-tail chains); bf16
kernels round where the reference rounds but accumulate in another order
(2e-2 relative, the bound the JAX package's chip smoke uses for its bf16
kernels). K1 is exact: indices equal and d^2 bit-equal.
"""

import importlib

import numpy as np
import pytest
import torch

A = importlib.import_module("point_sam_tpu_torch.ops.attention")
F = importlib.import_module("point_sam_tpu_torch.ops.fps")
PE = importlib.import_module("point_sam_tpu_torch.ops.patch_encoder_pallas")
UP = importlib.import_module("point_sam_tpu_torch.ops.upscale_pallas")


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


def test_wrappers_refuse_cpu_tensors():
    """A kernel wrapper launches on CUDA tensors or raises; it never falls
    back to the plain version."""
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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("act", ["erf", "tanh"])
@pytest.mark.parametrize("G,K,cin,cout", [(32, 16, 6, 512), (8, 20, 4, 256), (4, 24, 6, 40)])
def test_k2_kernel_matches_plain(cuda, dtype, tol, act, G, K, cin, cout):
    rng = np.random.default_rng(2)
    params = to(pe_params(rng, cin, 128, 512, cout), cuda)
    x = to(rng.standard_normal((2, G * K, cin)).astype(np.float32), cuda)
    kw = dict(num_groups=G, group_size=K, cdt=dtype, act=act)
    got = PE.patch_encoder_cuda(x, params, **kw)
    assert got.dtype == dtype and got.shape == (2, G, cout)
    assert_rel(got, PE.patch_encoder_plain(x, params, **kw), tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("B,S,H,dh", [(1, 32, 4, 32), (2, 200, 2, 64), (1, 64, 1, 88),
                                      (1, 130, 1, 128)])
def test_k3_kernel_matches_plain(cuda, dtype, tol, B, S, H, dh):
    rng = np.random.default_rng(3)
    q, k, v = (to(rng.standard_normal((B, S, H * dh)).astype(np.float32), cuda, dtype)
               for _ in range(3))
    got = A.mha_cuda(q, k, v, H)
    assert got.dtype == dtype
    assert_rel(got, A.mha_plain(q, k, v, H), tol)


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
