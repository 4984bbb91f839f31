"""The port's remaining model modules against the JAX package, on the CPU.

- The propagate variants (``models/decoder_variants.py``: ``Propagate``,
  ``PropagateAttn``, ``PropagateNN``) at JAX's test shapes (B=2, N=100,
  L=8, D=32), fp32 within 1e-5 of the largest |JAX output| and bf16 within
  2e-2 of it, on JAX's initial variables carried across by
  ``utils/convert.py::state_dict_from_flax`` (every leaf mapped, shapes
  equal, a strict load).
- ``PatchEncoderNN`` and ``PromptEncoderNN`` at small widths, the latter
  with and without a mask prompt and with ``point_valid``.
- ``PatchDropout``: the kept indices equal ``jax.lax.top_k``'s on the same
  noise, in order; JAX's test's properties.
- ``ops.fps_gather`` against JAX's.

Torch runs on one intra-op thread here (a module fixture).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from point_sam_tpu import models as JM
from point_sam_tpu import ops as JO
from point_sam_tpu.models import decoder_variants as JV
from point_sam_tpu_torch import models as TM
from point_sam_tpu_torch import ops as TO
from point_sam_tpu_torch.models import decoder_variants as TV
from point_sam_tpu_torch.utils.convert import state_dict_from_flax, torch_key_for

B, N, L, D = 2, 100, 8, 32
VARIANTS = ("Propagate", "PropagateAttn", "PropagateNN")
DTYPES = {"fp32": (torch.float32, jnp.float32, 1e-5), "bf16": (torch.bfloat16, jnp.bfloat16, 2e-2)}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the ops are small, and the test files run in
    parallel processes that already hold every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def t(a):
    return torch.from_numpy(np.array(a))


def numpy_tree(variables):
    return jax.tree_util.tree_map(np.asarray, variables)


def close(got, want, rel, label=""):
    got = np.asarray(got.detach().float() if torch.is_tensor(got) else got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (label, got.shape, want.shape)
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= rel * scale, f"{label}: max err {err:.3g} > {rel} of {scale:.3g}"


@functools.cache
def variant_inputs():
    rng = np.random.default_rng(0)
    xyz = rng.standard_normal((B, N, 3)).astype(np.float32)
    rgb = rng.random((B, N, 3)).astype(np.float32)
    feats = rng.standard_normal((B, L, D)).astype(np.float32)
    return xyz, rgb, xyz[:, :L], feats


@functools.cache
def variant_variables(name):
    """JAX's initial variables of one variant (numpy leaves)."""
    xyz, rgb, centers, feats = variant_inputs()
    mod = getattr(JV, name)(feats_dim=D)
    return numpy_tree(jax.jit(mod.init)(jax.random.PRNGKey(0), xyz, rgb, centers, feats))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("name", VARIANTS)
def test_variant_matches_jax(name, dtype):
    tdt, jdt, rel = DTYPES[dtype]
    inputs = variant_inputs()
    v = variant_variables(name)
    want = jax.jit(getattr(JV, name)(feats_dim=D, dtype=jdt).apply)(v, *inputs)
    mod = getattr(TV, name)(D, dtype=tdt)
    mod.load_state_dict(state_dict_from_flax(v), strict=True)
    with torch.no_grad():
        got = mod(*(t(a) for a in inputs))
    assert got.dtype == tdt
    close(got, np.asarray(want, np.float32), rel, f"{name} {dtype}")


@pytest.mark.parametrize("name", VARIANTS)
def test_variant_near_centres_matches_jax(name):
    """Points 1e-4 from a centre (d^2 = 1e-8, the weights' eps; a cloud of
    radius ~0.01, so the d^2 expansion rounds far below that): the weights
    1 / (d^2 + eps) and the unit vector nbr / (dist + 1e-8) as JAX's."""
    xyz, rgb, _, feats = variant_inputs()
    xyz = 0.01 * xyz
    centers = xyz[:, :L]
    offset = np.random.default_rng(5).standard_normal((B, L, 3)).astype(np.float32)
    xyz[:, L:2 * L] = centers + 1e-4 * offset / np.linalg.norm(offset, axis=-1, keepdims=True)
    v = variant_variables(name)
    want = jax.jit(getattr(JV, name)(feats_dim=D).apply)(v, xyz, rgb, centers, feats)
    mod = getattr(TV, name)(D)
    mod.load_state_dict(state_dict_from_flax(v), strict=True)
    with torch.no_grad():
        got = mod(t(xyz), t(rgb), t(centers), t(feats))
    close(got, np.asarray(want), 1e-5, f"{name} near centres")


@pytest.mark.parametrize("name", VARIANTS)
def test_variant_leaves_all_mapped(name):
    """Every JAX leaf has a torch key of the same shape (kernels
    transposed), and the module has no key beyond them."""
    sd = state_dict_from_flax(variant_variables(name))
    own = getattr(TV, name)(D).state_dict()
    assert set(sd) == set(own)
    assert all(sd[k].shape == own[k].shape for k in sd)
    flat = jax.tree_util.tree_flatten_with_path(variant_variables(name))[0]
    assert len(flat) == len(sd)


@pytest.mark.parametrize("name", VARIANTS)
def test_variant_given_neighbours_is_bit_identical(name):
    xyz, rgb, centers, feats = (t(a) for a in variant_inputs())
    mod = getattr(TV, name)(D, generator=torch.Generator().manual_seed(1))
    nbrs = TO.nn1(xyz, centers) if name == "PropagateNN" else TO.knn(xyz, centers, 3)
    with torch.no_grad():
        assert torch.equal(mod(xyz, rgb, centers, feats),
                           mod(xyz, rgb, centers, feats, nbrs=nbrs))


def test_standalone_keys():
    assert torch_key_for("params/relative_mlp/Dense_0/kernel") == "relative_mlp.0.weight"
    assert torch_key_for("params/fc/LayerNorm_0/LayerNorm_0/scale") == "fc.1.weight"
    assert torch_key_for("params/conv2/Dense_1/bias") == "conv2.3.bias"
    assert torch_key_for("params/k_mlp/Dense_2/kernel") == "k_mlp.layers.2.weight"
    assert torch_key_for("params/res_2_norm/LayerNorm_0/bias") == "res_2_norm.bias"
    assert torch_key_for("buffers/gaussian_matrix") == "gaussian_matrix"
    # The voronoi model's own keys are untouched by the standalone rules.
    assert torch_key_for("params/mask_encoder/res_in/kernel") == "mask_encoder.res_in.weight"


def test_variants_backward_reaches_every_parameter():
    inputs = [t(a) for a in variant_inputs()]
    for name in VARIANTS:
        mod = getattr(TV, name)(D, generator=torch.Generator().manual_seed(0))
        mod(*inputs).square().mean().backward()
        for key, p in mod.named_parameters():
            assert p.grad is not None and torch.isfinite(p.grad).all(), (name, key)
            assert p.grad.abs().max() > 0, (name, key)


# ------------------------------------------------------------ PatchEncoderNN


def test_patch_encoder_nn_matches_jax():
    rng = np.random.default_rng(1)
    feats = rng.standard_normal((B, N, 7)).astype(np.float32)
    nn_idx = rng.integers(0, L - 1, (B, N)).astype(np.int32)  # centre L-1 gets no point
    jm = JM.PatchEncoderNN(24, L, (16, 32))
    v = numpy_tree(jax.jit(jm.init)(jax.random.PRNGKey(1), feats, nn_idx))
    want = np.asarray(jax.jit(jm.apply)(v, feats, nn_idx))
    mod = TM.PatchEncoderNN(7, 24, L, (16, 32))
    mod.load_state_dict(state_dict_from_flax(v), strict=True)
    got = mod(t(feats), t(nn_idx))
    close(got, want, 1e-5, "PatchEncoderNN")
    assert (got[:, L - 1] == 0).all()
    got.square().sum().backward()
    assert all(p.grad.abs().max() > 0 for p in mod.parameters())


# ----------------------------------------------------------- PromptEncoderNN


@functools.cache
def prompt_case():
    rng = np.random.default_rng(2)
    coords = rng.uniform(-1, 1, (B, N, 3)).astype(np.float32)
    centers = coords[:, :L]
    nn_idx = np.asarray(JO.nn1(jnp.asarray(coords), jnp.asarray(centers))[1])
    points = rng.uniform(-1, 1, (B, 3, 3)).astype(np.float32)
    labels = np.array([[1, 0, 1], [0, 1, 1]], np.int32)
    masks = rng.standard_normal((3 * B, N)).astype(np.float32)  # 3 masks a cloud
    valid = np.ones((B, N), bool)
    valid[:, -17:] = False
    jm = JM.prompt_encoder.PromptEncoderNN(embed_dim=32, num_patches=L)
    v = numpy_tree(jax.jit(jm.init)(jax.random.PRNGKey(2), points, labels, masks, coords,
                                    centers, nn_idx))
    mod = TM.PromptEncoderNN(32, L)
    mod.load_state_dict(state_dict_from_flax(v), strict=True)
    return jm, v, mod, (points, labels, masks, coords, centers, nn_idx, valid)


@pytest.mark.parametrize("case", ["mask", "no_mask", "point_valid"])
def test_prompt_encoder_nn_matches_jax(case):
    jm, v, mod, (points, labels, masks, coords, centers, nn_idx, valid) = prompt_case()
    masks = None if case == "no_mask" else masks
    with torch.no_grad():
        if case == "point_valid":
            # JAX's PromptEncoderNN takes no point_valid: its MaskEncoderNN does.
            want_sparse = jm.apply(v, points, labels, method="embed_points")
            enc = JM.MaskEncoderNN(embed_dim=32, num_patches=L)
            want_dense = jax.jit(enc.apply)({"params": v["params"]["mask_encoder"]}, masks,
                                            coords, centers, nn_idx, valid)
            got = mod(t(points), t(labels), t(masks), t(coords), t(centers), t(nn_idx),
                      t(valid))
        else:
            want_sparse, want_dense = jax.jit(jm.apply)(v, points, labels, masks, coords,
                                                        centers, nn_idx)
            got = mod(t(points), t(labels), None if masks is None else t(masks), t(coords),
                      t(centers), t(nn_idx))
    close(got[0], want_sparse, 1e-5, "sparse")
    close(got[1], want_dense, 1e-5, "dense")


def test_prompt_encoder_nn_more_patches_than_centres():
    """``num_patches`` sets the segment count: centres past L get an empty
    segment (0 before the residual MLP), as in JAX."""
    _, _, _, (points, labels, masks, coords, centers, nn_idx, valid) = prompt_case()
    jm = JM.MaskEncoderNN(embed_dim=32, num_patches=L + 3)
    v = numpy_tree(jax.jit(jm.init)(jax.random.PRNGKey(3), masks, coords, centers, nn_idx))
    want = jax.jit(jm.apply)(v, masks, coords, centers, nn_idx)
    mod = TM.PromptEncoderNN(32, L + 3)
    res = mod.load_state_dict(state_dict_from_flax({"params": {"mask_encoder": v["params"]}}),
                              strict=False)  # the mask encoder's leaves, every one of them
    assert not res.unexpected_keys
    assert all(k.startswith("point_encoder.") for k in res.missing_keys)
    with torch.no_grad():
        got = mod.embed_masks(t(masks), t(coords), t(centers), t(nn_idx))
    assert got.shape == (3 * B, L + 3, 32)
    close(got, want, 1e-5, "dense, L + 3 patches")


# -------------------------------------------------------------- PatchDropout


def test_patch_dropout_selection_matches_top_k():
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((2, 3 + 40, 8))
                         .astype(np.float32))
    pd = TV.PatchDropout(prob=0.3, num_prefix_tokens=3)
    kept, keep = pd(x, deterministic=False, generator=torch.Generator().manual_seed(5))
    noise = torch.randn((2, 40), generator=torch.Generator().manual_seed(5))
    _, want = jax.lax.top_k(jnp.asarray(noise.numpy()), int(40 * 0.7))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(want))
    assert torch.equal(kept[:, :3], x[:, :3])
    assert torch.equal(kept[:, 3:], torch.stack([x[b, 3:][keep[b]] for b in range(2)]))


def test_patch_dropout_properties():
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 20, 8)).astype(np.float32))
    pd = TV.PatchDropout(prob=0.5)
    out, keep = pd(x, deterministic=True)
    assert out is x and keep is None
    out, keep = TV.PatchDropout(prob=0.0)(x, deterministic=False)
    assert out is x and keep is None
    out, keep = pd(x, deterministic=False, generator=torch.Generator().manual_seed(2))
    assert out.shape == (2, 10, 8) and keep.shape == (2, 10)
    for b in range(2):
        assert len(set(keep[b].tolist())) == 10
        for row in out[b]:
            assert (x[b] == row).all(-1).any()
    out, _ = TV.PatchDropout(prob=0.99)(x, deterministic=False,
                                        generator=torch.Generator().manual_seed(2))
    assert out.shape == (2, 1, 8)
    with pytest.raises(ValueError, match="generator"):
        pd(x, deterministic=False)


# ----------------------------------------------------------------- fps_gather


@pytest.mark.parametrize("masked", [False, True])
def test_fps_gather_matches_jax(masked):
    rng = np.random.default_rng(4)
    pts = rng.standard_normal((2, 300, 3)).astype(np.float32)
    valid = None
    if masked:
        valid = np.ones((2, 300), bool)
        valid[0, :5] = False
        valid[1, 200:] = False
    want = JO.fps_gather(jnp.asarray(pts), 32,
                         valid=None if valid is None else jnp.asarray(valid))
    got = TO.fps_gather(t(pts), 32, valid=None if valid is None else t(valid))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    idx = TO.fps(t(pts), 32, valid=None if valid is None else t(valid))
    assert torch.equal(got, TO.batch_index_select(t(pts), idx))
