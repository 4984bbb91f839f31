"""Parity of the PyTorch port's modules (point_sam_tpu_torch.models) with the
JAX package's, on the CPU in fp32, plus the weight converter and the
JAX-free import.

Weights always come from the JAX side (``init_variables`` or a module's
``init``, with seeded noise on every vector leaf so that biases and LN
parameters are not trivial) and reach the port through
``state_dict_from_flax``. Tolerances: 1e-5 absolute for single modules
(fp32, outputs of order 1), 1e-4 for chains of several attention and MLP
layers.
"""

import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from point_sam_tpu import models as J
from point_sam_tpu.models.prompt_encoder import mask_group_rel_xyz
from point_sam_tpu.utils import convert as jconvert

from point_sam_tpu_torch import models as P
from point_sam_tpu_torch.utils import state_dict_from_flax, torch_key_for


def perturb(variables, seed=0):
    """Numpy copy of a variables tree with N(0, 0.05) noise on 1-D leaves."""
    rng = np.random.default_rng(seed)

    def leaf(a):
        a = np.array(a, np.float32)
        return a + 0.05 * rng.standard_normal(a.shape).astype(np.float32) if a.ndim == 1 else a

    return jax.tree_util.tree_map(leaf, variables)


def port_state(variables, prefix):
    """The port's state dict of the submodule under ``prefix`` (a torch key
    prefix such as ``mask_decoder.transformer.``)."""
    sd = state_dict_from_flax(variables)
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


def t(a):
    return torch.from_numpy(np.array(a))


def n(x):
    return x.detach().numpy()


@pytest.fixture(scope="module")
def tiny():
    """(JAX model, perturbed variables, port model with those weights)."""
    jm = J.PointCloudSAM(J.PointSAMConfig(
        vit="tiny", tokenizer=J.TokenizerConfig(32, 16), prompt_iters=3))
    v = perturb(init_variables_np(jm))
    pm = P.PointCloudSAM(P.PointSAMConfig(vit="tiny", tokenizer=P.TokenizerConfig(32, 16)),
                         generator=torch.Generator().manual_seed(0))
    pm.load_state_dict(state_dict_from_flax(v), strict=True)
    return jm, v, pm.eval()


def init_variables_np(model):
    return jax.tree_util.tree_map(np.asarray, J.init_variables(model, jax.random.PRNGKey(0)))


# --------------------------------------------------------------- layers
def test_layer_norm(tiny):
    jm, v, pm = tiny
    x = np.random.default_rng(1).standard_normal((2, 7, 256)).astype(np.float32) * 3 + 1
    want = jm.apply(v, jnp.asarray(x), method=lambda m, x: m.mask_decoder.output_upscaling.norm(x))
    got = pm.mask_decoder.output_upscaling[1](t(x))
    np.testing.assert_allclose(n(got), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("act", ["erf", "tanh"])
def test_patch_encoder(act):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 8, 16, 6)).astype(np.float32)
    jmod = J.PatchEncoder(512, (128, 512), act=act)
    v = perturb(jax.tree_util.tree_map(np.asarray, jmod.init(jax.random.PRNGKey(1), x)))
    want = jmod.apply(v, jnp.asarray(x))
    pmod = P.PatchEncoder(6, 512, (128, 512), act=act)
    pmod.load_state_dict(port_state({"params": {"mask_encoder": {"patch_encoder": v["params"]}}},
                                    "mask_encoder.patch_encoder."))
    np.testing.assert_allclose(n(pmod(t(x))), np.asarray(want), atol=1e-5)


def test_tiny_vit():
    from point_sam_tpu.models.vit import ViT, get_vit_config

    x = np.random.default_rng(3).standard_normal((2, 32, 128)).astype(np.float32)
    jmod = ViT(get_vit_config("tiny"), remat=False)
    v = perturb(jax.tree_util.tree_map(np.asarray, jmod.init(jax.random.PRNGKey(2), x)))
    want = jmod.apply(v, jnp.asarray(x))
    pmod = P.ViT(P.get_vit_config("tiny"))
    pmod.load_state_dict(port_state({"params": {"pc_encoder": {"transformer": v["params"]}}},
                                    "pc_encoder.transformer."))
    assert len(pmod.blocks) == 2
    np.testing.assert_allclose(n(pmod(t(x))), np.asarray(want), atol=1e-5)


def test_presets_match():
    from point_sam_tpu.models.vit import VIT_PRESETS

    for name in ("eva02_base", "eva02_large", "tiny"):
        a, b = VIT_PRESETS[name], P.VIT_PRESETS[name]
        assert (a.embed_dim, a.depth, a.num_heads, a.mlp_hidden_dim) == (
            b.embed_dim, b.depth, b.num_heads, b.mlp_hidden_dim)
    assert P.get_vit_config("eva02_large").head_dim == 64


# ------------------------------------------------------ prompt encoders
def test_point_encoder_and_pe(tiny):
    jm, v, pm = tiny
    rng = np.random.default_rng(4)
    pts = rng.uniform(-1, 1, (3, 4, 3)).astype(np.float32)
    labels = rng.random((3, 4)) > 0.5
    want = jm.apply(v, jnp.asarray(pts), jnp.asarray(labels),
                    method=lambda m, p, l: m.point_encoder(p, l))
    np.testing.assert_allclose(n(pm.point_encoder(t(pts), t(labels))), np.asarray(want),
                               atol=1e-5)
    want_pe = jm.apply(v, jnp.asarray(pts), method=lambda m, p: m.point_encoder.pe_layer(p))
    np.testing.assert_allclose(n(pm.point_encoder.pe_layer(t(pts))), np.asarray(want_pe),
                               atol=1e-5)


@pytest.mark.parametrize("cached", [False, True])
def test_mask_encoder(tiny, cached):
    """[B*M, N] mask logits regrouped onto the geometry (M=2 replicas),
    with and without the cached rel-coords, and the no-mask embedding."""
    jm, v, pm = tiny
    rng = np.random.default_rng(5)
    coords = rng.uniform(-1, 1, (1, 300, 3)).astype(np.float32)
    centers = coords[:, :32]
    knn_idx = rng.integers(0, 300, (1, 32, 16)).astype(np.int32)
    masks = rng.standard_normal((2, 300)).astype(np.float32)
    rel = mask_group_rel_xyz(coords, centers, knn_idx) if cached else None
    want = jm.apply(v, jnp.asarray(masks), coords, centers, knn_idx, rel,
                    method=lambda m, *a: m.mask_encoder(*a))
    prel = P.mask_group_rel_xyz(t(coords), t(centers), t(knn_idx)) if cached else None
    if cached:
        np.testing.assert_array_equal(n(prel), np.asarray(rel))
    got = pm.mask_encoder(t(masks), t(coords), t(centers), t(knn_idx), rel_xyz=prel)
    np.testing.assert_allclose(n(got), np.asarray(want), atol=1e-5)
    none_want = jm.apply(v, None, coords, centers, knn_idx,
                         method=lambda m, *a: m.mask_encoder(*a))
    np.testing.assert_array_equal(
        n(pm.mask_encoder(None, t(coords), t(centers), t(knn_idx))), np.asarray(none_want))


# ------------------------------------------------------------- decoder
def test_two_way_transformer_padded_prompts():
    rng = np.random.default_rng(6)
    pc, pe = (rng.standard_normal((2, 10, 64)).astype(np.float32) for _ in range(2))
    tok = rng.standard_normal((2, 7, 64)).astype(np.float32)
    valid = np.ones((2, 7), bool)
    valid[0, 5:] = False  # padded prompt slots
    valid[1, 6:] = False
    jmod = J.TwoWayTransformer(depth=2, embed_dim=64, num_heads=4, mlp_dim=128)
    v = perturb(jax.tree_util.tree_map(
        np.asarray, jmod.init(jax.random.PRNGKey(3), pc, pe, tok, token_valid=valid)))
    wq, wk = jmod.apply(v, pc, pe, tok, token_valid=valid)
    pmod = P.TwoWayTransformer(2, 64, 4, 128)
    pmod.load_state_dict(port_state({"params": {"mask_decoder": {"transformer": v["params"]}}},
                                    "mask_decoder.transformer."))
    gq, gk = pmod(t(pc), t(pe), t(tok), token_valid=t(valid))
    np.testing.assert_allclose(n(gq), np.asarray(wq), atol=1e-4)
    np.testing.assert_allclose(n(gk), np.asarray(wk), atol=1e-4)
    # Padded slots are inert: changing them moves nothing downstream.
    tok2 = tok.copy()
    tok2[0, 5:] += 10.0
    gq2, gk2 = pmod(t(pc), t(pe), t(tok2), token_valid=t(valid))
    np.testing.assert_allclose(n(gk2), n(gk), atol=1e-5)
    np.testing.assert_allclose(n(gq2)[:, :5], n(gq)[:, :5], atol=1e-5)


@pytest.mark.parametrize("multimask", [True, False])
def test_mask_decoder(tiny, multimask):
    """B=1 cloud, M=2 mask replicas, padded prompts, dense prompts per
    replica; the decode tail runs K4's plain version."""
    jm, v, pm = tiny
    rng = np.random.default_rng(7)
    G, N, D = 32, 200, 256
    emb, pe = (rng.standard_normal((1, G, D)).astype(np.float32) for _ in range(2))
    sparse = rng.standard_normal((2, 4, D)).astype(np.float32)
    dense = rng.standard_normal((2, G, D)).astype(np.float32)
    pv = np.array([[True, True, False, False], [True, True, True, False]])
    idx = rng.integers(0, G, (1, N, 3)).astype(np.int32)
    w = rng.dirichlet(np.ones(3), (1, N)).astype(np.float32)
    wm, wi = jm.apply(v, emb, pe, sparse, dense, method=lambda m, *a: m.mask_decoder(
        *a, interp_index=idx, interp_weight=w, prompt_valid=pv, multimask_output=multimask))
    gm, gi = pm.mask_decoder(t(emb), t(pe), t(sparse), t(dense), interp_index=t(idx),
                             interp_weight=t(w), prompt_valid=t(pv),
                             multimask_output=multimask)
    assert gm.shape == (2, 3 if multimask else 1, N)
    np.testing.assert_allclose(n(gm), np.asarray(wm), atol=1e-4)
    np.testing.assert_allclose(n(gi), np.asarray(wi), atol=1e-5)


def test_encode(tiny):
    """Tokenizer geometry + patch embed + ViT + PE, whole encoder."""
    jm, v, pm = tiny
    rng = np.random.default_rng(8)
    coords = rng.uniform(-1, 1, (1, 400, 3)).astype(np.float32)
    feats = rng.random((1, 400, 3)).astype(np.float32)
    jg = jm.make_geometry(jnp.asarray(coords))
    we, wp = jm.apply(v, coords, feats, jg, method=jm.encode)
    pg = pm.make_geometry(t(coords))
    for k in ("fps_idx", "knn_idx", "interp_index"):
        np.testing.assert_array_equal(n(pg[k]), np.asarray(jg[k]))
    ge, gp = pm.encode(t(coords), t(feats), pg)
    np.testing.assert_allclose(n(ge), np.asarray(we), atol=1e-4)
    np.testing.assert_allclose(n(gp), np.asarray(wp), atol=1e-5)


@pytest.mark.parametrize("with_interp", [True, False])
def test_compute_geometry(with_interp):
    """Padded cloud (point_valid), both branches of compute_geometry."""
    from point_sam_tpu.models.tokenizer import compute_geometry

    rng = np.random.default_rng(9)
    coords = rng.uniform(-1, 1, (2, 500, 3)).astype(np.float32)
    valid = np.ones((2, 500), bool)
    valid[1, 420:] = False
    want = compute_geometry(jnp.asarray(coords), J.TokenizerConfig(24, 12),
                            point_valid=jnp.asarray(valid), with_interp=with_interp)
    got = P.compute_geometry(t(coords), P.TokenizerConfig(24, 12), point_valid=t(valid),
                             with_interp=with_interp)
    assert set(got) == set(want)
    for k in ("fps_idx", "centers", "knn_idx") + (("interp_index",) if with_interp else ()):
        np.testing.assert_array_equal(n(got[k]), np.asarray(want[k]), err_msg=k)
    if with_interp:
        np.testing.assert_allclose(n(got["interp_weight"]), np.asarray(want["interp_weight"]),
                                   atol=1e-5)


# ------------------------------------------------------------ converter
def test_converter_round_trip(tiny):
    """convert_state_dict(state_dict_from_flax(v), v) reproduces every leaf
    exactly, with nothing unmapped, unfilled or unsupported."""
    _, v, pm = tiny
    sd = {k: x.numpy() for k, x in state_dict_from_flax(v).items()}
    assert set(sd) == set(pm.state_dict())
    new_vars, report = jconvert.convert_state_dict(sd, v)
    assert report["unmapped"] == []
    assert report["unfilled"] == []
    assert report["variant_unsupported"] == []
    flat_a, flat_b = jconvert._flatten(v), jconvert._flatten(new_vars)
    assert set(flat_a) == set(flat_b)
    for k in flat_a:
        np.testing.assert_array_equal(np.asarray(flat_b[k]), np.asarray(flat_a[k]), err_msg=k)


def test_key_table_matches_map_torch_key(tiny):
    """Every key of the port's state dict maps (JAX rules) to a flax leaf
    that the port's own table maps back to the same key."""
    _, _, pm = tiny
    keys = list(pm.state_dict())
    assert any(k.startswith("pc_encoder.transformer.blocks.1.") for k in keys)
    for key in keys:
        mapped = jconvert.map_torch_key(key)
        assert mapped is not None, key
        assert torch_key_for(mapped[0]) == key


def test_state_dict_shapes(tiny):
    _, v, pm = tiny
    sd = pm.state_dict()
    assert sd["mask_encoder.no_mask_embed.weight"].shape == (1, 256)
    assert sd["point_encoder.point_embeddings.1.weight"].shape == (1, 256)
    assert sd["mask_decoder.output_upscaling.3.weight"].shape == (256, 256)
    assert sd["pc_encoder.transformer.blocks.0.attn.k_proj.weight"].shape == (128, 128)
    assert "pc_encoder.transformer.blocks.0.attn.k_proj.bias" not in sd


def test_cast_params_for_inference():
    m = P.PointCloudSAM(P.PointSAMConfig(vit="tiny", tokenizer=P.TokenizerConfig(32, 16)),
                        dtype=torch.bfloat16, generator=torch.Generator().manual_seed(0))
    P.cast_params_for_inference(m)
    assert m.pc_encoder.patch_proj.weight.dtype == torch.bfloat16
    assert m.pc_encoder.patch_proj.bias.dtype == torch.float32
    assert m.pc_encoder.transformer.norm.weight.dtype == torch.float32
    assert m.point_encoder.pe_layer.positional_encoding_gaussian_matrix.dtype == torch.float32
    assert P.for_inference(m) is m


def test_port_imports_no_jax():
    code = ("import sys, point_sam_tpu_torch; "
            "import point_sam_tpu_torch.serving, point_sam_tpu_torch.utils; "
            "import point_sam_tpu_torch.train.trainer, point_sam_tpu_torch.parallel; "
            "import point_sam_tpu_torch.datasets, point_sam_tpu_torch.ops.sampler; "
            "import point_sam_tpu_torch.models.loss, point_sam_tpu_torch.utils.checkpoint; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
            "or m.startswith('point_sam_tpu.') or m == 'point_sam_tpu']; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)
