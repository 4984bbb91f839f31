"""The hier serving slice of the port against the JAX package, on the CPU
in fp32: the two-level geometry, ``PatchEmbedHier``, ``MaskEncoderHier``,
``MaskDecoderHier``, ``predict_masks``, the whole ``Predictor`` (the
default grouping and both override forms), ``build_model`` of
configs/model/hier.yaml and the converter's hier key table.

The model is the one tests/test_predictor.py builds (ViT "tiny",
G=(64, 16), K=(8, 4)) with hier.yaml's radii (0.05, 0.1). Weights come
from the JAX side (``init_variables`` with seeded noise on every bias and
LayerNorm scale) through ``state_dict_from_flax``.

At G1=64 the decoder tail takes the gather and K11's plain version (JAX's
K4 gate needs G1 % 128 == 0); the decoder test also runs G1=128, where it
takes K4's plain version. JAX runs its module path off the TPU either way.

Tolerances: indices equal and 3-NN weights within 1e-6 of the Pallas
kernel's (the weights are K10's, as in tests/test_torch_port_voronoi.py),
1e-5 of JAX's CPU geometry (its kNN-expansion distances round otherwise);
modules within 1e-4 absolute; ``predict_masks`` and the Predictor as in
tests/test_torch_port_predictor.py (logits 1e-3, IoU scores 1e-4, masks
equal wherever |logit| >= 1e-3).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from point_sam_tpu import models as J
from point_sam_tpu.models.prompt_encoder import mask_group_rel_xyz as j_rel_xyz
from point_sam_tpu.models.tokenizer import HierTokenizerConfig as JHierTok
from point_sam_tpu.models.tokenizer import compute_geometry_hier as j_geometry
from point_sam_tpu.ops.interp_pallas import interp_weights_pallas
from point_sam_tpu.serving.predictor import Predictor as JPredictor
from point_sam_tpu.utils import convert as jconvert
from point_sam_tpu.utils.config import build_model as j_build_model

from point_sam_tpu_torch import models as P
from point_sam_tpu_torch.ops import upscale_pallas as UP
from point_sam_tpu_torch.serving import Predictor
from point_sam_tpu_torch.utils import state_dict_from_flax, torch_key_for
from point_sam_tpu_torch.utils.config import build_model, load_config

G1, G2, K1, K2 = 64, 16, 8, 4
RADIUS = (0.05, 0.1)


def t(a):
    return torch.from_numpy(np.array(a))


def n(x):
    return x.detach().float().numpy()


def perturb(variables, seed=0):
    """Numpy copy of a variables tree with N(0, 0.05) noise on every bias
    and LayerNorm scale (the ViT's stacked [depth, D] ones included)."""
    rng = np.random.default_rng(seed)

    def leaf(path, a):
        a = np.array(a, np.float32)
        if a.ndim != 1 and path[-1].key not in ("bias", "scale"):
            return a
        return a + 0.05 * rng.standard_normal(a.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, variables)


def jax_model(g1=G1):
    return J.PointCloudSAMHier(J.HierConfig(
        vit="tiny", tokenizer=JHierTok((g1, G2), (K1, K2), radius=RADIUS), prompt_iters=3))


def port_model(g1=G1):
    return P.PointCloudSAMHier(P.HierConfig(
        vit="tiny", tokenizer=P.HierTokenizerConfig((g1, G2), (K1, K2), radius=RADIUS)),
        generator=torch.Generator().manual_seed(0))


@pytest.fixture(scope="module")
def tiny():
    """(JAX model, perturbed variables, port model with those weights)."""
    jm = jax_model()
    v = perturb(jax.tree_util.tree_map(np.asarray, J.init_variables(jm, jax.random.PRNGKey(0))))
    pm = port_model()
    pm.load_state_dict(state_dict_from_flax(v), strict=True)
    return jm, v, pm.eval()


def make_cloud(rng, n=1200):
    xyz = rng.standard_normal((n, 3)).astype(np.float32)
    xyz /= np.abs(xyz).max() + 1e-3
    rgb = rng.random((n, 3)).astype(np.float32)
    return xyz, rgb


def hier_inputs(rng, g1=G1, n_pts=400):
    """A padded cloud, its features, and both packages' geometry."""
    coords = rng.uniform(-1, 1, (1, n_pts, 3)).astype(np.float32)
    feats = rng.random((1, n_pts, 3)).astype(np.float32)
    valid = np.ones((1, n_pts), bool)
    valid[0, n_pts - 40:] = False
    tok = JHierTok((g1, G2), (K1, K2), radius=RADIUS)
    jg = j_geometry(jnp.asarray(coords), tok, point_valid=jnp.asarray(valid))
    pg = P.compute_geometry_hier(t(coords), P.HierTokenizerConfig((g1, G2), (K1, K2), RADIUS),
                                 point_valid=t(valid))
    return coords, feats, valid, jg, pg


# -------------------------------------------------------------- geometry
def test_geometry_hier_matches_jax():
    """FPS (K8's plain version), both exact kNNs and both 3-NN interp
    weights (K10's plain version, also held to the Pallas kernel) on a
    padded cloud with the first point invalid."""
    rng = np.random.default_rng(1)
    coords = rng.uniform(-1, 1, (2, 700, 3)).astype(np.float32)
    valid = np.ones((2, 700), bool)
    valid[0, :3] = False
    valid[1, 600:] = False
    tok = JHierTok((G1, G2), (K1, K2), radius=RADIUS)
    want = j_geometry(jnp.asarray(coords), tok, point_valid=jnp.asarray(valid))
    got = P.compute_geometry_hier(t(coords), P.HierTokenizerConfig((G1, G2), (K1, K2), RADIUS),
                                  point_valid=t(valid))
    assert set(got) == set(want)
    for k in ("fps_idx1", "centers1", "knn_idx1", "centers2", "knn_idx2", "centers",
              "interp_index", "interp_index_21"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    # JAX's CPU path weighs by the kNN expansion's distances, which round
    # otherwise (up to ~2e-6 here); the Pallas kernel below is held to 1e-6.
    for k in ("interp_weight", "interp_weight_21"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=1e-5, err_msg=k)
    assert got["fps_idx1"].dtype == got["knn_idx1"].dtype == torch.int32
    assert got["knn_idx1"].shape == (2, G1, K1) and got["knn_idx2"].shape == (2, G2, K2)
    for query, key, sfx in ((coords, want["centers1"], ""), (want["centers1"], want["centers2"],
                                                              "_21")):
        wi, ww = interp_weights_pallas(jnp.asarray(query), key, interpret=True)
        np.testing.assert_array_equal(got["interp_index" + sfx].numpy(), np.asarray(wi))
        np.testing.assert_allclose(got["interp_weight" + sfx].numpy(), np.asarray(ww),
                                   atol=1e-6)


# -------------------------------------------------------------- modules
def test_patch_embed_hier(tiny):
    jm, v, pm = tiny
    coords, feats, _, jg, pg = hier_inputs(np.random.default_rng(2))
    w1, w2 = jm.apply(v, coords, feats, jg, method=lambda m, c, f, g: m.patch_embed(c, f, g))
    g1, g2 = pm.pc_encoder.patch_embed(t(coords), t(feats), pg)
    assert g1.shape == (1, G1, 128) and g2.shape == (1, G2, 512)
    np.testing.assert_allclose(n(g1), np.asarray(w1), atol=1e-4)
    np.testing.assert_allclose(n(g2), np.asarray(w2), atol=1e-4)


@pytest.mark.parametrize("cached", [False, True])
def test_mask_encoder_hier(tiny, cached):
    """[B*M, N] mask logits (M=2) through both levels, with and without the
    cached per-level offsets (radius per level), and the no-mask embedding."""
    jm, v, pm = tiny
    rng = np.random.default_rng(3)
    coords, _, _, jg, pg = hier_inputs(rng)
    masks = rng.standard_normal((2, coords.shape[1])).astype(np.float32)
    jrel = prel = (None, None)
    if cached:
        jrel = (j_rel_xyz(coords, jg["centers1"], jg["knn_idx1"], radius=RADIUS[0]),
                j_rel_xyz(jg["centers1"], jg["centers2"], jg["knn_idx2"], radius=RADIUS[1]))
        prel = tuple(pm.prompt_cache(t(coords), pg).values())
        for a, b in zip(prel, jrel):
            np.testing.assert_allclose(n(a), np.asarray(b), atol=1e-6)
    geo = lambda g: (g["centers1"], g["knn_idx1"], g["centers2"], g["knn_idx2"])  # noqa: E731
    w1, w2 = jm.apply(v, jnp.asarray(masks), coords, *geo(jg), *jrel,
                      method=lambda m, *a: m.mask_encoder(*a))
    g1, g2 = pm.mask_encoder(t(masks), t(coords), *geo(pg), *prel)
    assert g1.shape == (2, G1, 128) and g2.shape == (2, G2, 256)
    np.testing.assert_allclose(n(g1), np.asarray(w1), atol=1e-4)
    np.testing.assert_allclose(n(g2), np.asarray(w2), atol=1e-4)
    _, none_want = jm.apply(v, None, coords, *geo(jg), method=lambda m, *a: m.mask_encoder(*a))
    none1, none_got = pm.mask_encoder(None, t(coords), *geo(pg))
    assert none1 is None
    np.testing.assert_array_equal(n(none_got), np.asarray(none_want))


@pytest.mark.parametrize("g1,multimask", [(G1, True), (G1, False), (128, True)])
def test_mask_decoder_hier(g1, multimask):
    """The two-stage decoder on random tokens, M=2 replicas; at G1=64 the
    tail takes the gather and K11's plain version, at G1=128 K4's."""
    jm = jax_model(g1)
    v = perturb(jax.tree_util.tree_map(np.asarray, J.init_variables(jm, jax.random.PRNGKey(1))))
    pm = port_model(g1)
    pm.load_state_dict(state_dict_from_flax(v), strict=True)
    rng = np.random.default_rng(4)
    coords, _, _, jg, pg = hier_inputs(rng, g1)
    N = coords.shape[1]
    k4 = UP.interp_upscale_dispatch_ok(N, g1, 128, 3 if multimask else 1, torch.float32, m=2)
    assert k4 == (g1 != G1)
    emb, pe, dense = (rng.standard_normal(s).astype(np.float32)
                      for s in ((1, G2, 256), (1, G2, 256), (2, G2, 256)))
    e1 = rng.standard_normal((1, g1, 128)).astype(np.float32)
    sparse = rng.standard_normal((2, 2, 256)).astype(np.float32)
    pv = np.array([[True, True], [True, False]])
    wm, wi = jm.apply(v, emb, pe, sparse, dense, geom=jg, embeddings_l1=e1,
                      prompt_valid=jnp.asarray(pv), multimask_output=multimask,
                      method=lambda m, *a, **k: m.mask_decoder(*a, **k))
    gm, gi = pm.mask_decoder(t(emb), t(pe), t(sparse), t(dense), geom=pg, embeddings_l1=t(e1),
                             prompt_valid=t(pv), multimask_output=multimask)
    assert gm.shape == (2, 3 if multimask else 1, N) and gm.dtype == torch.float32
    np.testing.assert_allclose(n(gm), np.asarray(wm), atol=1e-4)
    np.testing.assert_allclose(n(gi), np.asarray(wi), atol=1e-4)


def test_predict_masks_matches_jax(tiny):
    """Encode + one decode with a mask prompt, from the raw cloud."""
    jm, v, pm = tiny
    rng = np.random.default_rng(5)
    coords, feats, valid, _, _ = hier_inputs(rng)
    pc = coords[:, [10, 20]]
    pl = np.array([[True, False]])
    pmask = rng.standard_normal((1, coords.shape[1])).astype(np.float32)
    wm, wi = jm.apply(v, coords, feats, pc, pl, jnp.asarray(pmask),
                      point_valid=jnp.asarray(valid), multimask_output=True,
                      method=jm.predict_masks)
    gm, gi = pm.predict_masks(t(coords), t(feats), t(pc), t(pl), t(pmask),
                              point_valid=t(valid), multimask_output=True)
    np.testing.assert_allclose(n(gm), np.asarray(wm), atol=1e-3)
    np.testing.assert_allclose(n(gi), np.asarray(wi), atol=1e-4)


def test_forward_raises(tiny):
    """The training forward clicks by the random sampler, so it raises
    without a generator (also with ``is_eval``); given one, it returns
    ``prompt_iters`` (8, the default) dicts with the documented keys and
    shapes (M=2).
    Its numbers against JAX: tests/test_torch_port_hier_train.py."""
    _, _, pm = tiny
    coords, feats, valid, _, _ = hier_inputs(np.random.default_rng(6))
    gt = torch.from_numpy(np.random.default_rng(7).random((1, 2, coords.shape[1])) < 0.3)
    args = (t(coords), t(feats), gt)
    with pytest.raises(ValueError, match="needs a torch.Generator"):
        pm(*args, is_eval=True, point_valid=t(valid))
    with torch.no_grad():
        outs = pm(*args, point_valid=t(valid), generator=torch.Generator().manual_seed(0))
    assert len(outs) == pm.cfg.prompt_iters == 8
    N = coords.shape[1]
    for i, out in enumerate(outs):
        assert set(out) == {"prompt_coords", "prompt_labels", "prompt_valid", "masks",
                            "iou_preds", "max_iou_pred_ind", "prompt_masks"}
        c = 3 if i == 0 else 1
        assert out["masks"].shape == (2, c, N) and out["iou_preds"].shape == (2, c)
        assert out["prompt_coords"].shape == (2, i + 1, 3)
        assert out["prompt_masks"].shape == (2, N)
        assert bool(torch.isfinite(out["masks"]).all())


# ------------------------------------------------------------ predictor
def assert_same_prediction(want, got):
    (wm, ws, wl), (gm, gs, gl) = want, got
    assert gm.shape == wm.shape and gl.shape == wl.shape and gs.shape == ws.shape
    np.testing.assert_allclose(gl, wl, atol=1e-3)
    np.testing.assert_allclose(gs, ws, atol=1e-4)
    sure = np.abs(wl) >= 1e-3
    np.testing.assert_array_equal(gm[sure], wm[sure])


@pytest.mark.parametrize("override,group", [
    (None, ((G1, G2), (K1, K2))),
    (dict(group_number=96), ((96, G2), (K1, K2))),
    (dict(group_number=(128, 32), group_size=(8, 4)), ((128, 32), (8, 4))),
])
def test_predictor_matches_jax(tiny, override, group):
    """The default grouping (the model's, no N > 30000 rule), a scalar
    override (level 1 only) and a 2-tuple override (both levels): 2 clicks,
    the second with the first's best logits as mask prompt."""
    jm, v, pm = tiny
    jp = JPredictor(jm, v, point_buckets=(2048,))
    tp = Predictor(pm, device="cpu", point_buckets=(2048,))
    xyz, rgb = make_cloud(np.random.default_rng(0))
    for p_ in (jp, tp):
        p_.set_pointcloud(xyz, rgb, **(override or {}))
    assert tp._state["group"] == jp._state["group"] == group
    assert tp._state["emb"].shape == (1, group[0][1], 256)
    assert tp._state["extras"][0].shape == (1, group[0][0], 128)
    geom, jgeom = tp._state["geom"], jp._state["geom"]
    for k in ("fps_idx1", "knn_idx1", "knn_idx2", "interp_index", "interp_index_21"):
        np.testing.assert_array_equal(geom[k].numpy(), np.asarray(jgeom[k]), err_msg=k)
    for k in ("mask_rel_xyz1", "mask_rel_xyz2"):
        np.testing.assert_allclose(n(geom[k]), np.asarray(jgeom[k]), atol=1e-6, err_msg=k)

    want = jp.predict_masks(xyz[10:11], [1])
    got = tp.predict_masks(xyz[10:11], [1])
    assert got[0].shape == (1, 3, 1200)
    assert_same_prediction(want, got)
    prev = want[2][0, int(np.argmax(want[1][0]))]
    want = jp.predict_masks(xyz[[10, 500]], [1, 0], prev, False)
    got = tp.predict_masks(xyz[[10, 500]], [1, 0], prev, False)
    assert got[0].shape == (1, 1, 1200)
    assert_same_prediction(want, got)


# --------------------------------------------------- config, converter
def test_build_model_hier_yaml():
    """configs/model/hier.yaml builds the same configuration in both
    packages: on the meta device at full width (EVA02-L, 24 blocks of
    D=1024), and at tiny depth with the JAX model's parameter tree."""
    cfg = load_config("model/hier")
    jm = j_build_model(cfg)
    pm = build_model(cfg, device="meta")
    assert type(pm).__name__ == "PointCloudSAMHier" and pm.dtype == torch.float32
    for f in ("embed_dim", "patch_embed_channels", "num_multimask_outputs", "decoder_depth",
              "decoder_num_heads", "decoder_mlp_dim"):
        assert getattr(pm.cfg, f) == getattr(jm.cfg, f), f
    assert pm.cfg.tokenizer == P.HierTokenizerConfig((2048, 512), (32, 32), (0.05, 0.1))
    assert (jm.cfg.tokenizer.num_patches, jm.cfg.tokenizer.patch_size,
            jm.cfg.tokenizer.radius) == ((2048, 512), (32, 32), (0.05, 0.1))
    vit = pm.cfg.vit_cfg
    assert (vit.embed_dim, vit.depth, vit.num_heads) == (1024, 24, 16)
    assert len(pm.pc_encoder.transformer.blocks) == 24
    sd = pm.state_dict()
    assert sd["pc_encoder.patch_embed.patch_encoder2.conv1.0.weight"].shape == (128, 131)
    assert sd["mask_decoder.output_upscaling2.0.weight"].shape == (256, 384)
    assert sd["mask_decoder.output_upscaling1.3.weight"].shape == (128, 128)
    assert sd["mask_decoder.output_hypernetworks_mlps.0.layers.2.weight"].shape == (128, 256)

    small = dict(cfg, vit="tiny")
    jv = J.init_variables(j_build_model(small), jax.random.PRNGKey(0))
    got = build_model(small, generator=torch.Generator().manual_seed(0)).state_dict()
    want = state_dict_from_flax(jax.tree_util.tree_map(np.asarray, jv))
    assert set(got) == set(want)
    assert all(got[k].shape == want[k].shape for k in got)


def test_converter_hier_key_table(tiny):
    """Every flax leaf maps to exactly one port key with its shape (kernels
    transposed), and every port parameter is filled; the hier modules' keys
    are the ones the JAX converter has no rule for."""
    _, v, pm = tiny
    flat = {}
    for path, arr in jconvert._flatten(v).items():
        if "/blocks/block/" in path:  # the scan-stacked ViT blocks, one per index
            head, tail = path.split("/blocks/block/")
            flat.update({f"{head}/blocks_{i}/{tail}": a for i, a in enumerate(np.asarray(arr))})
        else:
            flat[path] = arr
    keys = {}
    for path, arr in flat.items():
        if path == "params/point_encoder/label_embed":
            continue  # one row per key (tests/test_torch_port_models.py)
        key = torch_key_for(path)
        assert key not in keys, (key, path, keys.get(key))
        keys[key] = path
        want = np.asarray(arr).shape
        want = want[::-1] if path.endswith("/kernel") else want
        if path == "params/mask_encoder/no_mask_embed":
            want = (1,) + want
        assert tuple(pm.state_dict()[key].shape) == want, (key, path)
    sd = state_dict_from_flax(v)
    assert set(sd) == set(pm.state_dict())
    assert set(keys) | {f"point_encoder.point_embeddings.{i}.weight" for i in range(2)} == set(sd)
    hier = [k for k in sd if k.startswith(("pc_encoder.patch_embed.patch_encoder1.",
                                           "pc_encoder.patch_embed.patch_encoder2.",
                                           "mask_encoder.patch_encoder1.",
                                           "mask_encoder.patch_encoder2.",
                                           "mask_decoder.output_upscaling1.",
                                           "mask_decoder.output_upscaling2."))]
    assert len(hier) == 4 * 12 + 2 * 6
    assert all(jconvert.map_torch_key(k) is None for k in hier)
    for i in range(4):
        for j in range(3):
            assert torch_key_for(f"params/mask_decoder/hyper_mlp_{i}/Dense_{j}/kernel") == (
                f"mask_decoder.output_hypernetworks_mlps.{i}.layers.{j}.weight")
