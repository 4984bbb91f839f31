"""The voronoi EVA-giant serving slice of the port against the JAX package,
on the CPU: kernels 5, 8 and 10 (plain versions against their Pallas
originals in interpret mode), the voronoi ops and modules, the weight
converter, and the whole ``Predictor`` over ``PointCloudSAMNN``.

Models are tiny and giant-shaped: the EVA-giant block layout (fused qkv,
plain GELU MLP) at D=176 with 2 heads of 88, so the head-split attention
path (K5's) runs as it does at full width. Weights come from the JAX side
(``init_variables`` with seeded noise on every vector leaf, the fused qkv
bias's k third kept at zero as timm's layout requires) through
``state_dict_from_flax``.

Tolerances: FPS (K8) and 3-NN (K10) indices are exact, K10 weights within
1e-6; K5 within 1e-5 of the largest output in fp32 and 2e-2 in bf16 (the
bf16 bound of the kernel tests); single modules 1e-5 absolute, chains of
attention and MLP layers 1e-4; the Predictor as in
tests/test_torch_port_predictor.py (logits 1e-3, IoU scores 1e-4, masks
equal wherever |logit| >= 1e-3).
"""

import importlib
from functools import partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import point_sam_tpu.ops.attention as JA
from point_sam_tpu import models as J
from point_sam_tpu.models.prompt_encoder import mask_nbr_dist as j_mask_nbr_dist
from point_sam_tpu.models.tokenizer import compute_geometry_voronoi as j_geometry
from point_sam_tpu.models.vit import ViTConfig as JViTConfig
from point_sam_tpu.ops.fps import fps_xla
from point_sam_tpu.ops.fps_pallas import fps_pallas
from point_sam_tpu.ops.interp_pallas import interp_weights_pallas
from point_sam_tpu.ops.scatter import gather_segments as j_gather_segments
from point_sam_tpu.ops.scatter import scatter_max as j_scatter_max
from point_sam_tpu.serving.predictor import Predictor as JPredictor
from point_sam_tpu.utils import convert as jconvert

from point_sam_tpu_torch import models as P
from point_sam_tpu_torch import ops
from point_sam_tpu_torch.serving import Predictor
from point_sam_tpu_torch.utils import state_dict_from_flax, torch_key_for

A = importlib.import_module("point_sam_tpu_torch.ops.attention")
F = importlib.import_module("point_sam_tpu_torch.ops.fps")
IW = importlib.import_module("point_sam_tpu_torch.ops.interp_pallas")

GIANT = dict(embed_dim=176, depth=2, num_heads=2, mlp_hidden_dim=352, swiglu=False,
             qkv_fused=True)
G = 32


def t(a):
    return torch.from_numpy(np.array(a))


def n(x):
    return x.detach().float().numpy()


def assert_rel(got, want, rel):
    """max |got - want| <= rel * max |want|."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    err = np.abs(got - want).max()
    assert err <= rel * np.abs(want).max(), (err, np.abs(want).max())


def perturb(variables, seed=0):
    """Numpy copy of a variables tree with N(0, 0.05) noise on every bias
    and LayerNorm scale (the ViT's stacked [depth, D] ones included); the k
    third of every fused qkv bias stays 0 (timm has no k bias)."""
    rng = np.random.default_rng(seed)

    def leaf(path, a):
        a = np.array(a, np.float32)
        name = path[-1].key
        if a.ndim != 1 and name not in ("bias", "scale"):
            return a
        a = a + 0.05 * rng.standard_normal(a.shape).astype(np.float32)
        if name == "bias" and "qkv" in jax.tree_util.keystr(path):
            d = a.shape[-1] // 3
            a[..., d:2 * d] = 0.0
        return a

    return jax.tree_util.tree_map_with_path(leaf, variables)


def jax_model(num_patches=G):
    return J.PointCloudSAMNN(J.VoronoiConfig(vit=JViTConfig(**GIANT), num_patches=num_patches,
                                             prompt_iters=3))


def port_model(num_patches=G):
    return P.PointCloudSAMNN(P.VoronoiConfig(vit=P.ViTConfig(**GIANT), num_patches=num_patches),
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


# ------------------------------------------------------------- kernel 8
@pytest.mark.parametrize("padded", [False, True])
def test_k8_plain_matches_fps_pallas_and_xla(padded):
    rng = np.random.default_rng(1)
    pts = rng.standard_normal((2, 3000, 3)).astype(np.float32)
    valid = None
    if padded:
        valid = np.ones((2, 3000), bool)
        valid[0, :5] = False  # the first valid point is not point 0
        valid[1, 2600:] = False
    jv = None if valid is None else jnp.asarray(valid)
    want = np.asarray(fps_pallas(jnp.asarray(pts), 64, valid=jv, interpret=True))
    np.testing.assert_array_equal(np.asarray(fps_xla(jnp.asarray(pts), 64, valid=jv)), want)
    tv = None if valid is None else t(valid)
    got = F.fps_plain(t(pts), 64, valid=tv)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(ops.fps(t(pts), 64, valid=tv).numpy(), want)  # CPU: plain


# ------------------------------------------------------------ kernel 10
@pytest.mark.parametrize("case", ["random", "grid"])
def test_k10_plain_matches_interp_pallas(case):
    rng = np.random.default_rng(2)
    q = rng.standard_normal((2, 3000, 3)).astype(np.float32)
    k = rng.standard_normal((2, 256, 3)).astype(np.float32)
    if case == "grid":  # coordinates on a 1/8 grid: exact distance ties
        q, k = np.round(q * 8) / 8, np.round(k * 8) / 8
    wi, ww = interp_weights_pallas(jnp.asarray(q), jnp.asarray(k), interpret=True)
    gi, gw = IW.interp_weights_plain(t(q), t(k))
    assert gi.dtype == torch.int32 and gw.dtype == torch.float32
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_allclose(gw.numpy(), np.asarray(ww), atol=1e-6)


def test_k10_plain_ranks_near_ties_as_pallas():
    """Keys at equal distance from the query in exact arithmetic (rotations
    of one offset): only the Pallas kernel's own fp32 distance bits,
    fma(dz, dz, fma(dx, dx, dy * dy)) as XLA compiles them, rank them the
    same way. The plain ((dx^2 + dy^2) + dz^2) sum disagrees on about half
    of these rows."""
    rng = np.random.default_rng(3)
    B = 300
    q = rng.standard_normal((B, 1, 3)).astype(np.float32)
    k = np.zeros((B, 8, 3), np.float32)
    for b in range(B):
        off = rng.standard_normal(3)
        for j in range(6):
            rot, _ = np.linalg.qr(rng.standard_normal((3, 3)))
            k[b, j] = q[b, 0] + rot @ off
        k[b, 6:] = q[b, 0] + 50 + rng.standard_normal((2, 3))
    wi, ww = interp_weights_pallas(jnp.asarray(q), jnp.asarray(k), tile_q=8, interpret=True)
    gi, gw = IW.interp_weights_plain(t(q), t(k))
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_allclose(gw.numpy(), np.asarray(ww), atol=1e-6)
    d = q - k
    naive = (d[..., 0] ** 2 + d[..., 1] ** 2) + d[..., 2] ** 2
    naive_idx = np.argsort(naive, axis=1, kind="stable")[:, :3]
    assert (naive_idx != np.asarray(wi)[:, 0]).any(1).sum() > B // 10


# ------------------------------------------------------------- kernel 5
@pytest.fixture
def interpret_mha_pallas(monkeypatch):
    monkeypatch.setattr(JA, "mha_pallas", partial(JA.mha_pallas, interpret=True))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k5_plain_matches_mha_pallas(dtype):
    tdt, jdt = (torch.float32, jnp.float32) if dtype == "float32" else (torch.bfloat16,
                                                                        jnp.bfloat16)
    rng = np.random.default_rng(4)
    q, k, v = (rng.standard_normal((2, 2, 64, 88)).astype(np.float32) for _ in range(3))
    want = JA.mha_pallas(*(jnp.asarray(a, jdt) for a in (q, k, v)), block_q=32, interpret=True)
    got = A.mha_heads_plain(*(t(a).to(tdt) for a in (q, k, v)))
    assert got.dtype == tdt
    assert_rel(n(got), np.asarray(want, np.float32), 1e-5 if dtype == "float32" else 2e-2)


def test_k5_function_grads_match_jax_vjp(interpret_mha_pallas):
    rng = np.random.default_rng(5)
    q, k, v, do = (rng.standard_normal((1, 2, 64, 88)).astype(np.float32) for _ in range(4))
    out, vjp = jax.vjp(JA.mha_pallas_ad, *(jnp.asarray(a) for a in (q, k, v)))
    want = vjp(jnp.asarray(do))
    ts = [t(a).requires_grad_() for a in (q, k, v)]
    got = A.mha(*ts)
    assert got.grad_fn is not None
    assert_rel(n(got), np.asarray(out), 1e-5)
    got.backward(t(do))
    for t_, w in zip(ts, want):
        assert_rel(n(t_.grad), np.asarray(w), 1e-5)


@pytest.mark.parametrize("D,H,packed", [(176, 2, False), (128, 4, False), (192, 3, False),
                                        (128, 2, True), (256, 2, True)])
def test_mha_flat_routes_as_jax(monkeypatch, D, H, packed):
    """K3 (packed) for head size 64 with an even head count or 128, K5
    (head-split) otherwise, with the JAX function's result either way."""
    taken = []
    for name in ("MhaPacked", "MhaHeads"):
        fn = getattr(A, name)
        monkeypatch.setattr(fn, "apply", partial(lambda f, nm, *a: (taken.append(nm), f(*a))[1],
                                                 fn.apply, name))
    rng = np.random.default_rng(6)
    q, k, v = (rng.standard_normal((1, 96, D)).astype(np.float32) for _ in range(3))
    want = JA.mha_flat(*(jnp.asarray(a) for a in (q, k, v)), H, use_pallas=False)
    got = A.mha_flat(t(q), t(k), t(v), H)
    assert taken == ["MhaPacked" if packed else "MhaHeads"]
    assert_rel(n(got), np.asarray(want), 1e-5)


# ------------------------------------------------------------ voronoi ops
def test_scatter_max_and_gather_segments_match_jax():
    """Empty segments give 0; points masked to -inf never win; a segment
    whose points are all masked gives 0."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 50, 6)).astype(np.float32)
    idx = rng.integers(0, 8, (2, 50)).astype(np.int32)  # segments 8, 9 stay empty
    idx[1, :10] = 7
    x[1, :10] = -np.inf  # segment 7 of row 1: only masked points
    idx[1, 10:] = np.where(idx[1, 10:] == 7, 6, idx[1, 10:])
    x[0, ::3] = -np.inf  # masked points among real ones
    want = np.asarray(j_scatter_max(jnp.asarray(x), jnp.asarray(idx), 10))
    got = ops.scatter_max(t(x), t(idx), 10)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got[:, 8:] == 0).all() and (got[1, 7] == 0).all()
    y = rng.standard_normal((2, 10, 4)).astype(np.float32)
    np.testing.assert_array_equal(ops.gather_segments(t(y), t(idx)).numpy(),
                                  np.asarray(j_gather_segments(jnp.asarray(y),
                                                               jnp.asarray(idx))))


def test_geometry_voronoi_matches_jax():
    """FPS (K8's plain version), the nearest-centre assignment (nn1) and
    the 3-NN interp weights on a padded batch. The weights are K10's, so
    they are held to the Pallas kernel (the JAX package's TPU path); its CPU
    path ranks by the kNN expansion, which gives the same indices here."""
    rng = np.random.default_rng(8)
    coords = rng.uniform(-1, 1, (2, 700, 3)).astype(np.float32)
    valid = np.ones((2, 700), bool)
    valid[1, 600:] = False
    want = j_geometry(jnp.asarray(coords), 24, point_valid=jnp.asarray(valid))
    got = P.compute_geometry_voronoi(t(coords), 24, point_valid=t(valid))
    assert set(got) == set(want)
    for k in ("fps_idx", "centers", "nn_idx", "point_valid", "interp_index"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    wi, ww = interp_weights_pallas(jnp.asarray(coords), want["centers"], interpret=True)
    np.testing.assert_array_equal(got["interp_index"].numpy(), np.asarray(wi))
    np.testing.assert_allclose(got["interp_weight"].numpy(), np.asarray(ww), atol=1e-6)
    d, i = ops.nn1(t(coords), got["centers"])
    assert d.shape == i.shape == (2, 700) and i.dtype == torch.int32
    np.testing.assert_array_equal(ops.group_voronoi(
        t(coords), t(coords), got["centers"], got["nn_idx"])[..., 4:].numpy(), coords)


# -------------------------------------------------------------- modules
def voronoi_inputs(rng, jm, n_pts=400):
    coords = rng.uniform(-1, 1, (1, n_pts, 3)).astype(np.float32)
    feats = rng.random((1, n_pts, 3)).astype(np.float32)
    valid = np.ones((1, n_pts), bool)
    valid[0, n_pts - 40:] = False
    jg = jm.make_geometry(jnp.asarray(coords), point_valid=jnp.asarray(valid))
    pg = P.compute_geometry_voronoi(t(coords), G, point_valid=t(valid))
    return coords, feats, valid, jg, pg


def test_patch_embed_nn(tiny):
    jm, v, pm = tiny
    coords, feats, _, jg, pg = voronoi_inputs(np.random.default_rng(9), jm)
    want = jm.apply(v, coords, feats, jg, method=lambda m, c, f, g: m.patch_embed(c, f, g))
    got = pm.pc_encoder.patch_embed(t(coords), t(feats), pg)
    assert got.shape == (1, G, 512)
    np.testing.assert_allclose(n(got), np.asarray(want), atol=1e-4)


@pytest.mark.parametrize("cached", [False, True])
def test_mask_encoder_nn(tiny, cached):
    """[B*M, N] mask logits (M=2) onto the voronoi cells of a padded cloud,
    with and without the cached offsets, and the no-mask embedding."""
    jm, v, pm = tiny
    rng = np.random.default_rng(10)
    coords, _, valid, jg, pg = voronoi_inputs(rng, jm)
    masks = rng.standard_normal((2, coords.shape[1])).astype(np.float32)
    jnd = j_mask_nbr_dist(coords, jg["centers"], jg["nn_idx"]) if cached else None
    pnd = P.mask_nbr_dist(t(coords), pg["centers"], pg["nn_idx"]) if cached else None
    if cached:
        for a, b in zip(pnd, jnd):
            np.testing.assert_allclose(n(a), np.asarray(b), atol=1e-6)
    want = jm.apply(v, jnp.asarray(masks), coords, jg["centers"], jg["nn_idx"], valid, jnd,
                    method=lambda m, *a: m.mask_encoder(*a))
    got = pm.mask_encoder(t(masks), t(coords), pg["centers"], pg["nn_idx"], t(valid),
                          nbr_dist=pnd)
    assert got.shape == (2, G, 256)
    np.testing.assert_allclose(n(got), np.asarray(want), atol=1e-4)
    none_want = jm.apply(v, None, coords, jg["centers"], jg["nn_idx"],
                         method=lambda m, *a: m.mask_encoder(*a))
    np.testing.assert_array_equal(
        n(pm.mask_encoder(None, t(coords), pg["centers"], pg["nn_idx"])), np.asarray(none_want))


def test_eva_giant_blocks(tiny):
    """The fused-qkv, GELU-MLP blocks + final norm (head size 88)."""
    jm, v, pm = tiny
    x = np.random.default_rng(11).standard_normal((2, 48, 176)).astype(np.float32)
    want = jm.apply(v, x, method=lambda m, x: m.pc_encoder.transformer(x))
    got = pm.pc_encoder.transformer(t(x))
    np.testing.assert_allclose(n(got), np.asarray(want), atol=1e-4)
    assert P.get_vit_config("eva_giant").head_dim == 88
    from point_sam_tpu.models.vit import VIT_PRESETS

    # JAX's mlp_norm is read only by its SwiGLU MLP; the port has no such
    # field (its SwiGLU always has the sub-LN, its GELU MLP none).
    a, b = VIT_PRESETS["eva_giant"], P.VIT_PRESETS["eva_giant"]
    fields = ("embed_dim", "depth", "num_heads", "mlp_hidden_dim", "swiglu", "qkv_fused")
    assert [getattr(a, f) for f in fields] == [getattr(b, f) for f in fields]
    assert all(c.mlp_norm for c in VIT_PRESETS.values() if c.swiglu)


def test_encode_takes_segment_count_from_geometry(tiny):
    """At G == cfg.num_patches the port's encode agrees with the JAX one; at
    another G (the Predictor's per-scene override) the port embeds every
    centre, [B, G, D], where the JAX package scatters onto cfg.num_patches
    segments and raises."""
    jm, v, pm = tiny
    rng = np.random.default_rng(12)
    coords = rng.uniform(-1, 1, (1, 500, 3)).astype(np.float32)
    feats = rng.random((1, 500, 3)).astype(np.float32)
    jg = jm.make_geometry(jnp.asarray(coords))
    we, wp = jm.apply(v, coords, feats, jg, method=jm.encode)
    ge, gp = pm.encode(t(coords), t(feats), pm.make_geometry(t(coords)))
    np.testing.assert_allclose(n(ge), np.asarray(we), atol=1e-4)
    np.testing.assert_allclose(n(gp), np.asarray(wp), atol=1e-5)

    pg = pm.make_geometry(t(coords), group_number=16)
    ge, gp = pm.encode(t(coords), t(feats), pg)
    assert ge.shape == (1, 16, 256) and gp.shape == (1, 16, 256)
    assert torch.isfinite(ge).all()
    jg16 = jm.make_geometry(jnp.asarray(coords), tokenizer=J.TokenizerConfig(16))
    with pytest.raises(TypeError, match="broadcast"):
        jm.apply(v, coords, feats, jg16, method=jm.encode)


# ------------------------------------------------------------ converter
VORONOI_KEYS = ("pc_encoder.patch_embed.", "mask_encoder.first_nn.", "mask_encoder.res_")


def test_converter_round_trip(tiny):
    """Every flax leaf maps and every port parameter is filled; the keys the
    JAX converter knows (EVA-giant's among them) agree with its
    ``map_torch_key`` both ways and round-trip exactly through
    ``convert_state_dict``; the voronoi modules' keys are the only ones it
    has no rule for."""
    _, v, pm = tiny
    sd = {k: x.numpy() for k, x in state_dict_from_flax(v).items()}
    assert set(sd) == set(pm.state_dict())
    for key in ("pc_encoder.transformer.blocks.1.attn.qkv.weight",
                "pc_encoder.transformer.blocks.1.attn.q_bias",
                "pc_encoder.transformer.blocks.1.attn.v_bias",
                "pc_encoder.transformer.blocks.1.mlp.fc1.weight"):
        assert key in sd
    ours = [k for k in sd if k.startswith(VORONOI_KEYS)]
    assert ours and all(jconvert.map_torch_key(k) is None for k in ours)
    for key in sd:
        if key in ours:
            continue
        mapped = jconvert.map_torch_key(key)
        assert mapped is not None, key
        assert torch_key_for(mapped[0]) == key
    new_vars, report = jconvert.convert_state_dict(sd, v, strict=False)
    assert sorted(report["unmapped"]) == sorted(ours)
    assert report["variant_unsupported"] == []
    assert all(p.startswith(("params/patch_embed/", "params/mask_encoder/first_nn/",
                             "params/mask_encoder/res_")) for p in report["unfilled"])
    flat_a, flat_b = jconvert._flatten(v), jconvert._flatten(new_vars)
    for k in flat_a:
        if k not in report["unfilled"]:
            np.testing.assert_array_equal(np.asarray(flat_b[k]), np.asarray(flat_a[k]),
                                          err_msg=k)


def test_converter_refuses_a_k_bias(tiny):
    _, v, _ = tiny
    bad = jax.tree_util.tree_map(np.array, v)
    bias = bad["params"]["pc_encoder"]["transformer"]["blocks"]["block"]["attn"]["qkv"]["bias"]
    bias[1, 176 + 3] = 0.5
    with pytest.raises(ValueError, match="k third"):
        state_dict_from_flax(bad)


# ------------------------------------------------------------ predictor
@pytest.fixture(scope="module")
def predictors(tiny):
    jm, v, pm = tiny
    return (JPredictor(jm, v, point_buckets=(2048,)),
            Predictor(pm, device="cpu", point_buckets=(2048,)))


def assert_same_prediction(want, got):
    (wm, ws, wl), (gm, gs, gl) = want, got
    assert gm.shape == wm.shape and gl.shape == wl.shape and gs.shape == ws.shape
    np.testing.assert_allclose(gl, wl, atol=1e-3)
    np.testing.assert_allclose(gs, ws, atol=1e-4)
    sure = np.abs(wl) >= 1e-3
    np.testing.assert_array_equal(gm[sure], wm[sure])


def test_three_clicks_match_jax(predictors):
    jp, tp = predictors
    xyz, rgb = make_cloud(np.random.default_rng(0))
    jp.set_pointcloud(xyz, rgb)
    tp.set_pointcloud(xyz, rgb)
    assert tp._state["group"] == (G, None) and tp._state["n_pad"] == 2048
    assert tp._state["emb"].shape == (1, G, 256)
    for k in ("fps_idx", "nn_idx", "interp_index"):
        np.testing.assert_array_equal(tp._state["geom"][k].numpy(),
                                      np.asarray(jp._state["geom"][k]), err_msg=k)
    for a, b in zip(tp._state["geom"]["mask_nbr_dist"], jp._state["geom"]["mask_nbr_dist"]):
        np.testing.assert_allclose(n(a), np.asarray(b), atol=1e-6)

    want = jp.predict_masks(xyz[10:11], [1])
    got = tp.predict_masks(xyz[10:11], [1])
    assert got[0].shape == (1, 3, 1200)
    assert_same_prediction(want, got)
    prev = want[2][0, int(np.argmax(want[1][0]))]
    for pts, labels in ((xyz[10:12], [1, 0]), (xyz[[10, 11, 500]], [1, 0, 1])):
        want = jp.predict_masks(pts, labels, prev, False)
        got = tp.predict_masks(pts, labels, prev, False)
        assert got[0].shape == (1, 1, 1200)
        assert_same_prediction(want, got)
        prev = want[2][0, 0]


def test_predictor_answers_above_30000_points(tiny):
    """The reference eval rule (N > 30000 -> G=2048) on a voronoi model
    built with num_patches=32: the port's Predictor embeds all 2048 centres
    (the JAX one raises here, ROADMAP.md queue 3)."""
    _, _, pm = tiny
    tp = Predictor(pm, device="cpu", point_buckets=(32768,))
    xyz, rgb = make_cloud(np.random.default_rng(13), n=30001)
    tp.set_pointcloud(xyz, rgb)
    assert tp._state["group"][0] == 2048 and tp._state["emb"].shape == (1, 2048, 256)
    masks, scores, logits = tp.predict_masks(xyz[:1], [1])
    assert masks.shape == (1, 3, 30001) and np.isfinite(logits).all()
    assert np.isfinite(scores).all()
