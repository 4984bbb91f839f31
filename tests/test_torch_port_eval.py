"""The evaluation slice of the port against the JAX package, on the CPU in
fp32: the interactive evaluator, one-shot inference, the KITTI-360 crop
converter, PLY I/O and approximate FPS.

Models: the tiny kNN model (ViT "tiny", G=32, K=8), the tiny voronoi model
(ViT "tiny", G=32) and the tiny hier model (ViT "tiny", G=(64, 16),
K=(8, 4), radii (0.05, 0.1)), each with JAX's initial weights plus
N(0, 0.05) noise on every bias and LayerNorm scale, carried across by
``state_dict_from_flax``. The scene is a seeded synthetic one of 1500
points, padded to a 2048 bucket, its instances in chunks of 2 (the last
one partial).

Tolerances: every per-instance IoU per click within 1e-5 of JAX's (a
click differs if a logit's sign flips, which moves an IoU by far more);
approximate-FPS indices equal; the crop converter's and the PLY writer's
files byte-equal.
"""

import numpy as np
import pytest
import torch

import jax

from point_sam_tpu import models as J
from point_sam_tpu import ops as jops
from point_sam_tpu.evalsuite import eval_interactive as JE
from point_sam_tpu.evalsuite import inference as JI
from point_sam_tpu.evalsuite import prepare_kitti as JK
from point_sam_tpu.models.tokenizer import compute_geometry as j_geometry
from point_sam_tpu.utils import ply as JPLY
from point_sam_tpu.utils.config import build_model as j_build_model
from point_sam_tpu.utils.config import load_config as j_load_config

from point_sam_tpu_torch import models as P
from point_sam_tpu_torch import ops
from point_sam_tpu_torch.datasets.synthetic import generate_scene
from point_sam_tpu_torch.evalsuite import eval_interactive as TE
from point_sam_tpu_torch.evalsuite import inference as TI
from point_sam_tpu_torch.evalsuite import prepare_kitti as TK
from point_sam_tpu_torch.ops.fps import candidate_subset
from point_sam_tpu_torch.serving import make_assets
from point_sam_tpu_torch.utils import ply as TPLY
from point_sam_tpu_torch.utils import build_model, load_config, state_dict_from_flax

RADIUS = (0.05, 0.1)
EVAL = dict(point_buckets=(2048,), masks_per_batch=2)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module: its ops are tiny, and when the
    test files run in parallel processes that already hold every core,
    threads that wait on each other multiply the time many fold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


MODELS = {
    "knn": (lambda: J.PointCloudSAM(J.PointSAMConfig(
                vit="tiny", tokenizer=J.TokenizerConfig(32, 8), prompt_iters=3)),
            lambda: P.PointCloudSAM(P.PointSAMConfig(
                vit="tiny", tokenizer=P.TokenizerConfig(32, 8)))),
    "voronoi": (lambda: J.PointCloudSAMNN(J.VoronoiConfig(vit="tiny", num_patches=32,
                                                          prompt_iters=3)),
                lambda: P.PointCloudSAMNN(P.VoronoiConfig(vit="tiny", num_patches=32))),
    "hier": (lambda: J.PointCloudSAMHier(J.HierConfig(
                 vit="tiny", tokenizer=J.HierTokenizerConfig((64, 16), (8, 4), radius=RADIUS),
                 prompt_iters=3)),
             lambda: P.PointCloudSAMHier(P.HierConfig(
                 vit="tiny", tokenizer=P.HierTokenizerConfig((64, 16), (8, 4), RADIUS)))),
}


def pair(kind):
    """(JAX model, its perturbed variables, port model with those weights)."""
    j_make, p_make = MODELS[kind]
    jm = j_make()
    v = perturb(jax.tree_util.tree_map(np.asarray, J.init_variables(jm, jax.random.PRNGKey(0))))
    pm = p_make()
    pm.load_state_dict(state_dict_from_flax(v), strict=True)
    return jm, v, pm


@pytest.fixture(scope="module")
def knn_pair():
    return pair("knn")


@pytest.fixture(scope="module")
def scene():
    """A normalized 1500-point scene and its kept instances."""
    ex = generate_scene(3, num_points=1500)
    xyz, rgb = TE.normalize_scene(ex["coords"], ex["features"])
    return xyz, rgb, ex["gt_masks"][TE.filter_masks(ex["gt_masks"])]


# -------------------------------------------------------- scene helpers
def test_filter_masks_matches_jax(rng):
    gt = np.zeros((5, 100), bool)
    gt[0, :10] = True    # too small (< 25)
    gt[1, :50] = True
    gt[2, :95] = True    # too big (>= 0.9 N)
    gt[3, :25] = True    # the smallest kept
    gt[4] = rng.random(100) < 0.5
    want = JE.filter_masks(gt)
    np.testing.assert_array_equal(TE.filter_masks(gt), want)
    assert want.tolist() == [1, 3, 4]


@pytest.mark.parametrize("colors", ["none", "0-255", "0-1"])
def test_normalize_scene_matches_jax(rng, colors):
    xyz = rng.standard_normal((300, 3)) * 4 + 2
    rgb = {"none": None, "0-255": rng.integers(0, 256, (300, 3)).astype(np.uint8),
           "0-1": rng.random((300, 3)).astype(np.float32)}[colors]
    want, got = JE.normalize_scene(xyz, rgb), TE.normalize_scene(xyz, rgb)
    for w, g in zip(want, got):
        assert g.dtype == w.dtype == np.float32
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("policy", ["bucket_pow2", "reference"])
@pytest.mark.parametrize("n", [100, 1500, 20000, 30001, 100000])
def test_tokenizer_for_matches_jax(knn_pair, policy, n):
    jm, v, pm = knn_pair
    kw = dict(gk_policy=policy, knn_method="exact", fps_candidates=512)
    want = JE.InteractiveEvaluator(jm, v, **kw)._tokenizer_for(n)
    got = TE.InteractiveEvaluator(pm, device="cpu", **kw)._tokenizer_for(n)
    for f in ("num_patches", "patch_size", "radius", "centralize_features", "knn_method",
              "fps_candidates"):
        assert getattr(got, f) == getattr(want, f), f


# ---------------------------------------------------- approximate FPS
@pytest.mark.parametrize("n,c", [(1500, 1024), (100000, 32768), (131072, 32768),
                                 (123457, 1000), (7, 3)])
def test_candidate_subset_matches_jax(n, c):
    """The strided subset bit for bit, where n / c is not exact in fp32 or
    in fp64 (100000 / 32768: 71 of its indices differ from a float64
    product's)."""
    import jax.numpy as jnp

    want = np.asarray(jnp.floor(jnp.arange(c, dtype=jnp.float32) * (n / c)).astype(jnp.int32))
    np.testing.assert_array_equal(candidate_subset(n, c), want)


def padded_cloud(rng, n=1500, pad=200):
    pts = rng.standard_normal((2, n, 3)).astype(np.float32)
    valid = np.ones((2, n), bool)
    valid[1, n - pad:] = False
    return pts, valid


@pytest.mark.parametrize("fn", ["fps", "fps_with_interp"])
def test_fps_candidates_matches_jax(rng, fn):
    """Approximate FPS with ``valid`` padding and N / c = 1500 / 1024:
    indices equal to JAX's (and centres, interp indices; weights within
    1e-5)."""
    pts, valid = padded_cloud(rng)
    args, kw = (pts, 48), dict(valid=valid, candidates=1024)
    if fn == "fps":
        want = np.asarray(jops.fps(*args, **kw))
        got = ops.fps(torch.from_numpy(pts), 48, valid=torch.from_numpy(valid),
                      candidates=1024)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
        assert set(want.ravel()) <= set(candidate_subset(1500, 1024))
        return
    want = jops.fps_with_interp(*args, with_centers=True, **kw)
    got = ops.fps_with_interp(torch.from_numpy(pts), 48, valid=torch.from_numpy(valid),
                              candidates=1024, with_centers=True)
    for i in range(3):
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(want[i]))
    # JAX's CPU kNN forms d^2 by expansion (|q|^2 - 2 q.k + |k|^2), which
    # cancels near a centre; the port's plain 3-NN subtracts first.
    np.testing.assert_allclose(got[3].numpy(), np.asarray(want[3]), rtol=0, atol=1e-5)


def test_fps_candidates_edges(rng):
    """N <= candidates is exact FPS; more samples than candidates raises."""
    pts, valid = padded_cloud(rng, n=300, pad=30)
    t, tv = torch.from_numpy(pts), torch.from_numpy(valid)
    np.testing.assert_array_equal(ops.fps(t, 16, valid=tv, candidates=300).numpy(),
                                  ops.fps(t, 16, valid=tv).numpy())
    with pytest.raises(ValueError, match="exceeds candidates"):
        ops.fps(t, 64, candidates=32)


@pytest.mark.parametrize("with_interp", [True, False])
def test_compute_geometry_fps_candidates_matches_jax(rng, with_interp):
    pts, valid = padded_cloud(rng)
    jcfg = J.TokenizerConfig(48, 8, knn_method="exact", fps_candidates=1024)
    pcfg = P.TokenizerConfig(48, 8, knn_method="exact", fps_candidates=1024)
    want = j_geometry(pts, jcfg, point_valid=valid, with_interp=with_interp)
    got = P.compute_geometry(torch.from_numpy(pts), pcfg, point_valid=torch.from_numpy(valid),
                             with_interp=with_interp)
    assert set(got) == set(want)
    for k in ("fps_idx", "knn_idx") + (("interp_index",) if with_interp else ()):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)


# ------------------------------------------------------------ evaluator
@pytest.mark.parametrize("kind,kw,instances,clicks", [
    ("knn", {}, None, 3),
    ("knn", {"fps_candidates": 1024}, 3, 2),
    ("voronoi", {}, 3, 2),
    ("hier", {}, 3, 2),
], ids=["knn-exact", "knn-fps-candidates", "voronoi", "hier"])
def test_evaluate_scene_matches_jax(scene, knn_pair, kind, kw, instances, clicks):
    """Per-instance IoU per click against JAX's ``InteractiveEvaluator``:
    the 1500-point scene padded to 2048, chunks of 2 with the last one
    partial (7 or 3 instances)."""
    xyz, rgb, gt = scene
    gt = gt[:instances]
    assert len(gt) % 2 == 1
    jm, v, pm = knn_pair if kind == "knn" else pair(kind)
    kw = dict(EVAL, num_clicks=clicks, **kw)
    want = JE.InteractiveEvaluator(jm, v, **kw).evaluate_scene(xyz, rgb, gt)
    got = TE.InteractiveEvaluator(pm, device="cpu", **kw).evaluate_scene(xyz, rgb, gt)
    assert got.shape == want.shape == (len(gt), clicks) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert (got > 0).any()  # some click segments something: the check has teeth


def test_entry_points_need_a_card(knn_pair, monkeypatch):
    """Without a device named and without a card, no CPU fallback."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TE.InteractiveEvaluator(knn_pair[2])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TE.main(["--config", "tiny", "--scene_dir", "."])


def test_evaluate_directory_matches_jax(knn_pair, tmp_path, capsys):
    """The report of both packages on a directory that ``make_assets``
    wrote (two 1500-point scenes with their mask sidecars)."""
    make_assets.main(["--out", str(tmp_path), "--num", "2", "--points", "1500"])
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "object0.masks.npy", "object0.ply", "object1.masks.npy", "object1.ply"]
    jm, v, pm = knn_pair
    kw = dict(num_clicks=2, point_buckets=(2048,), masks_per_batch=4,
              category_from_name=lambda n: n[:7])
    want = JE.evaluate_directory(jm, v, tmp_path, **kw)
    got = TE.evaluate_directory(pm, tmp_path, device="cpu", **kw)
    assert got["num_instances"] == want["num_instances"] > 0
    assert set(got["per_category"]) == set(want["per_category"]) == {"object0", "object1"}
    for k in (1, 2):
        assert abs(got["mean_iou_per_click"][k] - want["mean_iou_per_click"][k]) <= 1e-5
        for c in got["per_category"]:
            assert abs(got["per_category"][c][k] - want["per_category"][c][k]) <= 1e-5


@pytest.fixture(scope="module")
def tiny_ckpt(tmp_path_factory):
    """A state dict of configs/tiny.yaml's model with JAX's initial weights
    (``build_model``, PRNGKey(0): what JAX's CLIs run without a
    checkpoint), written with torch.save."""
    jm = j_build_model(j_load_config("tiny").model)
    v = jax.tree_util.tree_map(np.asarray, J.init_variables(jm, jax.random.PRNGKey(0)))
    path = tmp_path_factory.mktemp("ckpt") / "tiny.pt"
    torch.save(state_dict_from_flax(v), path)
    return path


def test_inference_main_npz_matches_jax(tiny_ckpt, tmp_path, capsys):
    """``inference.main`` on an .npz with ``--ckpt_path`` against JAX's
    ``inference.main`` (its own initial weights, the same ones), on a
    1200-point scene of 3 instances."""
    ex = generate_scene(11, num_points=1200)
    npz = tmp_path / "scene.npz"
    np.savez(npz, coords=ex["coords"], features=ex["features"], gt_masks=ex["gt_masks"])
    want = JI.main(["--config", "tiny", "--input", str(npz), "--num_clicks", "2"])
    got = TI.main(["--config", "tiny", "--ckpt_path", str(tiny_ckpt), "--device", "cpu",
                   "--input", str(npz), "--num_clicks", "2"])
    assert got.shape == want.shape == (len(TE.filter_masks(ex["gt_masks"])), 2)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert "mean IoU @ click 2" in capsys.readouterr().out


def test_eval_cli_ckpt(tiny_ckpt, tmp_path, capsys):
    """The evaluator's CLI with ``--ckpt_path`` (a strict load: a missing
    key raises) against ``evaluate_directory`` of configs/tiny.yaml's model
    given the same state dict, on one 1200-point scene of 3 instances (one
    click: the 8192 bucket's click sampler is slow on the CPU)."""
    ex = generate_scene(11, num_points=1200)
    TPLY.save_ply(tmp_path / "scene.ply", ex["coords"], ex["features"])
    np.save(tmp_path / "scene.masks.npy", ex["gt_masks"])
    args = ["--config", "tiny", "--scene_dir", str(tmp_path), "--num_clicks", "1",
            "--knn-method", "exact", "--masks-per-batch", "4", "--device", "cpu"]
    got = TE.main(args + ["--ckpt_path", str(tiny_ckpt)])
    model = build_model(load_config("tiny").model)
    model.load_state_dict(torch.load(tiny_ckpt, weights_only=True), strict=True)
    want = TE.evaluate_directory(model, tmp_path, device="cpu", num_clicks=1,
                                 knn_method="exact", masks_per_batch=4,
                                 category_from_name=lambda n: n.split("_")[0])
    assert got == want and got["num_instances"] == 3
    assert '"mean_iou_per_click"' in capsys.readouterr().out
    sd = torch.load(tiny_ckpt, weights_only=True)
    sd.pop(next(iter(sd)))
    torch.save(sd, tmp_path / "partial.pt")
    with pytest.raises(RuntimeError, match="Missing key"):
        TE.main(args + ["--ckpt_path", str(tmp_path / "partial.pt")])


# ------------------------------------------------- crop converter, PLY
def write_crop_ply(path, xyz, rgb, label):
    """Binary PLY with x/y/z float, R/G/B uchar, label int32 (the AGILE3D
    crop layout)."""
    n = len(xyz)
    header = (
        "ply\nformat binary_little_endian 1.0\n"
        f"element vertex {n}\n"
        "property float x\nproperty float y\nproperty float z\n"
        "property uchar R\nproperty uchar G\nproperty uchar B\n"
        "property int label\nend_header\n"
    )
    rec = np.empty(n, dtype=np.dtype(
        [("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
         ("R", "u1"), ("G", "u1"), ("B", "u1"), ("label", "<i4")]))
    rec["x"], rec["y"], rec["z"] = xyz.T
    rec["R"], rec["G"], rec["B"] = rgb.T
    rec["label"] = label
    with open(path, "wb") as f:
        f.write(header.encode())
        f.write(rec.tobytes())


@pytest.mark.parametrize("instances", [1, 3])
def test_prepare_kitti_matches_jax(rng, tmp_path, instances):
    xyz = rng.standard_normal((500, 3)).astype(np.float32)
    rgb = rng.integers(0, 256, (500, 3)).astype(np.uint8)
    label = np.zeros(500, np.int32)
    for i in range(instances):
        label[100 * i:100 * i + 60] = i + 1
    src = tmp_path / "car_0.ply"
    write_crop_ply(src, xyz, rgb, label)
    np.testing.assert_array_equal(TK.KITTI_ROTATION, JK.KITTI_ROTATION)
    want = JK.prepare_crop(src, tmp_path / "jax")
    got = TK.prepare_crop(src, tmp_path / "port")
    assert got.read_bytes() == want.read_bytes()
    masks = np.load(got.with_suffix(".masks.npy"))
    assert masks.shape == (instances, 500)
    np.testing.assert_array_equal(masks, np.load(want.with_suffix(".masks.npy")))
    TK.main(["--src_dir", str(tmp_path), "--out_dir", str(tmp_path / "cli")])
    assert (tmp_path / "cli" / "car_0.ply").read_bytes() == want.read_bytes()


@pytest.mark.parametrize("binary", [True, False], ids=["binary", "ascii"])
def test_ply_round_trip_matches_jax(rng, tmp_path, binary):
    """Each package reads what the other wrote; both write the same bytes;
    ``extra_props`` and the debug writers agree."""
    xyz = rng.standard_normal((200, 3)).astype(np.float32)
    rgb = rng.integers(0, 256, (200, 3)).astype(np.uint8)
    JPLY.save_ply(tmp_path / "j.ply", xyz, rgb, binary=binary)
    TPLY.save_ply(tmp_path / "t.ply", xyz, rgb, binary=binary)
    assert (tmp_path / "t.ply").read_bytes() == (tmp_path / "j.ply").read_bytes()
    for name in ("j.ply", "t.ply"):
        got = TPLY.load_ply(tmp_path / name, extra_props=("red", "label"))
        want = JPLY.load_ply(tmp_path / name, extra_props=("red", "label"))
        np.testing.assert_array_equal(got[0], xyz)
        np.testing.assert_array_equal(got[1], rgb)
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_array_equal(got[2]["red"], want[2]["red"])
        assert got[2]["label"] is None and want[2]["label"] is None
    mask = rng.random(200) < 0.3
    TPLY.visualize_mask(tmp_path / "tm.ply", xyz, mask, rgb)
    JPLY.visualize_mask(tmp_path / "jm.ply", xyz, mask, rgb)
    assert (tmp_path / "tm.ply").read_bytes() == (tmp_path / "jm.ply").read_bytes()
    clicks, labels = xyz[:3], np.array([1, 0, 1])
    TPLY.visualize_prompts(tmp_path / "tp.ply", xyz, clicks, labels, rgb, radius=0.5)
    JPLY.visualize_prompts(tmp_path / "jp.ply", xyz, clicks, labels, rgb, radius=0.5)
    assert (tmp_path / "tp.ply").read_bytes() == (tmp_path / "jp.ply").read_bytes()
