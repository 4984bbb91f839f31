"""The interactive slice end to end: the JAX ``Predictor`` against the
port's, on the CPU in fp32, with the same weights (through
``state_dict_from_flax``), the same cloud and the same clicks.

Shapes follow tests/test_predictor.py: the tiny config (ViT "tiny",
G=32, K=16), N=1200 points padded to one 2048 bucket. Tolerances: logits
within 1e-3 absolute (the JAX side is XLA-compiled, whose fused fp32
arithmetic moves encoder outputs by ~5e-5 relative), masks equal wherever
|logit| >= 1e-3, IoU scores within 1e-4.
"""

import numpy as np
import pytest
import torch

import jax

from point_sam_tpu.models import PointCloudSAM, PointSAMConfig, TokenizerConfig, init_variables
from point_sam_tpu.serving.predictor import Predictor as JPredictor

from point_sam_tpu_torch import models as P
from point_sam_tpu_torch.serving import Predictor
from point_sam_tpu_torch.utils import state_dict_from_flax


def make_cloud(rng, n=1200):
    xyz = rng.standard_normal((n, 3)).astype(np.float32)
    xyz /= np.abs(xyz).max() + 1e-3
    rgb = rng.random((n, 3)).astype(np.float32)
    return xyz, rgb


@pytest.fixture(scope="module")
def predictors():
    jm = PointCloudSAM(PointSAMConfig(vit="tiny", tokenizer=TokenizerConfig(32, 16),
                                      prompt_iters=3))
    v = jax.tree_util.tree_map(np.asarray, init_variables(jm, jax.random.PRNGKey(0)))
    pm = P.PointCloudSAM(P.PointSAMConfig(vit="tiny", tokenizer=P.TokenizerConfig(32, 16)),
                         generator=torch.Generator().manual_seed(0))
    pm.load_state_dict(state_dict_from_flax(v), strict=True)
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
    assert tp._state["group"] == (32, 16) and tp._state["n_pad"] == 2048
    for k in ("fps_idx", "knn_idx", "interp_index"):
        np.testing.assert_array_equal(tp._state["geom"][k].numpy(),
                                      np.asarray(jp._state["geom"][k]))

    # Click 1: no mask prompt, 3 candidate masks.
    want = jp.predict_masks(xyz[10:11], [1])
    got = tp.predict_masks(xyz[10:11], [1])
    assert got[0].shape == (1, 3, 1200)
    assert_same_prediction(want, got)
    best = int(np.argmax(want[1][0]))
    prev = want[2][0, best]
    # Clicks 2 and 3: the previous logits as mask prompt, 2 then 3 points
    # (padded to 2 and 4 prompt slots).
    for pts, labels in ((xyz[10:12], [1, 0]), (xyz[[10, 11, 500]], [1, 0, 1])):
        want = jp.predict_masks(pts, labels, prev, False)
        got = tp.predict_masks(pts, labels, prev, False)
        assert got[0].shape == (1, 1, 1200)
        assert_same_prediction(want, got)
        prev = want[2][0, 0]


def test_click_and_group_override(predictors):
    jp, tp = predictors
    xyz, rgb = make_cloud(np.random.default_rng(1))
    jp.set_pointcloud(xyz, rgb, group_number=16, group_size=8)
    tp.set_pointcloud(xyz, rgb, group_number=16, group_size=8)
    assert tp._state["group"] == (16, 8)
    wm, wl = jp.click(xyz[:1], [1])
    gm, gl = tp.click(xyz[:1], [1])
    assert gm.shape == (1200,) and gm.dtype == bool
    np.testing.assert_allclose(gl, wl, atol=1e-3)
    gm2, gl2 = tp.click(xyz[:2], [1, 0], prompt_mask=gl)
    assert np.isfinite(gl2).all()


def test_predictor_rules():
    from point_sam_tpu_torch.serving.predictor import _next_bucket, _next_pow2
    from point_sam_tpu_torch.serving import DEFAULT_POINT_BUCKETS

    assert DEFAULT_POINT_BUCKETS == (2048, 8192, 32768, 131072, 524288)
    assert _next_bucket(100_000, DEFAULT_POINT_BUCKETS) == 131072
    assert _next_bucket(600_000, DEFAULT_POINT_BUCKETS) == 1048576
    assert [_next_pow2(p) for p in (1, 2, 3, 5)] == [1, 2, 4, 8]
    pm = P.PointCloudSAM(P.PointSAMConfig(vit="tiny", tokenizer=P.TokenizerConfig(32, 16)),
                         generator=torch.Generator().manual_seed(0))
    tp = Predictor(pm, device="cpu")
    with pytest.raises(RuntimeError):
        tp.predict_masks(np.zeros((1, 3)), [1])


def test_predictor_runs_on_cuda_unless_asked():
    """Without a device the Predictor takes the card, and raises without
    one; it never falls back to the CPU on its own."""
    pm = P.PointCloudSAM(P.PointSAMConfig(vit="tiny", tokenizer=P.TokenizerConfig(32, 16)),
                         generator=torch.Generator().manual_seed(0))
    if torch.cuda.is_available():
        assert Predictor(pm).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match='device="cpu"'):
            Predictor(pm)
    tp = Predictor(pm, device="cpu")
    assert tp.device.type == "cpu" and next(tp.model.parameters()).device.type == "cpu"
