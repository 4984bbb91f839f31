"""Voronoi training in the port against the JAX package, on the CPU in fp32.

- one whole train step of a tiny ``PointCloudSAMNN`` with the same weights
  and batch: JAX's loss and gradients from ``make_train_step`` (read back
  through an optax transformation that keeps the gradients as its state),
  the port's from ``train_step``. Two ViTs: the "tiny" preset (4 heads of
  32: the head-split ``mha``, K5's plain version and its plain backward)
  and one of 2 heads of 64 (the packed path: K3's and K6's plain
  versions); two click settings, as tests/test_torch_port_train.py's:
  prompt_iters=2 with refinement iterations, prompt_iters=3 without;
- the scatter max's gradient at ties: ``PatchEmbedNN`` and
  ``MaskEncoderNN`` on a cloud whose every point has a twin (the same
  coordinates, features and mask logit), so every cell's max in every
  channel is a tie of two points; the grads of the parameters and of the
  per-point inputs (the features, and the mask encoder's point offsets)
  against ``jax.vjp`` of the JAX modules. JAX splits a tied maximum's
  gradient evenly among the ties, and so does the port;
- ``vit_remat``: the train step with it on and off, bit for bit, and a
  Predictor's outputs unchanged by it.

Tolerances: the loss within 1e-5 relative, the metrics 1e-4; every
gradient within 1e-4 * max|JAX grad| + 1e-7; the tie pins 1e-5 of the
largest JAX entry (a single module in fp32).
"""

import importlib
from functools import partial

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from point_sam_tpu import models as J
from point_sam_tpu.models.prompt_encoder import mask_nbr_dist as j_mask_nbr_dist
from point_sam_tpu.models.vit import ViTConfig as JViTConfig
from point_sam_tpu.parallel import TrainState, make_train_step

from point_sam_tpu_torch import models as P
from point_sam_tpu_torch.parallel import make_optimizer, train_step
from point_sam_tpu_torch.serving import Predictor
from point_sam_tpu_torch.utils import state_dict_from_flax

G = 16
# The ViTs of the train step: "tiny" (dh 32, head-split) and dh 64 (packed).
VITS = {"tiny": ("tiny", "tiny"),
        "dh64": (JViTConfig(128, 2, 2, 256), P.ViTConfig(128, 2, 2, 256))}


def t(a):
    return torch.from_numpy(np.array(a))


def assert_rel(got, want, rel, what=""):
    """max |got - want| <= rel * max |want|."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    err = np.abs(got - want).max()
    assert err <= rel * np.abs(want).max(), (what, err, np.abs(want).max())


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


def capture_grads():
    """An optax transformation whose state becomes the gradients (and whose
    updates are zero), to read the gradients of make_train_step back."""
    def init(params):
        return jax.tree_util.tree_map(jnp.zeros_like, params)

    def update(g, state, params=None):
        return jax.tree_util.tree_map(jnp.zeros_like, g), g

    return optax.GradientTransformation(init, update)


def make_batch(rng, B=2, N=192, M=2):
    coords = rng.standard_normal((B, N, 3)).astype(np.float32)
    coords /= np.abs(coords).max() + 1e-3
    feats = rng.random((B, N, 3)).astype(np.float32)
    gt = np.zeros((B, M, N), bool)
    for b in range(B):
        for m in range(M):
            d = ((coords[b] - coords[b, rng.integers(N)]) ** 2).sum(-1)
            gt[b, m] = d < np.quantile(d, 0.3)
    return dict(coords=coords, features=feats, gt_masks=gt)


def models(vit="tiny", iters=3, refine=False, **port_cfg):
    """(JAX model, perturbed variables, port model with those weights)."""
    jvit, pvit = VITS[vit]
    jm = J.PointCloudSAMNN(J.VoronoiConfig(vit=jvit, num_patches=G, prompt_iters=iters,
                                           enable_mask_refinement_iterations=refine))
    v = perturb(jax.tree_util.tree_map(np.asarray, J.init_variables(jm, jax.random.PRNGKey(0))))
    pm = P.PointCloudSAMNN(P.VoronoiConfig(vit=pvit, num_patches=G, prompt_iters=iters,
                                           enable_mask_refinement_iterations=refine, **port_cfg),
                           generator=torch.Generator().manual_seed(0))
    pm.load_state_dict(state_dict_from_flax(v), strict=True)
    return jm, v, pm


def port_step(pm, batch):
    """The port's train step at rate 0: (metrics, {name: grad})."""
    tb = {k: t(a) for k, a in batch.items()}
    opt = make_optimizer(pm.parameters(), lambda step: 0.0, weight_decay=0.0,
                         max_grad_value=float("inf"))
    metrics = train_step(pm, opt, tb, torch.Generator().manual_seed(0))
    return metrics, {n: p.grad for n, p in pm.named_parameters()}


# ------------------------------------------------------------ one train step
@pytest.mark.parametrize("iters,refine", [(2, True), (3, False)])
@pytest.mark.parametrize("vit", list(VITS))
def test_voronoi_train_step_matches_jax(vit, iters, refine):
    jm, v, pm = models(vit, iters, refine)
    batch = make_batch(np.random.default_rng(5))
    jb = {k: jnp.asarray(a) for k, a in batch.items()}
    rng = jax.random.PRNGKey(3)

    tx = capture_grads()
    params = v["params"]
    buffers = {k: x for k, x in v.items() if k != "params"}
    step_fn = make_train_step(jm, tx, donate=False)
    new_state, metrics = step_fn(TrainState.create(params, buffers, tx), jb, rng)
    jgrads = state_dict_from_flax({"params": jax.tree_util.tree_map(np.asarray,
                                                                    new_state.opt_state)})
    jouts = jm.apply(v, jb["coords"], jb["features"], jb["gt_masks"], rngs={"sampler": rng})

    tb = {k: t(a) for k, a in batch.items()}
    with torch.no_grad():
        pouts = pm(tb["coords"], tb["features"], tb["gt_masks"],
                   generator=torch.Generator().manual_seed(0))
    assert len(pouts) == len(jouts) == iters
    for po, jo in zip(pouts, jouts):  # the same clicks in every iteration
        for k in ("prompt_coords", "prompt_labels", "prompt_valid"):
            np.testing.assert_array_equal(po[k].numpy(), np.asarray(jo[k]), err_msg=k)

    got, grads = port_step(pm, batch)
    np.testing.assert_allclose(got["loss"].item(), float(metrics["loss"]), rtol=1e-5)
    for k in ("first/iou", "last/iou", "first/acc", "last/loss_mask"):
        np.testing.assert_allclose(got[k].item(), float(metrics[k]), rtol=1e-4, atol=1e-6)
    assert set(grads) <= set(jgrads)
    for name, g in grads.items():
        want = jgrads[name].numpy()
        g = np.zeros_like(want) if g is None else g.numpy()
        err = np.abs(g - want).max()
        assert err <= 1e-4 * np.abs(want).max() + 1e-7, (name, err, np.abs(want).max())


# ------------------------------------------------------ scatter max at ties
def twin_cloud(rng, n=120):
    """[1, 2n] points whose second half repeats the first (coordinates and
    features), with the voronoi geometry of both packages."""
    coords = rng.uniform(-1, 1, (1, n, 3)).astype(np.float32)
    feats = rng.random((1, n, 3)).astype(np.float32)
    coords, feats = (np.concatenate([a, a], axis=1) for a in (coords, feats))
    jm = J.PointCloudSAMNN(J.VoronoiConfig(vit="tiny", num_patches=G))
    jg = jm.make_geometry(jnp.asarray(coords))
    pg = P.compute_geometry_voronoi(t(coords), G)
    np.testing.assert_array_equal(pg["nn_idx"].numpy(), np.asarray(jg["nn_idx"]))
    return coords, feats, jg, pg


def assert_grads_match(pm, prefix, jgrads, got_inputs, want_inputs):
    """The port's grads of ``prefix``'s parameters and of the inputs
    against JAX's (1e-5 of the largest JAX entry)."""
    want = state_dict_from_flax({"params": jax.tree_util.tree_map(np.asarray, jgrads)})
    names = [n for n, _ in pm.named_parameters() if n.startswith(prefix)]
    assert names
    params = dict(pm.named_parameters())
    for name in names:
        g = params[name].grad
        g = torch.zeros_like(params[name]) if g is None else g  # no_mask_embed
        assert_rel(g.numpy(), want[name].numpy(), 1e-5, name)
    for i, (g, w) in enumerate(zip(got_inputs, want_inputs)):
        assert_rel(g.numpy(), np.asarray(w), 1e-5, f"input {i}")


def test_patch_embed_nn_grads_at_ties_match_jax_vjp():
    jm, v, pm = models()
    coords, feats, jg, pg = twin_cloud(np.random.default_rng(20))
    rest = {k: x for k, x in v.items() if k != "params"}

    def f(params, features):
        return jm.apply({"params": params, **rest}, jnp.asarray(coords), features, jg,
                        method=lambda m, c, x, g: m.patch_embed(c, x, g))

    out, vjp = jax.vjp(f, v["params"], jnp.asarray(feats))
    cot = np.random.default_rng(21).standard_normal(out.shape).astype(np.float32)
    dparams, dfeats = vjp(jnp.asarray(cot))

    tf = t(feats).requires_grad_()
    got = pm.pc_encoder.patch_embed(t(coords), tf, pg)
    assert_rel(got.detach().numpy(), np.asarray(out), 1e-5, "output")
    got.backward(t(cot))
    # The twins' feature grads: each takes half of the split.
    np.testing.assert_allclose(tf.grad[:, :120].numpy(), tf.grad[:, 120:].numpy(), rtol=1e-6,
                               atol=1e-9)
    assert_grads_match(pm, "pc_encoder.patch_embed.", dparams, [tf.grad], [dfeats])


def test_mask_encoder_nn_grads_at_ties_match_jax_vjp():
    """M=2 masks a cloud; the offsets (nbr, dist) are inputs, as the
    forward's cache passes them."""
    jm, v, pm = models()
    rng = np.random.default_rng(22)
    coords, _, jg, pg = twin_cloud(rng)
    logits = rng.standard_normal((2, 120)).astype(np.float32)
    masks = np.concatenate([logits, logits], axis=1)
    nbr, dist = (np.asarray(a) for a in j_mask_nbr_dist(jnp.asarray(coords), jg["centers"],
                                                          jg["nn_idx"]))
    rest = {k: x for k, x in v.items() if k != "params"}

    def f(params, nbr, dist):
        return jm.apply({"params": params, **rest}, jnp.asarray(masks), jnp.asarray(coords),
                        jg["centers"], jg["nn_idx"], None, (nbr, dist),
                        method=lambda m, *a: m.mask_encoder(*a))

    out, vjp = jax.vjp(f, v["params"], jnp.asarray(nbr), jnp.asarray(dist))
    cot = rng.standard_normal(out.shape).astype(np.float32)
    dparams, dnbr, ddist = vjp(jnp.asarray(cot))

    tn, td = t(nbr).requires_grad_(), t(dist).requires_grad_()
    got = pm.mask_encoder(t(masks), t(coords), pg["centers"], pg["nn_idx"], nbr_dist=(tn, td))
    assert_rel(got.detach().numpy(), np.asarray(out), 1e-5, "output")
    got.backward(t(cot))
    np.testing.assert_allclose(td.grad[:, :120].numpy(), td.grad[:, 120:].numpy(), rtol=1e-6,
                               atol=1e-9)
    assert_grads_match(pm, "mask_encoder.", dparams, [tn.grad, td.grad], [dnbr, ddist])


# ------------------------------------------------------------ vit_remat
@pytest.mark.parametrize("vit", list(VITS))
def test_vit_remat_changes_no_bit(vit):
    """The train step with each ViT block recomputed in the backward and
    without: the same loss and grads, bit for bit. Then the Predictor: the
    same masks, scores and logits either way."""
    batch = make_batch(np.random.default_rng(6))
    runs = {}
    for remat in (True, False):
        _, _, pm = models(vit, 3, False, vit_remat=remat)
        assert pm.pc_encoder.transformer.remat is remat
        runs[remat] = pm, *port_step(pm, batch)
    (_, m_on, g_on), (pm_off, m_off, g_off) = runs[True], runs[False]
    assert torch.equal(m_on["loss"], m_off["loss"])
    assert g_on.keys() == g_off.keys()
    for name in g_on:
        assert torch.equal(g_on[name], g_off[name]), name

    pm_on = runs[True][0]
    xyz = np.random.default_rng(7).uniform(-1, 1, (600, 3)).astype(np.float32)
    rgb = np.random.default_rng(8).random((600, 3)).astype(np.float32)
    outs = []
    for pm in (pm_on, pm_off):
        pred = Predictor(pm, device="cpu", point_buckets=(1024,))
        pred.set_pointcloud(xyz, rgb)
        outs.append(pred.predict_masks(xyz[3:4], [1]))
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)


def test_vit_remat_checkpoints_each_block_under_grad(monkeypatch):
    """Under a gradient every block goes through ``checkpoint`` once; under
    no_grad (the Predictor's encode) none does."""
    V = importlib.import_module("point_sam_tpu_torch.models.vit")
    calls = []
    monkeypatch.setattr(V, "checkpoint", partial(lambda f, *a, **kw: (calls.append(1),
                                                                      f(*a, **kw))[1],
                                                 V.checkpoint))
    vit = V.ViT(P.ViTConfig(64, 3, 2, 128), remat=True,
                generator=torch.Generator().manual_seed(0))
    x = torch.randn(1, 8, 64, requires_grad=True)
    with torch.no_grad():
        vit(x)
    assert calls == []
    vit(x).sum().backward()
    assert len(calls) == 3 and x.grad is not None
