"""Hier training in the port against the JAX package, on the CPU in fp32.

The model is tests/test_torch_port_hier.py's tiny hier model (ViT "tiny",
G=(64, 16), K=(8, 4), hier.yaml's radii (0.05, 0.1)) with perturbed JAX
weights through ``state_dict_from_flax``. K=(8, 4) stays below the valid
points and G1, so no kNN row repeats and no max-pool holds an exact tie
(where JAX's backward splits a tied gradient and the port's routes it to
the first argmax, a divergence by design).

- one whole train step against JAX's ``make_train_step`` at
  (prompt_iters, refinement) = (2, True) and (3, False). The two packages
  cannot draw the same noise, so both click loops get the fixed sampler in
  the random one's place (pytest's ``monkeypatch`` on the name each
  ``models/pc_sam.py`` calls); the clicks are then equal. Level 2's input
  is [offsets | level-1 embeddings] in both the patch embed and the mask
  encoder, so level 1's grads arrive through level 2's dx;
- ``PatchEmbedHier`` and ``MaskEncoderHier`` alone, the same inputs on
  both sides, against ``jax.vjp``: every parameter's grad of both levels,
  with a cotangent on level 2's output only (level 1's grads come through
  level 2's dx alone), and the patch embed's feature grads;
- the real random sampler: every click lies in its mask's error region
  (the GT where that is empty), never on a padded point; a seed repeats
  its clicks and another seed gives other clicks;
- ``vit_remat`` on and off: the same loss and grads, bit for bit;
- ``build_model`` of configs/model/hier.yaml: JAX's training fields;
- JAX's hier validation without a "sampler" rng raises, the port's
  ``trainer.validate`` answers (and repeats);
- ``trainer.main`` on configs/large.yaml with a tiny hier model: an epoch,
  then a resume with validation.

Tolerances: the loss within 1e-5 relative, the metrics 1e-4; every
gradient of the step within 1e-4 * max|JAX grad| + 1e-7, but the mask
encoder's PointNets' within 5e-3 * max|JAX grad| + 1e-7, as in
tests/test_torch_port_train.py: their input is the previous iteration's
mask logits, which differ between the packages in the last bits, and a
max-pool near-tie within that distance moves a column's gradient to
another row (the port's own grads of these move by up to 4.2x the 1e-4
bound between 8 CPU threads and 1, from the summation order alone). The
modules alone, on the same inputs, within 1e-5 of the largest JAX entry.
"""

import dataclasses
import importlib
import json

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp
from flax.errors import InvalidRngError

from point_sam_tpu import models as J
from point_sam_tpu.models.tokenizer import HierTokenizerConfig as JHierTok
from point_sam_tpu.ops import sampler as JS
from point_sam_tpu.parallel import TrainState, make_train_step
from point_sam_tpu.utils.config import build_model as j_build_model

from point_sam_tpu_torch import models as P
from point_sam_tpu_torch.ops.sampler import sample_prompts
from point_sam_tpu_torch.parallel import make_optimizer, train_step
from point_sam_tpu_torch.train import trainer
from point_sam_tpu_torch.utils import state_dict_from_flax
from point_sam_tpu_torch.utils.config import build_model, load_config

G1, G2, K1, K2 = 64, 16, 8, 4
RADIUS = (0.05, 0.1)
# Level 1 of both PointNets: their grads arrive only through level 2's dx
# (the mask encoder) or through it and the decoder's skip (the patch embed).
LEVEL1 = ("pc_encoder.patch_embed.patch_encoder1.", "mask_encoder.patch_encoder1.")


def t(a):
    return torch.from_numpy(np.array(a))


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


def jax_model(iters=3, refine=False):
    return J.PointCloudSAMHier(J.HierConfig(
        vit="tiny", tokenizer=JHierTok((G1, G2), (K1, K2), radius=RADIUS), prompt_iters=iters,
        enable_mask_refinement_iterations=refine))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module: its ops are tiny, and when the
    test files run in parallel processes that already hold every core,
    threads that wait on each other multiply the time many fold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def variables():
    """Perturbed JAX variables of the tiny hier model (the click settings
    change no parameter)."""
    v = J.init_variables(jax_model(), jax.random.PRNGKey(0))
    return perturb(jax.tree_util.tree_map(np.asarray, v))


def port_model(variables, iters=3, refine=False, **cfg):
    pm = P.PointCloudSAMHier(P.HierConfig(
        vit="tiny", tokenizer=P.HierTokenizerConfig((G1, G2), (K1, K2), RADIUS),
        prompt_iters=iters, enable_mask_refinement_iterations=refine, **cfg),
        generator=torch.Generator().manual_seed(0))
    pm.load_state_dict(state_dict_from_flax(variables), strict=True)
    return pm


def port_step(pm, batch):
    """The port's train step at rate 0: (metrics, {name: grad})."""
    tb = {k: t(a) for k, a in batch.items()}
    opt = make_optimizer(pm.parameters(), lambda step: 0.0, weight_decay=0.0,
                         max_grad_value=float("inf"))
    metrics = train_step(pm, opt, tb, torch.Generator().manual_seed(0))
    return metrics, {n: p.grad for n, p in pm.named_parameters()}


@pytest.fixture
def fixed_sampler(monkeypatch):
    """Both click loops' random sampler replaced by the fixed one."""
    jpc = importlib.import_module("point_sam_tpu.models.pc_sam")
    ppc = importlib.import_module("point_sam_tpu_torch.models.pc_sam")
    monkeypatch.setattr(jpc, "sample_prompts_random",
                        lambda rng, coords, gt, pred, point_valid=None: JS.sample_prompts(
                            coords, gt, pred, point_valid=point_valid))
    monkeypatch.setattr(ppc, "sample_prompts_random",
                        lambda gen, coords, gt, pred=None, *, point_valid=None: sample_prompts(
                            coords, gt, pred, point_valid=point_valid))


# ------------------------------------------------------------ one train step
@pytest.mark.parametrize("iters,refine", [(2, True), (3, False)])
def test_hier_train_step_matches_jax(variables, fixed_sampler, iters, refine):
    jm, v = jax_model(iters, refine), variables
    pm = port_model(v, iters, refine)
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
    # Jitted: the same clicks as the eager apply, in a sixth of its time.
    jouts = jax.jit(lambda *a: jm.apply(v, *a, rngs={"sampler": rng}))(
        jb["coords"], jb["features"], jb["gt_masks"])

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
    level1 = 0
    for name, g in grads.items():
        want = jgrads[name].numpy()
        g = np.zeros_like(want) if g is None else g.numpy()
        err = np.abs(g - want).max()
        rel = 5e-3 if name.startswith("mask_encoder.patch_encoder") else 1e-4
        assert err <= rel * np.abs(want).max() + 1e-7, (name, err, np.abs(want).max())
        if name.startswith(LEVEL1):
            assert np.abs(want).max() > 0, name
            level1 += 1
    assert level1 == 2 * 12  # both level-1 PointNets, every parameter


# ------------------------------------------- the two-level PointNets alone
def hier_geometry(rng, n=300):
    """A cloud, its features and both packages' hier geometry."""
    coords = rng.uniform(-1, 1, (1, n, 3)).astype(np.float32)
    feats = rng.random((1, n, 3)).astype(np.float32)
    jg = J.PointCloudSAMHier(J.HierConfig(
        vit="tiny", tokenizer=JHierTok((G1, G2), (K1, K2), radius=RADIUS))).make_geometry(
        jnp.asarray(coords))
    pg = P.compute_geometry_hier(t(coords), P.HierTokenizerConfig((G1, G2), (K1, K2), RADIUS))
    for k in ("knn_idx1", "knn_idx2"):
        np.testing.assert_array_equal(pg[k].numpy(), np.asarray(jg[k]))
    return coords, feats, jg, pg


@pytest.mark.parametrize("module", ["patch_embed", "mask_encoder"])
def test_two_level_pointnet_grads_match_jax_vjp(variables, module):
    """``PatchEmbedHier`` (cloud features in) or ``MaskEncoderHier`` (M=2
    masks' logits in) on the same inputs in both packages; the cotangent
    reaches level 2's output only, so level 1's parameters get their grads
    through level 2's dx (K7's dx on the card; its plain version here)."""
    v, jm = variables, jax_model()
    pm = port_model(v)
    rng = np.random.default_rng(30)
    coords, feats, jg, pg = hier_geometry(rng)
    rest = {k: x for k, x in v.items() if k != "params"}
    if module == "patch_embed":
        def f(params, x):
            return jm.apply({"params": params, **rest}, jnp.asarray(coords), x, jg,
                            method=lambda m, c, f_, g: m.patch_embed(c, f_, g))[1]
        x_in = feats
    else:
        geo = lambda g: (g["centers1"], g["knn_idx1"], g["centers2"], g["knn_idx2"])  # noqa: E731

        def f(params, x):
            return jm.apply({"params": params, **rest}, x, jnp.asarray(coords), *geo(jg),
                            method=lambda m, *a: m.mask_encoder(*a))[1]
        x_in = rng.standard_normal((2, coords.shape[1])).astype(np.float32)
    out, vjp = jax.vjp(jax.jit(f), v["params"], jnp.asarray(x_in))
    cot = rng.standard_normal(out.shape).astype(np.float32)
    dparams, dx = vjp(jnp.asarray(cot))
    want = state_dict_from_flax({"params": jax.tree_util.tree_map(np.asarray, dparams)})

    tx = t(x_in).requires_grad_(module == "patch_embed")
    if module == "patch_embed":
        got = pm.pc_encoder.patch_embed(t(coords), tx, pg)[1]
    else:
        got = pm.mask_encoder(tx, t(coords), *geo(pg))[1]
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out), atol=1e-5)
    got.backward(t(cot))
    names = [n for n, _ in pm.named_parameters()
             if n.startswith(f"{'pc_encoder.' if module == 'patch_embed' else ''}{module}.")
             and "patch_encoder" in n]
    assert len(names) == 24
    params = dict(pm.named_parameters())
    for name in names:
        g, w = params[name].grad.numpy(), want[name].numpy()
        assert np.abs(w).max() > 0, name
        err = np.abs(g - w).max()
        assert err <= 1e-5 * np.abs(w).max(), (name, err, np.abs(w).max())
    if module == "patch_embed":
        err = np.abs(tx.grad.numpy() - np.asarray(dx)).max()
        assert err <= 1e-5 * np.abs(np.asarray(dx)).max(), err


# ------------------------------------------------------ the random sampler
def padded_batch(rng, n_real=160, n_pad=32):
    """A batch whose last ``n_pad`` points of each cloud are padding that
    lies inside every GT mask: a sampler that ignored ``point_valid``
    would click there."""
    b = make_batch(rng, N=n_real + n_pad)
    valid = np.ones((2, n_real + n_pad), bool)
    valid[:, n_real:] = False
    b["gt_masks"][:, :, n_real:] = True
    return {k: t(a) for k, a in b.items()}, t(valid)


def eval_clicks(pm, tb, valid, seed):
    with torch.no_grad():
        return pm(tb["coords"], tb["features"], tb["gt_masks"], is_eval=True,
                  point_valid=valid, generator=torch.Generator().manual_seed(seed))


def test_random_clicks_lie_in_the_error_region(variables):
    """Evaluation clicks (every iteration clicks): iteration 0 in the GT,
    each later one in the error region of the previous iteration's mask
    prompt (the GT where that region is empty), on a valid point, with the
    GT's label there."""
    pm = port_model(variables, iters=4).eval()
    tb, valid = padded_batch(np.random.default_rng(11))
    outs = eval_clicks(pm, tb, valid, 0)
    B, M, N = tb["gt_masks"].shape
    gt = tb["gt_masks"].reshape(B * M, N)
    pv = valid.repeat_interleave(M, 0)
    coords = tb["coords"].repeat_interleave(M, 0)
    prev = None
    for i, out in enumerate(outs):
        assert bool(out["prompt_valid"][:, i].all())
        click = out["prompt_coords"][:, i]  # [BM, 3]
        hit = (coords == click[:, None]).all(-1)  # the clicked point, once a row
        assert bool((hit.sum(-1) == 1).all())
        idx = hit.float().argmax(-1)
        region = gt if prev is None else gt != (prev > 0)
        region = region & pv
        region = torch.where(region.any(-1, keepdim=True), region, gt & pv)
        rows = torch.arange(B * M)
        assert bool(region[rows, idx].all()), i
        assert bool(pv[rows, idx].all()), i
        assert torch.equal(out["prompt_labels"][:, i], gt[rows, idx])
        prev = out["prompt_masks"]


def test_random_clicks_repeat_by_seed(variables):
    pm = port_model(variables, iters=3).eval()
    tb, valid = padded_batch(np.random.default_rng(12))
    first, again, other = (eval_clicks(pm, tb, valid, s) for s in (4, 4, 5))
    for a, b in zip(first, again):
        assert torch.equal(a["prompt_coords"], b["prompt_coords"])
        assert torch.equal(a["masks"], b["masks"])
    assert not all(torch.equal(a["prompt_coords"], b["prompt_coords"])
                   for a, b in zip(first, other))


# ------------------------------------------------------------ vit_remat
def test_vit_remat_changes_no_bit(variables):
    """The train step (the real random sampler, one seed) with each ViT
    block recomputed in the backward and without: the same loss and grads,
    bit for bit."""
    batch = make_batch(np.random.default_rng(6))
    runs = {}
    for remat in (True, False):
        pm = port_model(variables, 3, False, vit_remat=remat)
        assert pm.pc_encoder.transformer.remat is remat
        runs[remat] = port_step(pm, batch)
    (m_on, g_on), (m_off, g_off) = runs[True], runs[False]
    assert torch.equal(m_on["loss"], m_off["loss"])
    assert g_on.keys() == g_off.keys()
    for name in g_on:
        assert torch.equal(g_on[name], g_off[name]), name


# ------------------------------------------------------------ config
def test_build_model_hier_yaml_keeps_the_training_fields():
    """configs/model/hier.yaml: 8 click iterations, refinement and remat
    on, every HierConfig field equal to JAX's (built on the meta device)."""
    cfg = load_config("model/hier")
    pm = build_model(cfg, device="meta")
    jm = j_build_model(cfg)
    assert pm.cfg.prompt_iters == 8 and pm.cfg.enable_mask_refinement_iterations
    assert pm.cfg.vit_remat and pm.pc_encoder.transformer.remat
    names = [f.name for f in dataclasses.fields(pm.cfg)]
    assert names == [f.name for f in dataclasses.fields(jm.cfg)]
    for name in names:
        got, want = getattr(pm.cfg, name), getattr(jm.cfg, name)
        if name == "tokenizer":
            got, want = dataclasses.astuple(got), dataclasses.astuple(want)
        assert got == want, name


# ------------------------------------------------- validation, the trainer
def test_jax_hier_validation_needs_a_sampler_rng(variables):
    """The JAX reference's validation calls the model with is_eval=True and
    no "sampler" rng (train/trainer.py::validate), which the hier loop needs
    on every iteration: it raises. The port's validate seeds a generator of
    its own and answers, the same both times."""
    jm = jax_model(3)
    b = make_batch(np.random.default_rng(7))
    with pytest.raises(InvalidRngError, match="sampler"):  # raised while tracing
        jax.jit(lambda *a: jm.apply(variables, *a, is_eval=True))(
            *(jnp.asarray(b[k]) for k in ("coords", "features", "gt_masks")))
    pm = port_model(variables, 3)
    got = [trainer.validate(pm, [b], "cpu") for _ in range(2)]
    assert got[0] == got[1]
    assert set(got[0]) == {"iou(0)", "iou(1)", "iou(2)", "best_multimask_iou"}
    assert all(0.0 <= x <= 1.0 for x in got[0].values())


def synthetic_set(num_scenes):
    """The synthetic set of configs/dataset/synthetic.yaml with small
    scenes, as a whole dataset value in JSON (the overrides read YAML)."""
    ds = load_config("dataset/synthetic", context={"num_samples": 256})
    ds["dataset"].update(num_scenes=num_scenes, points_per_scene=512)
    return json.dumps(ds)


def test_trainer_trains_the_hier_recipe(tmp_path, capsys):
    """configs/large.yaml through trainer.main on the CPU with hier.yaml as
    its model (the tiny ViT, G=(64, 16), K=(8, 4); 8 click iterations), the
    synthetic set for training and validation: one epoch (one step of 2
    scenes), then a resume for a second with validation."""
    model = dict(load_config("model/hier"), vit="tiny",
                 tokenizer=dict(num_patches=[G1, G2], patch_size=[K1, K2], radius=list(RADIUS)))
    base = ["--config", "large", "--device", "cpu", f"project_dir={tmp_path / 'run'}",
            "num_samples=256", f"train_dataset={synthetic_set(2)}",
            f"val_dataset={synthetic_set(2)}", f"model={json.dumps(model)}", "save_freq=1",
            "scheduler.warmup_iters=2", "log_freq=1"]
    r1 = trainer.main(base + ["max_epochs=1", "val_freq=0"])
    pm = r1["model"]
    assert type(pm).__name__ == "PointCloudSAMHier" and pm.cfg.prompt_iters == 8
    assert pm.pc_encoder.transformer.remat
    assert r1["step"] == 1 and all(np.isfinite(h["loss"]) for h in r1["history"])
    assert not r1["first_step_zero_grads"] or all(
        n.startswith(("mask_decoder.output_hypernetworks_mlps.", "point_encoder."))
        for n in r1["first_step_zero_grads"])
    p1 = {k: v.clone() for k, v in pm.state_dict().items()}
    r2 = trainer.main(base + ["max_epochs=2", "val_freq=1"])
    assert "resumed from epoch 1" in capsys.readouterr().out
    assert r2["step"] == 2 and r2["optimizer"].count == 2
    assert all(np.isfinite(h["loss"]) for h in r2["history"])
    moved = {k for k, v in r2["model"].state_dict().items()
             if v.is_floating_point() and not torch.equal(v, p1[k])}
    assert any(k.startswith(LEVEL1[0]) for k in moved) and any(k.startswith(LEVEL1[1])
                                                               for k in moved)
    assert set(r2["val"]) == {f"iou({i})" for i in range(8)} | {"best_multimask_iou"}
    assert all(0.0 <= x <= 1.0 for x in r2["val"].values())
