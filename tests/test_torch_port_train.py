"""The training slice of the port against the JAX package, on the CPU in fp32.

- the click sampler (same indices), the criterion, the LR schedule, the
  optimizer after 3 updates, ``load_config``;
- one whole train step of the tiny model with the same weights and batch:
  the JAX loss and gradients come from ``jax.value_and_grad`` inside
  ``make_train_step`` (read back through an optax transformation that keeps
  the gradients as its state), the port's from ``train_step``. Two
  settings: prompt_iters=2 in training mode (randint(1, 2) is always 1, so
  the refinement draw agrees) and prompt_iters=3 with refinement
  iterations off (evaluation clicks: mask prompts, and so K2's backward, in
  two iterations);
- ``trainer.main`` for 2 epochs with a resume, and ``validate``.

Tolerances: the loss within 1e-5 relative; each gradient leaf within
1e-4 * max|g| + 1e-7 (fp32, XLA fuses the forward differently: encoder
outputs move by ~5e-5 relative), except the mask prompt's PointNet,
5e-3 * max|g| + 1e-7: its input is the previous iteration's mask logits,
which differ between the packages by ~2e-6 relative, and a max-pool
near-tie within that distance moves a column's gradient to another row
(3.6e-3 measured on this batch; given identical inputs the two agree to
1e-6, see test_torch_port_grads.py). Optimizer and schedule 1e-6 relative.
"""

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from point_sam_tpu import models as J
from point_sam_tpu.datasets.transforms import build_transforms as j_build_transforms
from point_sam_tpu.ops import sampler as JS
from point_sam_tpu.parallel import TrainState, make_train_step
from point_sam_tpu.parallel import make_optimizer as j_make_optimizer
from point_sam_tpu.train import warmup_multistep as j_warmup
from point_sam_tpu.utils.config import load_config as j_load_config

from point_sam_tpu_torch import models as P
from point_sam_tpu_torch.datasets import build_transforms
from point_sam_tpu_torch.models.loss import criterion
from point_sam_tpu_torch.ops.sampler import sample_prompts, sample_prompts_random
from point_sam_tpu_torch.parallel import make_optimizer, train_step
from point_sam_tpu_torch.train import trainer, warmup_multistep
from point_sam_tpu_torch.utils import state_dict_from_flax
from point_sam_tpu_torch.utils.config import build_model, load_config


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


def t(a):
    return torch.from_numpy(np.array(a))


# ------------------------------------------------------------ sampler
@pytest.mark.parametrize("with_valid", [False, True])
def test_sample_prompts_match_jax(with_valid):
    """N=2600 spans two of the port's 2048-point key tiles, the second ragged."""
    n = 2600
    rng = np.random.default_rng(0)
    b = make_batch(rng, N=n)
    valid = None
    if with_valid:
        valid = rng.random((2, n)) > 0.2
    logits = rng.standard_normal((4, n)).astype(np.float32)
    for prev in (None, logits):
        kw_j = {} if valid is None else {"point_valid": jnp.asarray(valid)}
        kw_t = {} if valid is None else {"point_valid": t(valid)}
        wc, wl = JS.sample_prompts(jnp.asarray(b["coords"]), jnp.asarray(b["gt_masks"]),
                                   None if prev is None else jnp.asarray(prev),
                                   key_tile=128, **kw_j)
        gc, gl = sample_prompts(t(b["coords"]), t(b["gt_masks"]),
                                None if prev is None else t(prev), **kw_t)
        np.testing.assert_array_equal(gc.numpy(), np.asarray(wc))
        np.testing.assert_array_equal(gl.numpy(), np.asarray(wl))


@pytest.mark.parametrize("case", ["first", "refine", "no_error", "valid"])
def test_sample_prompts_random_matches_jax_support(case):
    """The random sampler draws from a torch generator where JAX draws from
    a PRNG key, so the two are held to the same support: over 400 draws,
    each (cloud, mask) picks the same set of (point, label) pairs in both.
    The regions hold 17-36 points, so 400 uniform draws leave a point of a
    region unpicked with probability below 36 (1 - 1/36)^400 < 1e-3; the
    seeds are fixed. ``no_error`` predicts the GT exactly: both fall back
    to it."""
    rng = np.random.default_rng(5)
    b = make_batch(rng, N=60)
    gt = b["gt_masks"]
    prev = valid = None
    if case in ("refine", "valid"):
        prev = rng.standard_normal((4, 60)).astype(np.float32)
    if case == "no_error":
        prev = np.where(gt.reshape(4, 60), 1.0, -1.0).astype(np.float32)
    if case == "valid":
        valid = rng.random((2, 60)) > 0.3
    kw_j = {} if valid is None else {"point_valid": jnp.asarray(valid)}
    kw_t = {} if valid is None else {"point_valid": t(valid)}
    draws = 400
    keys = jax.random.split(jax.random.PRNGKey(0), draws)
    wc, wl = jax.vmap(lambda k: JS.sample_prompts_random(
        k, jnp.asarray(b["coords"]), jnp.asarray(gt),
        None if prev is None else jnp.asarray(prev), **kw_j))(keys)
    gen = torch.Generator().manual_seed(0)
    got = [sample_prompts_random(gen, t(b["coords"]), t(gt), None if prev is None else t(prev),
                                 **kw_t) for _ in range(draws)]
    gc = np.stack([c.numpy() for c, _ in got])
    gl = np.stack([lab.numpy() for _, lab in got])

    def support(c, lab, bm):
        return {(tuple(c[d, bm, 0]), bool(lab[d, bm, 0])) for d in range(draws)}

    for bm in range(4):
        want = support(np.asarray(wc), np.asarray(wl), bm)
        assert support(gc, gl, bm) == want
        if case in ("first", "no_error"):
            assert all(label for _, label in want)


# ------------------------------------------------------------ criterion
def test_criterion_matches_jax():
    rng = np.random.default_rng(1)
    gt = rng.random((4, 200)) > 0.6
    outs = [dict(masks=rng.standard_normal((4, c, 200)).astype(np.float32) * 3,
                 iou_preds=rng.random((4, c)).astype(np.float32)) for c in (3, 1, 1)]
    for soft in (False, True):
        wl, waux = J.criterion([{k: jnp.asarray(v) for k, v in o.items()} for o in outs],
                               jnp.asarray(gt), use_soft_iou=soft)
        gl, gaux = criterion([{k: t(v) for k, v in o.items()} for o in outs], t(gt),
                             use_soft_iou=soft)
        np.testing.assert_allclose(gl.item(), float(wl), rtol=1e-6)
        for w, g in zip(waux, gaux):
            for k in w:
                np.testing.assert_allclose(g[k].float().numpy(), np.asarray(w[k], np.float32),
                                           rtol=1e-5, atol=1e-6, err_msg=k)


# ------------------------------------------------------- schedule, optimizer
def test_warmup_multistep_matches_jax():
    want = j_warmup(3e-4, [30, 60], gamma=0.1, warmup_factor=0.001, warmup_iters=10)
    got = warmup_multistep(3e-4, [30, 60], gamma=0.1, warmup_factor=0.001, warmup_iters=10)
    for step in range(101):
        np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-6, err_msg=str(step))
    with pytest.raises(ValueError):
        warmup_multistep(1e-3, [60, 30])


def test_optimizer_matches_optax():
    """Three updates on the same gradients: clip-by-value, AdamW with
    decoupled decay, and the schedule evaluated at count 0 first."""
    rng = np.random.default_rng(2)
    params = {"a": rng.standard_normal((5, 4)).astype(np.float32),
              "b": rng.standard_normal(7).astype(np.float32)}
    grads = [{k: 2.0 * rng.standard_normal(v.shape).astype(np.float32) for k, v in params.items()}
             for _ in range(3)]
    sched_j = j_warmup(1e-2, [2], gamma=0.5, warmup_factor=0.1, warmup_iters=2)
    tx = j_make_optimizer(sched_j, weight_decay=0.1, max_grad_value=1.0)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    st = tx.init(jp)
    for g in grads:
        upd, st = tx.update({k: jnp.asarray(v) for k, v in g.items()}, st, jp)
        jp = optax.apply_updates(jp, upd)
    tp = {k: torch.nn.Parameter(t(v)) for k, v in params.items()}
    opt = make_optimizer(tp.values(), warmup_multistep(1e-2, [2], gamma=0.5,
                                                       warmup_factor=0.1, warmup_iters=2),
                         weight_decay=0.1, max_grad_value=1.0)
    for g in grads:
        opt.zero_grad()
        for k, p in tp.items():
            p.grad = t(g[k])
        opt.step()
    for k in params:
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]), rtol=1e-6,
                                   atol=1e-7)


# ------------------------------------------------------------ config
def test_load_config_matches_jax():
    for name, ov in (("large", ["train_dataset.dataset.source=synthetic", "val_freq=0",
                                "max_steps=4", "lr=1e-5"]),
                     ("tiny", ["model.prompt_iters=2"]), ("base", [])):
        assert load_config(name, ov) == j_load_config(name, ov)
    cfg = load_config("large", ["train_dataset.dataset.source=synthetic"])
    assert cfg.train_dataset.dataset.source == "synthetic"
    assert cfg.train_dataset.transforms[3]["num_samples"] == 10000
    m = build_model(load_config("tiny").model, generator=torch.Generator().manual_seed(0))
    assert m.cfg.prompt_iters == 3 and m.dtype == torch.float32
    with pytest.raises(NotImplementedError, match="queue 1, item 8"):
        build_model(load_config("voronoi_large").model)


def test_build_transforms_match_jax():
    """The ViT-L recipe's transform chain (the large config's train set):
    every random transform draws from the seeded generator it was given, so
    the port and the JAX package give the same examples, draw after draw."""
    specs = load_config("large", ["num_samples=256"]).train_dataset.transforms
    rng = np.random.default_rng(6)
    ex = dict(coords=rng.standard_normal((600, 3)).astype(np.float32),
              features=(255 * rng.random((600, 3))).astype(np.float32),
              gt_masks=rng.random((5, 600)) > 0.7)
    got = build_transforms(specs, rng=np.random.default_rng(0))
    want = j_build_transforms(specs, rng=np.random.default_rng(0))
    assert [type(a).__name__ for a in got.transforms] == [
        type(a).__name__ for a in want.transforms]
    for _ in range(3):
        g, w = got(dict(ex)), want(dict(ex))
        assert g["coords"].shape == (256, 3) and g["gt_masks"].shape == (2, 256)
        for k in ("coords", "features", "gt_masks"):
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


# ------------------------------------------------------------ one train step
def capture_grads():
    """An optax transformation whose state becomes the gradients (and whose
    updates are zero), to read the gradients of make_train_step back."""
    def init(params):
        return jax.tree_util.tree_map(jnp.zeros_like, params)

    def update(g, state, params=None):
        return jax.tree_util.tree_map(jnp.zeros_like, g), g

    return optax.GradientTransformation(init, update)


def perturb(variables, seed=0):
    rng = np.random.default_rng(seed)

    def leaf(a):
        a = np.array(a, np.float32)
        return a + 0.05 * rng.standard_normal(a.shape).astype(np.float32) if a.ndim == 1 else a

    return jax.tree_util.tree_map(leaf, variables)


@pytest.mark.parametrize("iters,refine", [(2, True), (3, False)])
def test_train_step_matches_jax(iters, refine):
    jm = J.PointCloudSAM(J.PointSAMConfig(vit="tiny", tokenizer=J.TokenizerConfig(16, 8),
                                          prompt_iters=iters,
                                          enable_mask_refinement_iterations=refine))
    v = perturb(jax.tree_util.tree_map(np.asarray, J.init_variables(jm, jax.random.PRNGKey(0))))
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

    pm = P.PointCloudSAM(P.PointSAMConfig(vit="tiny", tokenizer=P.TokenizerConfig(16, 8),
                                          prompt_iters=iters,
                                          enable_mask_refinement_iterations=refine),
                         generator=torch.Generator().manual_seed(0))
    pm.load_state_dict(state_dict_from_flax(v), strict=True)
    tb = {k: t(a) for k, a in batch.items()}
    with torch.no_grad():
        pouts = pm(tb["coords"], tb["features"], tb["gt_masks"],
                   generator=torch.Generator().manual_seed(0))
    assert len(pouts) == len(jouts) == iters
    for po, jo in zip(pouts, jouts):  # the same clicks in every iteration
        for k in ("prompt_coords", "prompt_labels", "prompt_valid"):
            np.testing.assert_array_equal(po[k].numpy(), np.asarray(jo[k]), err_msg=k)

    opt = make_optimizer(pm.parameters(), lambda step: 0.0, weight_decay=0.0,
                         max_grad_value=float("inf"))
    got = train_step(pm, opt, tb, torch.Generator().manual_seed(0))
    np.testing.assert_allclose(got["loss"].item(), float(metrics["loss"]), rtol=1e-5)
    for k in ("first/iou", "last/iou", "first/acc", "last/loss_mask"):
        np.testing.assert_allclose(got[k].item(), float(metrics[k]), rtol=1e-4, atol=1e-6)
    names = dict(pm.named_parameters())
    assert set(names) <= set(jgrads)
    for name, p in names.items():
        want = jgrads[name].numpy()
        g = np.zeros_like(want) if p.grad is None else p.grad.numpy()
        err = np.abs(g - want).max()
        rel = 5e-3 if name.startswith("mask_encoder.patch_encoder.") else 1e-4
        assert err <= rel * np.abs(want).max() + 1e-7, (name, err, np.abs(want).max())


# ------------------------------------------------------------ trainer
def run_trainer(tmp_path, overrides):
    base = [f"project_dir={tmp_path / 'run'}", "num_samples=256",
            "train_dataset.dataset.num_scenes=8", "train_dataset.dataset.points_per_scene=512",
            "val_dataset.dataset.num_scenes=4", "val_dataset.dataset.points_per_scene=512",
            "scheduler.warmup_iters=2", "log_freq=1"]
    return trainer.main(["--config", "tiny", "--device", "cpu"] + base + overrides)


def test_trainer_resume_and_validate(tmp_path, capsys):
    r1 = run_trainer(tmp_path, ["max_epochs=1", "val_freq=0"])
    assert r1["step"] == 4  # 8 scenes / batch 2
    assert all(np.isfinite(h["loss"]) for h in r1["history"])
    p1 = {k: v.clone() for k, v in r1["model"].state_dict().items()}
    assert list((tmp_path / "run" / "checkpoints").iterdir())
    r2 = run_trainer(tmp_path, ["max_epochs=2", "val_freq=1"])
    assert "resumed from epoch 1" in capsys.readouterr().out
    assert r2["step"] == 8  # continued, not restarted
    assert r2["optimizer"].count == 8
    moved = [k for k, v in r2["model"].state_dict().items()
             if v.is_floating_point() and not torch.equal(v, p1[k])]
    assert moved
    val = r2["val"]
    assert set(val) == {"iou(0)", "iou(1)", "iou(2)", "best_multimask_iou"}
    assert all(0.0 <= x <= 1.0 for x in val.values())


def test_trainer_needs_a_device_or_cuda():
    if torch.cuda.is_available():
        assert trainer.resolve_device(None).type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="--device cpu"):
            trainer.resolve_device(None)
    assert trainer.resolve_device("cpu").type == "cpu"
