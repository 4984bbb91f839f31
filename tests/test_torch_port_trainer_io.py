"""The trainer's inputs and outputs in the port against the JAX package, on
the CPU:

- ``pretrained_ckpt_path`` with a reference ``.safetensors`` file and with
  a Uni3D ``.pt`` file through ``trainer.main --config tiny --device cpu``
  (one step at rate 0, so the weights stay as loaded): the loaded weights
  equal JAX ``_load_pretrained`` of the same file (through
  ``state_dict_from_flax``; a key no file wrote keeps the port's seeded
  initial value) and the printed count lines match;
- the logged names: ``train/<metric>``, ``train/lr`` and ``val/<metric>``
  (JAX's ``test_trainer_writes_valid_metrics_json``);
- the batches: the port's trainer trains on JAX's trainer's, which starts
  at its iterator's second epoch (its init batch takes the first);
- the wandb gate: with a fake ``wandb`` module its run gets the metrics and
  the ``Object3D`` panels, and the PLY dump is written; without ``wandb``
  JAX's fallback line;
- ``dump_visualizations``' prompt PLYs byte-equal to JAX's for the same
  weights and validation batch;
- the giant, base and radius recipes build models whose parameter names and
  shapes equal JAX's (``jax.eval_shape`` there, the meta device here);
- one train step of configs/model/enc_with_radius.yaml at tiny widths
  (ViT "tiny", G=16, K=8, 2 click iterations; radius 0.1 kept) against
  JAX's ``make_train_step``, at the tolerances of test_torch_port_train.py.

Torch runs on one intra-op thread.
"""

import json
import sys
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import tests.test_convert as TC
import tests.test_torch_port_train as TT
from point_sam_tpu import models as J
from point_sam_tpu.datasets.build import BatchIterator as JBatchIterator
from point_sam_tpu.datasets.build import build_dataset as j_build_dataset
from point_sam_tpu.parallel import TrainState, make_train_step
from point_sam_tpu.train import trainer as JT
from point_sam_tpu.utils.config import build_model as j_build_model
from point_sam_tpu.utils.config import load_config as j_load_config

from point_sam_tpu_torch.parallel import make_optimizer, train_step
from point_sam_tpu_torch.train import trainer
from point_sam_tpu_torch.utils import state_dict_from_flax, torch_key_for
from point_sam_tpu_torch.utils.config import build_model, load_config


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SMALL = ["num_samples=256", "train_dataset.dataset.num_scenes=4",
         "train_dataset.dataset.points_per_scene=512", "val_dataset.dataset.num_scenes=2",
         "val_dataset.dataset.points_per_scene=512", "scheduler.warmup_iters=2"]


def run(tmp_path, overrides):
    return trainer.main(["--config", "tiny", "--device", "cpu", f"project_dir={tmp_path / 'run'}",
                         *SMALL, *overrides])


def jax_tiny_variables():
    jm = j_build_model(j_load_config("tiny").model)
    return jax.tree_util.tree_map(np.asarray, J.init_variables(jm, jax.random.PRNGKey(0)))


def scaled_ref():
    return {k: (v / np.sqrt(v.shape[1])).astype(np.float32)
            if v.ndim == 2 and "gaussian" not in k else np.ascontiguousarray(v)
            for k, v in TC.ref_state_dict().items()}


def uni3d_file(path):
    """A Uni3D checkpoint at the tiny widths: the encoder under
    point_encoder.{encoder2trans, pos_embed, visual} and keys the surgery
    leaves out."""
    module = {}
    for k, v in scaled_ref().items():
        for src, dst in (("pc_encoder.patch_proj.", "point_encoder.encoder2trans."),
                         ("pc_encoder.pos_embed.", "point_encoder.pos_embed."),
                         ("pc_encoder.transformer.", "point_encoder.visual.")):
            if k.startswith(src):
                module[dst + k[len(src):]] = torch.from_numpy(v)
    module["point_encoder.visual.cls_token"] = torch.zeros(1, 1, 128)
    module["point_encoder.visual.unknown"] = torch.zeros(3)
    module["point_encoder.encoder.first_conv.weight"] = torch.zeros(4, 4)
    module["logit_scale"] = torch.ones(())
    torch.save({"module": module}, path)


@pytest.mark.parametrize("kind", ["safetensors", "uni3d"])
def test_pretrained_init_matches_jax(kind, tmp_path, capsys):
    if kind == "safetensors":
        from safetensors.numpy import save_file

        path = tmp_path / "model.safetensors"
        save_file(scaled_ref(), str(path))
    else:
        path = tmp_path / "uni3d.pt"
        uni3d_file(path)
    jv = jax_tiny_variables()
    jnew, jrep = JT._load_pretrained(str(path), jv)
    want_lines = [ln for ln in capsys.readouterr().out.splitlines() if "init:" in ln]
    result = run(tmp_path, [f"pretrained_ckpt_path={path}", "lr=0", "max_steps=1",
                            "max_epochs=1", "val_freq=0"])
    out = capsys.readouterr().out
    assert f"initialized from {path}" in out
    assert [ln for ln in out.splitlines() if "init:" in ln] == want_lines
    assert len(want_lines) == (kind == "uni3d")
    want = state_dict_from_flax(jnew)
    unfilled = {torch_key_for(p) for p in jrep["unfilled"]
                if not p.endswith("label_embed")} | (
        {"point_encoder.point_embeddings.0.weight", "point_encoder.point_embeddings.1.weight"}
        if "params/point_encoder/label_embed" in jrep["unfilled"] else set())
    if kind == "safetensors":
        assert not unfilled
    init = build_model(load_config("tiny").model, generator=torch.Generator().manual_seed(42))
    init = init.state_dict()
    got = result["model"].state_dict()
    assert set(got) == set(want)
    for k, v in got.items():
        assert torch.equal(v, init[k] if k in unfilled else want[k]), k
    if kind == "uni3d":
        assert any(k.startswith("pc_encoder.transformer.blocks.") for k in set(got) - unfilled)


def test_trainer_logs_the_reference_names(tmp_path, capsys):
    run(tmp_path, ["max_epochs=1", "val_freq=1", "log_freq=1"])
    out = capsys.readouterr().out
    train = [ln for ln in out.splitlines() if "train/loss=" in ln]
    assert len(train) == 2 and all("train/lr=" in ln and ln.endswith(" ms)") for ln in train)
    assert "train/first/iou=" in train[0] and "train/last/loss_mask=" in train[0]
    val = [ln for ln in out.splitlines() if "val/iou(0)=" in ln]
    assert len(val) == 1 and "val/best_multimask_iou=" in val[0] and "val/iou(2)=" in val[0]
    assert val[0].startswith("[step 2] ")
    assert "not ported" not in out


def test_trainer_trains_on_the_jax_trainers_batches(tmp_path, monkeypatch):
    """JAX's trainer draws the batch it initialises the model on from its
    iterator's first epoch (trainer.py:122), so its first step takes the
    second epoch's first batch; the port's trainer skips that epoch
    (``BatchIterator.skip_epoch``) and takes the same batch."""
    import importlib

    TS = importlib.import_module("point_sam_tpu_torch.parallel.train_step")
    seen, real = [], TS.train_step

    def spy(model, tx, batch, *args, **kw):
        seen.append({k: v.numpy().copy() for k, v in batch.items()})
        return real(model, tx, batch, *args, **kw)

    monkeypatch.setattr(TS, "train_step", spy)
    run(tmp_path, ["max_steps=1", "val_freq=0"])
    jcfg = j_load_config("tiny", SMALL)
    it = JBatchIterator(j_build_dataset(jcfg.train_dataset, seed=42, context={"num_samples": 256}),
                        2, shuffle=True, drop_last=True, seed=42)
    next(iter(it))  # the JAX trainer's init batch
    want = next(iter(it))
    for k, v in want.items():
        np.testing.assert_array_equal(seen[0][k], v, err_msg=k)


def test_wandb_gate(tmp_path, monkeypatch, capsys):
    """A live wandb run gets the scalars and, with vis_freq, the Object3D
    panels beside the PLY dump; without wandb the run logs to stdout."""
    logged, calls = [], []

    class FakeObject3D:
        def __init__(self, data):
            data = np.asarray(data)
            assert data.ndim == 2 and data.shape[1] == 6  # xyz + rgb
            self.data = data

    class FakeRun:
        def log(self, metrics, step=None):
            logged.append((dict(metrics), step))

        def finish(self):
            calls.append("finish")

    fake = types.ModuleType("wandb")
    fake.Object3D = FakeObject3D
    fake.init = lambda **kw: calls.append(kw) or FakeRun()
    monkeypatch.setitem(sys.modules, "wandb", fake)
    run(tmp_path, ["max_epochs=1", "val_freq=1", "vis_freq=1", "log_freq=1", "log_with=wandb",
                   "run_name=tiny_wandb"])
    assert calls[0]["name"] == "tiny_wandb" and calls[-1] == "finish"
    scalars = {k for metrics, _ in logged for k, v in metrics.items()
               if not isinstance(v, FakeObject3D)}
    assert {"train/loss", "train/lr", "val/iou(0)"} <= scalars
    panels = {k: v for metrics, _ in logged for k, v in metrics.items()
              if isinstance(v, FakeObject3D)}
    assert set(panels) == {f"val/sample{i}_{s}" for i in range(4) for s in ("pred", "prompts")}
    rgb = panels["val/sample0_prompts"].data[:, 3:]
    assert ((rgb == (0, 255, 0)).all(1) | (rgb == (255, 0, 0)).all(1)).any()
    assert len(list((tmp_path / "run" / "vis" / "ep1").glob("*.ply"))) == 8
    assert "[step" not in capsys.readouterr().out

    monkeypatch.setitem(sys.modules, "wandb", None)  # import wandb raises
    run(tmp_path / "b", ["max_epochs=1", "val_freq=0", "log_freq=1", "log_with=wandb"])
    out = capsys.readouterr().out
    assert "wandb unavailable (" in out and "); logging to stdout" in out
    assert "train/loss=" in out


def test_dump_visualizations_prompts_match_jax(tmp_path):
    """The same weights and validation batch: the prompt PLYs are equal byte
    for byte (JAX's clicks are the port's), the mask PLYs written."""
    from point_sam_tpu.train.trainer import dump_visualizations as j_dump

    cfg = load_config("tiny", SMALL)
    jcfg = j_load_config("tiny", SMALL)
    jv = jax_tiny_variables()
    jm = j_build_model(jcfg.model)
    jds = j_build_dataset(jcfg.val_dataset, seed=43, context={"num_samples": 256})
    state = types.SimpleNamespace(params=jv["params"],
                                  buffers={k: v for k, v in jv.items() if k != "params"})
    j_dump(jm, state, JBatchIterator(jds, 2, shuffle=False, drop_last=False, seed=42),
           tmp_path / "jax")
    pm = build_model(cfg.model, generator=torch.Generator().manual_seed(0))
    pm.load_state_dict(state_dict_from_flax(jv), strict=True)
    trainer.dump_visualizations(pm, trainer.val_iterator(cfg, 42), tmp_path / "port")
    for i in range(4):
        want = (tmp_path / "jax" / f"sample{i}_prompts.ply").read_bytes()
        assert (tmp_path / "port" / f"sample{i}_prompts.ply").read_bytes() == want, i
        assert (tmp_path / "port" / f"sample{i}_pred.ply").stat().st_size == \
            (tmp_path / "jax" / f"sample{i}_pred.ply").stat().st_size


# ------------------------------------------------------------ recipes
RECIPES = {
    "giant": ("giant", []),
    "base": ("base", []),
    "radius": ("large", ["model=" + json.dumps(load_config("model/enc_with_radius"))]),
}


def jax_param_shapes(model):
    """The port's key -> shape of a JAX model's variables (shapes only)."""
    tree = jax.eval_shape(lambda k: J.init_variables(model, k), jax.random.PRNGKey(0))
    out = {}

    def leaf(path, shape):
        if path.endswith("/attn/qkv/bias"):
            base = torch_key_for(path[:-5] + "/kernel").rsplit(".qkv.", 1)[0]
            out[f"{base}.q_bias"] = out[f"{base}.v_bias"] = (shape[0] // 3,)
        elif path == "params/point_encoder/label_embed":
            for i in range(shape[0]):
                out[f"point_encoder.point_embeddings.{i}.weight"] = (1, shape[1])
        elif path == "params/mask_encoder/no_mask_embed":
            out[torch_key_for(path)] = (1, shape[0])
        else:
            out[torch_key_for(path)] = shape[::-1] if path.endswith("/kernel") else shape

    for keypath, s in jax.tree_util.tree_flatten_with_path(tree)[0]:
        path = "/".join(str(getattr(k, "key", k)) for k in keypath)
        if "/blocks/block/" in path:
            pre, post = path.split("/blocks/block/")
            for i in range(s.shape[0]):
                leaf(f"{pre}/blocks_{i}/{post}", tuple(s.shape[1:]))
        else:
            leaf(path, tuple(s.shape))
    return out


@pytest.mark.parametrize("recipe", sorted(RECIPES))
def test_recipe_builds_the_jax_model(recipe):
    name, overrides = RECIPES[recipe]
    cfg, jcfg = load_config(name, overrides), j_load_config(name, overrides)
    assert cfg == jcfg
    model = build_model(cfg.model, device="meta")
    jm = j_build_model(jcfg.model)
    got = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert got == jax_param_shapes(jm)
    tok = model.cfg.tokenizer
    assert (tok.num_patches, tok.patch_size, tok.radius) == (
        jm.cfg.tokenizer.num_patches, jm.cfg.tokenizer.patch_size, jm.cfg.tokenizer.radius)
    assert model.cfg.prompt_iters == jm.cfg.prompt_iters
    assert model.cfg.vit_cfg.embed_dim == {"giant": 1408, "base": 768, "radius": 1024}[recipe]


def test_radius_train_step_matches_jax():
    """configs/model/enc_with_radius.yaml (radius 0.1) at tiny widths: one
    train step's loss and every gradient against JAX's."""
    mc = load_config("model/enc_with_radius")
    mc.update(vit="tiny", prompt_iters=2, tokenizer={**mc["tokenizer"], "num_patches": 16,
                                                     "patch_size": 8})
    jm = j_build_model(mc)
    assert jm.cfg.tokenizer.radius == 0.1
    v = TT.perturb(jax.tree_util.tree_map(np.asarray, J.init_variables(jm, jax.random.PRNGKey(0))))
    batch = TT.make_batch(np.random.default_rng(5))
    jb = {k: jnp.asarray(a) for k, a in batch.items()}
    tx = TT.capture_grads()
    params = v["params"]
    buffers = {k: x for k, x in v.items() if k != "params"}
    step_fn = make_train_step(jm, tx, donate=False)
    new_state, metrics = step_fn(TrainState.create(params, buffers, tx), jb,
                                 jax.random.PRNGKey(3))
    jgrads = state_dict_from_flax({"params": jax.tree_util.tree_map(np.asarray,
                                                                    new_state.opt_state)})
    pm = build_model(mc, generator=torch.Generator().manual_seed(0))
    assert pm.cfg.tokenizer.radius == 0.1
    pm.load_state_dict(state_dict_from_flax(v), strict=True)
    opt = make_optimizer(pm.parameters(), lambda step: 0.0, weight_decay=0.0,
                         max_grad_value=float("inf"))
    got = train_step(pm, opt, {k: TT.t(a) for k, a in batch.items()},
                     torch.Generator().manual_seed(0))
    np.testing.assert_allclose(got["loss"].item(), float(metrics["loss"]), rtol=1e-5)
    for name, p in pm.named_parameters():
        want = jgrads[name].numpy()
        g = np.zeros_like(want) if p.grad is None else p.grad.numpy()
        err = np.abs(g - want).max()
        rel = 5e-3 if name.startswith("mask_encoder.patch_encoder.") else 1e-4
        assert err <= rel * np.abs(want).max() + 1e-7, (name, err, np.abs(want).max())
