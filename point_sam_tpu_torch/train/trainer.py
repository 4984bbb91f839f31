"""Training entry point of the PyTorch port (counterpart of
point_sam_tpu/train/trainer.py):

    python -m point_sam_tpu_torch.train.trainer --config large \
        train_dataset.dataset.source=synthetic val_freq=0 max_steps=N
    python -m point_sam_tpu_torch.train.trainer --config tiny --device cpu
    torchrun --nproc_per_node=8 -m point_sam_tpu_torch.train.trainer \
        --config giant param_sharding=fsdp

Multi-process runs join a process group before the model is built
(``parallel.distributed.maybe_initialize``: torchrun's environment, or the
config's ``distributed:`` section, ``{coordinator_address, num_processes,
process_id}`` or ``auto``): NCCL with one card a rank, gloo on the CPU.
``train_dataloader.batch_size`` is then the global batch, each rank
loading its slice. ``param_sharding: replicated`` (the default) trains
under DDP; ``fsdp`` under FSDP2 (``parallel.fsdp``), the model built on
the host, pretrained weights applied there, then sharded onto the cards;
``tp`` raises, as JAX's trainer cannot take it either (its 1-D mesh has
no model axis): tensor parallelism is the library path
``parallel.tensor_parallel.shard_model`` + ``train_step``. A run computes what one
process computes on the global batch from the same starting weights.
Weights drawn from the seed differ between the two builds (an FSDP model
draws them from the host's generator, a one-device or DDP model from the
card's), so from one seed they agree only where ``pretrained_ckpt_path``
gives every weight. Only rank 0 prints, logs, writes
checkpoints (the one-process layout, resumable at any world size) and
writes the visualisation dump; every rank validates over the whole
validation set.

All the recipes train: kNN (``variant: knn``: ``large``, ``base``,
``giant``, and ``large`` with configs/model/enc_with_radius.yaml as its
whole ``model`` value), voronoi (``voronoi_large``, ``voronoi_giant``) and
hier (``large`` with configs/model/hier.yaml as its ``model``). A whole
value is given in JSON, which the overrides read as YAML; so the synthetic
set takes the place of a recipe's ``mixture`` of hub datasets (README.md
has the commands).

config -> model -> pretrained weights (``pretrained_ckpt_path``: a
reference ``.safetensors`` checkpoint or a Uni3D encoder ``.pt``,
``load_pretrained``) -> data -> the train loop of ``parallel.train_step``
(simulated-click forward, criterion, backward, clip-by-value, AdamW,
warmup-multistep schedule), keep-1 checkpoints with resume, IoU-per-click
validation and, every ``vis_freq`` epochs, the visualisation dump
(``dump_visualizations``). Metrics go out under the reference's scalar
names (``train/<metric>`` and ``train/lr`` every ``log_freq`` steps,
``val/<metric>`` after validation) to wandb with ``log_with: wandb`` where
it starts, else to stdout. It runs on ``cuda`` unless ``--device`` names
another device, and raises without a card rather than falling back to the
CPU. TF32 stays off for matmuls (set when the package is imported). Model
parameters are fp32; the compute dtype is bf16 on a CUDA device and fp32
elsewhere.
"""

from __future__ import annotations

import argparse
import json
import statistics
import time
from collections import defaultdict
from functools import partial
from pathlib import Path

import numpy as np
import torch

from ..ops._cuda import resolve_device
from ..parallel.distributed import is_main_process


def to_device(batch: dict, device) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in batch.items()}


def val_iterator(cfg, seed: int):
    """The validation batches of the run config ``cfg`` (not shuffled, the
    last batch kept)."""
    from ..datasets.build import BatchIterator, build_dataset

    ds = build_dataset(cfg.val_dataset, seed=seed + 1,
                       context={"num_samples": cfg.get("num_samples")})
    return BatchIterator(ds, cfg.val_dataloader.batch_size, shuffle=False, drop_last=False,
                         seed=seed)


def train_iterator(cfg, seed: int, process_index: int = 0, process_count: int = 1):
    """(the training set, its iterator) of the run config ``cfg``: each
    global batch's slice for ``process_index`` of ``process_count`` data
    ranks. JAX's trainer initialises its model on a batch drawn from the
    iterator's first epoch (its trainer.py:122) and so trains from the
    second: the iterator starts there too, so both trainers see the same
    batches."""
    from ..datasets.build import BatchIterator, build_dataset

    ds = build_dataset(cfg.train_dataset, seed=seed,
                       context={"num_samples": cfg.get("num_samples")})
    it = BatchIterator(ds, cfg.train_dataloader.batch_size,
                       shuffle=cfg.train_dataloader.get("shuffle", True),
                       drop_last=cfg.train_dataloader.get("drop_last", True), seed=seed,
                       process_index=process_index, process_count=process_count)
    it.skip_epoch()
    return ds, it


def recipe_optimizer(cfg, params):
    """(optimizer, schedule) of the run config ``cfg``: the warmup-multistep
    schedule of ``lr`` and ``scheduler``, AdamW with clip-by-value."""
    from ..parallel.train_step import make_optimizer
    from .schedule import warmup_multistep

    sched = warmup_multistep(cfg.lr, cfg.scheduler.milestones,
                             gamma=cfg.scheduler.get("gamma", 0.1),
                             warmup_factor=cfg.scheduler.get("warmup_factor", 0.001),
                             warmup_iters=cfg.scheduler.get("warmup_iters", 1000))
    tx = make_optimizer(params, sched, weight_decay=cfg.get("weight_decay", 0.1),
                        max_grad_value=cfg.get("max_grad_value", 1.0))
    return tx, sched


def recipe_criterion(cfg):
    """The loss of the run config ``cfg`` (its ``loss.use_soft_iou``)."""
    from ..models.loss import criterion

    return partial(criterion, use_soft_iou=(cfg.get("loss", {}) or {}).get("use_soft_iou", False))


def main(argv=None) -> dict:
    """Train; returns dict(model, optimizer, step, history, first_step_zero_grads, val).

    ``history`` holds one dict per step of this run (step, loss, ms: the
    step's time, ending in a device synchronisation); ``first_step_zero_grads``
    names the parameters whose gradient was missing or all zero on this
    run's first step.
    """
    parser = argparse.ArgumentParser(prog="point_sam_tpu_torch.train.trainer")
    parser.add_argument("--config", type=str, required=True)
    parser.add_argument("--device", type=str, default=None,
                        help="torch device (default: cuda)")
    parser.add_argument("overrides", nargs="*", default=[])
    args = parser.parse_args(argv)

    from ..datasets.build import BatchIterator
    from ..parallel import distributed as D
    from ..parallel.fsdp import shard_model
    from ..parallel.train_step import (
        train_step,
        unused_parameters,
        unwrap,
        wrap_ddp,
        zero_grad_names,
    )
    from ..utils.checkpoint import CheckpointManager, gather_train_state, load_train_state
    from ..utils.config import build_model, load_config

    device = resolve_device(args.device)
    cfg = load_config(args.config, args.overrides)
    seed = cfg.get("seed", 42)
    sharding = cfg.get("param_sharding", "replicated")
    if sharding == "tp":
        raise ValueError("param_sharding=tp: the trainer, like JAX's (whose 1-D mesh has no "
                         "model axis), takes replicated or fsdp; tensor parallelism runs "
                         "through parallel.tensor_parallel.shard_model and train_step")
    if sharding not in ("replicated", "fsdp"):
        raise ValueError(f"unknown param_sharding {sharding!r} (replicated or fsdp)")

    # Join the process group before anything is built (torchrun's
    # environment or the config's distributed: section).
    owns_group = D.maybe_initialize(cfg, device)
    distributed = torch.distributed.is_initialized()
    if distributed:
        device = D.initialize(device=device)
    elif sharding == "fsdp":
        raise ValueError("param_sharding=fsdp needs a process group: launch with torchrun or "
                         "give a distributed: section")
    rank, world = D.process_index(), D.process_count()
    main_proc = rank == 0
    say = partial(print, flush=True) if main_proc else (lambda *a, **k: None)

    # FSDP builds on the host: the card never holds the whole model.
    build_on = torch.device("cpu") if sharding == "fsdp" else device
    model = build_model(cfg.model, device=build_on,
                        dtype=torch.bfloat16 if device.type == "cuda" else torch.float32,
                        generator=torch.Generator(build_on).manual_seed(seed))
    if cfg.get("pretrained_ckpt_path"):
        load_pretrained(cfg.pretrained_ckpt_path, model)
        say(f"initialized from {cfg.pretrained_ckpt_path}")
    say(f"model: {type(model).__name__} ({cfg.model.get('vit')}) on {device}, "
        f"compute {model.dtype}, params "
        f"{sum(p.numel() for p in model.parameters()) / 1e6:.1f}M"
        + (f", {world} processes, {'DDP' if sharding == 'replicated' else 'FSDP'}"
           if distributed else ""))

    train_ds, train_iter = train_iterator(cfg, seed, rank, world)
    val_iter = val_iterator(cfg, seed) if cfg.get("val_freq", 0) > 0 else None
    crit = recipe_criterion(cfg)
    # Draws the refinement-only click iteration of each step (host side).
    clicks = torch.Generator().manual_seed(seed + 2)

    if sharding == "fsdp":
        model = shard_model(model, device)
    else:
        model = model.to(device)
        if distributed:
            # DDP needs find_unused_parameters only when some parameter
            # takes no gradient: a forward and backward of one cloud says.
            probe = to_device(BatchIterator._stack(
                [train_ds.get(0, rng=np.random.default_rng(seed))]), device)
            unused = unused_parameters(model, probe, clicks, criterion=crit)
            if unused:
                say(f"DDP: {len(unused)} parameters take no gradient (first: {unused[:3]})")
            model = wrap_ddp(model, device, find_unused_parameters=bool(unused))
    net = unwrap(model)

    tx, sched = recipe_optimizer(cfg, model.parameters())
    accum = cfg.get("gradient_accumulation_steps", 1)

    project_dir = Path(cfg.get("project_dir", "./logs/run"))
    ckpt = CheckpointManager(project_dir / "checkpoints")
    start_epoch, global_step = 0, 0
    if distributed:
        # Rank 0 reads the file; set_state_dict scatters it to every rank.
        meta, state = [None], {}
        if main_proc and (latest := ckpt.latest_step()) is not None:
            state = ckpt.restore(latest, map_location="cpu")
            meta = [(latest, state["step"])]
        torch.distributed.broadcast_object_list(meta, src=0)
        if meta[0] is not None:
            load_train_state(model, tx, state)
            start_epoch, global_step = meta[0]
        del state
    else:
        latest = ckpt.latest_step()
        if latest is not None:
            state = ckpt.restore(latest, map_location=device)
            model.load_state_dict(state["model"])
            tx.load_state_dict(state["optimizer"])
            global_step, start_epoch = state["step"], latest
    if start_epoch:
        say(f"resumed from epoch {start_epoch} (global step {global_step})")

    wandb_run = None
    if main_proc and cfg.get("log_with") == "wandb":
        try:
            import wandb

            wandb_run = wandb.init(project=cfg.get("project_name", "point-sam-tpu"),
                                   name=cfg.get("run_name"), config=json.loads(json.dumps(cfg)))
        except Exception as e:  # offline or not installed: the run goes on
            print(f"wandb unavailable ({e}); logging to stdout", flush=True)

    def log(metrics: dict, step: int, note: str = ""):
        if not main_proc:
            return
        if wandb_run is not None:
            wandb_run.log(metrics, step=step)
        else:
            line = " ".join(f"{k}={v:.4f}" for k, v in sorted(metrics.items()))
            print(f"[step {step}] {line}{note}", flush=True)

    max_epochs = cfg.get("max_epochs", 10000)
    max_steps = cfg.get("max_steps", 5_000_000)
    log_freq = cfg.get("log_freq", 20)
    vis_freq = cfg.get("vis_freq", 0)
    history, zero_grads, val_metrics = [], None, {}
    for epoch in range(start_epoch, max_epochs):
        t_epoch = time.perf_counter()
        for batch_np in train_iter:
            batch = to_device(batch_np, device)
            t0 = time.perf_counter()
            metrics = train_step(model, tx, batch, clicks, criterion=crit, accum_steps=accum)
            loss = float(metrics["loss"])  # waits for the step's device work
            history.append(dict(step=global_step + 1, loss=loss,
                                ms=(time.perf_counter() - t0) * 1e3))
            if zero_grads is None:
                zero_grads = zero_grad_names(model)
            global_step += 1
            if global_step % log_freq == 0:
                host = {k: float(v) for k, v in metrics.items()}
                host["lr"] = float(sched(global_step))
                log({f"train/{k}": v for k, v in host.items()}, global_step,
                    f" ({history[-1]['ms']:.1f} ms)")
            if global_step >= max_steps:
                break
        say(f"epoch {epoch} done in {time.perf_counter() - t_epoch:.1f}s "
            f"(step {global_step})")
        # Under DDP every rank evaluates its own replica (no collective);
        # under FSDP the sharded model's forwards are collectives, so every
        # rank runs them, and rank 0 alone writes the dump.
        evaluated = model if sharding == "fsdp" else net
        if val_iter is not None and (epoch + 1) % cfg.val_freq == 0:
            val_metrics = validate(evaluated, val_iter, device)
            log({f"val/{k}": v for k, v in val_metrics.items()}, global_step)
            if vis_freq and (epoch + 1) % vis_freq == 0 and (main_proc or sharding == "fsdp"):
                dump_visualizations(evaluated, val_iter,
                                    project_dir / "vis" / f"ep{epoch + 1}",
                                    wandb_run=wandb_run, step=global_step, write=main_proc)
        if (epoch + 1) % cfg.get("save_freq", 5) == 0 or global_step >= max_steps:
            if distributed:
                state = gather_train_state(model, tx)
                if main_proc:
                    ckpt.save(epoch + 1, dict(state, step=global_step))
                del state
            else:
                ckpt.save(epoch + 1, {"model": model.state_dict(),
                                      "optimizer": tx.state_dict(), "step": global_step})
        if global_step >= max_steps:
            break
    if wandb_run is not None:
        wandb_run.finish()
    if len(history) > 1:
        say(f"train step: median {statistics.median(h['ms'] for h in history[1:]):.1f} ms "
            f"over steps 2..{len(history)}")
    if owns_group:
        D.shutdown()
    return dict(model=model, optimizer=tx, step=global_step, history=history,
                first_step_zero_grads=zero_grads or [], val=val_metrics, rank=rank,
                world=world)


def load_pretrained(path, model) -> dict:
    """Pretrained initialisation (counterpart of JAX ``_load_pretrained``;
    reference train.py:101-121): a reference ``.safetensors`` checkpoint
    loaded non-strict through the key triage, or a Uni3D encoder file
    (``torch.save`` of ``{"module": {"point_encoder.*": ...}}`` or of the
    bare dict) through ``convert_uni3d``. Returns the load's report."""
    from ..utils.convert import convert_uni3d, load_torch_safetensors

    if str(path).endswith(".safetensors"):
        return load_torch_safetensors(path, model, strict=False)
    sd = torch.load(path, map_location="cpu", weights_only=True)
    module = sd.get("module", sd)
    report = convert_uni3d({"module": module}, model)
    if is_main_process():
        print(f"uni3d init: mapped {len(module) - len(report['unmapped'])} tensors "
              f"({len(report['unmapped'])} non-encoder keys ignored)", flush=True)
    return report


@torch.no_grad()
def dump_visualizations(model, val_iter, out_dir, max_samples: int = 4, wandb_run=None,
                        step=None, write: bool = True) -> None:
    """Write ``sample{i}_pred.ply`` (the last click's mask blended red) and
    ``sample{i}_prompts.ply`` (points near the clicks green / red) for the
    first ``max_samples`` masks of the first validation batch, run through
    the evaluation clicks where the model lives; when a wandb run is live,
    also log the same clouds as ``wandb.Object3D`` panels (reference
    train.py:314-327,360-382). The PLY dump is always written, unless
    ``write`` is False: then only the forward runs (an FSDP rank other
    than 0 takes part in the forward's collectives)."""
    from ..utils import ply

    batch = next(iter(val_iter))
    model.eval()
    b = to_device(batch, next(model.parameters()).device)
    last = model(b["coords"], b["features"], b["gt_masks"], is_eval=True,
                 generator=torch.Generator().manual_seed(0))[-1]
    if not write:
        return
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    last = {k: v.float().cpu().numpy() for k, v in last.items()
            if k in ("prompt_coords", "prompt_labels", "prompt_masks")}
    # fp32 as the JAX package's device arrays hold them.
    xyz = np.asarray(batch["coords"], np.float32)
    feats = np.asarray(batch["features"], np.float32)
    M = batch["gt_masks"].shape[1]
    panels = {}
    for i in range(min(max_samples, len(last["prompt_masks"]))):
        s = i // M
        rgb = np.clip((feats[s, :, :3] * 0.5 + 0.5) * 255, 0, 255)
        pred_rgb = ply.mask_colors(xyz[s], last["prompt_masks"][i] > 0, rgb)
        prompt_rgb = ply.prompt_colors(xyz[s], last["prompt_coords"][i],
                                       last["prompt_labels"][i] > 0, rgb)
        ply.save_ply(out_dir / f"sample{i}_pred.ply", xyz[s], pred_rgb)
        ply.save_ply(out_dir / f"sample{i}_prompts.ply", xyz[s], prompt_rgb)
        if wandb_run is not None:
            import wandb

            panels[f"val/sample{i}_pred"] = wandb.Object3D(np.concatenate([xyz[s], pred_rgb], 1))
            panels[f"val/sample{i}_prompts"] = wandb.Object3D(
                np.concatenate([xyz[s], prompt_rgb], 1))
    if panels:
        wandb_run.log(panels, step=step)


@torch.no_grad()
def validate(model, val_iter, device) -> dict:
    """IoU per click (``iou(i)``) and the best-of-multimask IoU of the first
    click, averaged over the validation masks (evaluation clicks: every
    iteration adds one). The random click sampler (hier model) draws from
    a generator seeded here with a constant, so a validation repeats; the
    fixed sampler draws nothing."""
    from ..models.loss import compute_iou

    model.eval()
    clicks = torch.Generator().manual_seed(0)
    agg = defaultdict(list)
    for batch_np in val_iter:
        b = to_device(batch_np, device)
        outputs = model(b["coords"], b["features"], b["gt_masks"], is_eval=True,
                        generator=clicks)
        gt = b["gt_masks"].reshape(-1, b["gt_masks"].shape[-1])
        for i, out in enumerate(outputs):
            if i == 0:
                best = torch.take_along_dim(out["masks"], out["max_iou_pred_ind"][:, None, None],
                                            dim=1)[:, 0]
                multi = compute_iou(out["masks"], gt[:, None, :])
                agg["best_multimask_iou"].append(multi.amax(1).float().cpu())
            else:
                best = out["masks"][:, 0]
            agg[f"iou({i})"].append(compute_iou(best, gt).float().cpu())
    return {k: float(torch.cat(v).mean()) for k, v in agg.items()}


if __name__ == "__main__":
    main()
