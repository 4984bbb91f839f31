"""Training entry point of the PyTorch port (counterpart of
point_sam_tpu/train/trainer.py, one device):

    python -m point_sam_tpu_torch.train.trainer --config large \
        train_dataset.dataset.source=synthetic val_freq=0 max_steps=N
    python -m point_sam_tpu_torch.train.trainer --config tiny --device cpu

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

Not ported yet (ROADMAP.md): multi-process / FSDP / TP training.
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

    from ..datasets.build import BatchIterator, build_dataset
    from ..models.loss import criterion
    from ..parallel.train_step import make_optimizer, train_step
    from ..utils.checkpoint import CheckpointManager
    from ..utils.config import build_model, load_config
    from .schedule import warmup_multistep

    device = resolve_device(args.device)
    cfg = load_config(args.config, args.overrides)
    seed = cfg.get("seed", 42)

    model = build_model(cfg.model, device=device,
                        generator=torch.Generator(device).manual_seed(seed))
    if cfg.get("pretrained_ckpt_path"):
        load_pretrained(cfg.pretrained_ckpt_path, model)
        print(f"initialized from {cfg.pretrained_ckpt_path}", flush=True)
    print(f"model: {type(model).__name__} ({cfg.model.get('vit')}) on {device}, "
          f"compute {model.dtype}, params "
          f"{sum(p.numel() for p in model.parameters()) / 1e6:.1f}M", flush=True)

    ctx = {"num_samples": cfg.get("num_samples")}
    train_iter = BatchIterator(
        build_dataset(cfg.train_dataset, seed=seed, context=ctx),
        cfg.train_dataloader.batch_size,
        shuffle=cfg.train_dataloader.get("shuffle", True),
        drop_last=cfg.train_dataloader.get("drop_last", True), seed=seed)
    # JAX's trainer initialises its model on a batch drawn from the
    # iterator's first epoch (its trainer.py:122) and so trains from the
    # second: skipping the first keeps both trainers on the same batches.
    train_iter.skip_epoch()
    val_iter = val_iterator(cfg, seed) if cfg.get("val_freq", 0) > 0 else None

    sched = warmup_multistep(cfg.lr, cfg.scheduler.milestones,
                             gamma=cfg.scheduler.get("gamma", 0.1),
                             warmup_factor=cfg.scheduler.get("warmup_factor", 0.001),
                             warmup_iters=cfg.scheduler.get("warmup_iters", 1000))
    tx = make_optimizer(model.parameters(), sched, weight_decay=cfg.get("weight_decay", 0.1),
                        max_grad_value=cfg.get("max_grad_value", 1.0))
    loss_cfg = cfg.get("loss", {}) or {}
    crit = partial(criterion, use_soft_iou=loss_cfg.get("use_soft_iou", False))
    accum = cfg.get("gradient_accumulation_steps", 1)

    project_dir = Path(cfg.get("project_dir", "./logs/run"))
    ckpt = CheckpointManager(project_dir / "checkpoints")
    start_epoch, global_step = 0, 0
    latest = ckpt.latest_step()
    if latest is not None:
        state = ckpt.restore(latest, map_location=device)
        model.load_state_dict(state["model"])
        tx.load_state_dict(state["optimizer"])
        global_step, start_epoch = state["step"], latest
        print(f"resumed from epoch {latest} (global step {global_step})", flush=True)

    wandb_run = None
    if cfg.get("log_with") == "wandb":
        try:
            import wandb

            wandb_run = wandb.init(project=cfg.get("project_name", "point-sam-tpu"),
                                   name=cfg.get("run_name"), config=json.loads(json.dumps(cfg)))
        except Exception as e:  # offline or not installed: the run goes on
            print(f"wandb unavailable ({e}); logging to stdout", flush=True)

    def log(metrics: dict, step: int, note: str = ""):
        if wandb_run is not None:
            wandb_run.log(metrics, step=step)
        else:
            line = " ".join(f"{k}={v:.4f}" for k, v in sorted(metrics.items()))
            print(f"[step {step}] {line}{note}", flush=True)

    # Draws the refinement-only click iteration of each step (host side).
    clicks = torch.Generator().manual_seed(seed + 2)
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
                zero_grads = [n for n, p in model.named_parameters()
                              if p.grad is None or not bool(p.grad.ne(0).any())]
            global_step += 1
            if global_step % log_freq == 0:
                host = {k: float(v) for k, v in metrics.items()}
                host["lr"] = float(sched(global_step))
                log({f"train/{k}": v for k, v in host.items()}, global_step,
                    f" ({history[-1]['ms']:.1f} ms)")
            if global_step >= max_steps:
                break
        print(f"epoch {epoch} done in {time.perf_counter() - t_epoch:.1f}s "
              f"(step {global_step})", flush=True)
        if val_iter is not None and (epoch + 1) % cfg.val_freq == 0:
            val_metrics = validate(model, val_iter, device)
            log({f"val/{k}": v for k, v in val_metrics.items()}, global_step)
            if vis_freq and (epoch + 1) % vis_freq == 0:
                dump_visualizations(model, val_iter, project_dir / "vis" / f"ep{epoch + 1}",
                                    wandb_run=wandb_run, step=global_step)
        if (epoch + 1) % cfg.get("save_freq", 5) == 0 or global_step >= max_steps:
            ckpt.save(epoch + 1, {"model": model.state_dict(), "optimizer": tx.state_dict(),
                                  "step": global_step})
        if global_step >= max_steps:
            break
    if wandb_run is not None:
        wandb_run.finish()
    if len(history) > 1:
        print(f"train step: median {statistics.median(h['ms'] for h in history[1:]):.1f} ms "
              f"over steps 2..{len(history)}", flush=True)
    return dict(model=model, optimizer=tx, step=global_step, history=history,
                first_step_zero_grads=zero_grads or [], val=val_metrics)


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
    print(f"uni3d init: mapped {len(module) - len(report['unmapped'])} tensors "
          f"({len(report['unmapped'])} non-encoder keys ignored)", flush=True)
    return report


@torch.no_grad()
def dump_visualizations(model, val_iter, out_dir, max_samples: int = 4, wandb_run=None,
                        step=None) -> None:
    """Write ``sample{i}_pred.ply`` (the last click's mask blended red) and
    ``sample{i}_prompts.ply`` (points near the clicks green / red) for the
    first ``max_samples`` masks of the first validation batch, run through
    the evaluation clicks where the model lives; when a wandb run is live,
    also log the same clouds as ``wandb.Object3D`` panels (reference
    train.py:314-327,360-382). The PLY dump is always written."""
    from ..utils import ply

    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    batch = next(iter(val_iter))
    model.eval()
    b = to_device(batch, next(model.parameters()).device)
    last = model(b["coords"], b["features"], b["gt_masks"], is_eval=True,
                 generator=torch.Generator().manual_seed(0))[-1]
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
