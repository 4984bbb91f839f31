"""Training entry point of the PyTorch port (counterpart of
point_sam_tpu/train/trainer.py, one device):

    python -m point_sam_tpu_torch.train.trainer --config large \
        train_dataset.dataset.source=synthetic val_freq=0 max_steps=N
    python -m point_sam_tpu_torch.train.trainer --config tiny --device cpu

config -> model -> data -> the train loop of ``parallel.train_step``
(simulated-click forward, criterion, backward, clip-by-value, AdamW,
warmup-multistep schedule), keep-1 checkpoints with resume, and IoU-per-click
validation. It runs on ``cuda`` unless ``--device`` names another device,
and raises without a card rather than falling back to the CPU. TF32 stays
off for matmuls (set when the package is imported). Model parameters are
fp32; the compute dtype is bf16 on a CUDA device and fp32 elsewhere.

Not ported yet (ROADMAP.md): pretrained initialisation
(``pretrained_ckpt_path``), wandb logging and the visualisation dump,
multi-process / FSDP / TP training.
"""

from __future__ import annotations

import argparse
import statistics
import time
from collections import defaultdict
from functools import partial
from pathlib import Path

import numpy as np
import torch


def resolve_device(device: str | None) -> torch.device:
    """``cuda`` unless another device is named; no silent CPU fallback."""
    dev = torch.device(device or "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to train on the CPU")
    return dev


def to_device(batch: dict, device) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in batch.items()}


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
    if cfg.get("pretrained_ckpt_path"):
        raise NotImplementedError("pretrained initialisation is not ported yet (ROADMAP.md)")

    model = build_model(cfg.model, device=device,
                        generator=torch.Generator(device).manual_seed(seed))
    print(f"model: {type(model).__name__} ({cfg.model.get('vit')}) on {device}, "
          f"compute {model.dtype}, params "
          f"{sum(p.numel() for p in model.parameters()) / 1e6:.1f}M", flush=True)

    ctx = {"num_samples": cfg.get("num_samples")}
    train_iter = BatchIterator(
        build_dataset(cfg.train_dataset, seed=seed, context=ctx),
        cfg.train_dataloader.batch_size,
        shuffle=cfg.train_dataloader.get("shuffle", True),
        drop_last=cfg.train_dataloader.get("drop_last", True), seed=seed)
    val_iter = None
    if cfg.get("val_freq", 0) > 0:
        val_iter = BatchIterator(build_dataset(cfg.val_dataset, seed=seed + 1, context=ctx),
                                 cfg.val_dataloader.batch_size, shuffle=False,
                                 drop_last=False, seed=seed)

    sched = warmup_multistep(cfg.lr, cfg.scheduler.milestones,
                             gamma=cfg.scheduler.get("gamma", 0.1),
                             warmup_factor=cfg.scheduler.get("warmup_factor", 0.001),
                             warmup_iters=cfg.scheduler.get("warmup_iters", 1000))
    tx = make_optimizer(model.parameters(), sched, weight_decay=cfg.get("weight_decay", 0.1),
                        max_grad_value=cfg.get("max_grad_value", 1.0))
    loss_cfg = cfg.get("loss", {}) or {}
    crit = partial(criterion, use_soft_iou=loss_cfg.get("use_soft_iou", False))
    accum = cfg.get("gradient_accumulation_steps", 1)

    ckpt = CheckpointManager(Path(cfg.get("project_dir", "./logs/run")) / "checkpoints")
    start_epoch, global_step = 0, 0
    latest = ckpt.latest_step()
    if latest is not None:
        state = ckpt.restore(latest, map_location=device)
        model.load_state_dict(state["model"])
        tx.load_state_dict(state["optimizer"])
        global_step, start_epoch = state["step"], latest
        print(f"resumed from epoch {latest} (global step {global_step})", flush=True)
    if cfg.get("log_with") == "wandb":
        print("wandb logging is not ported yet; logging to stdout", flush=True)

    # Draws the refinement-only click iteration of each step (host side).
    clicks = torch.Generator().manual_seed(seed + 2)
    max_epochs = cfg.get("max_epochs", 10000)
    max_steps = cfg.get("max_steps", 5_000_000)
    log_freq = cfg.get("log_freq", 20)
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
            if global_step % log_freq == 0 or global_step == 1:
                line = " ".join(f"{k}={float(v):.4f}" for k, v in sorted(metrics.items()))
                print(f"[step {global_step}] lr={sched(global_step):.3g} {line} "
                      f"({history[-1]['ms']:.1f} ms)", flush=True)
            if global_step >= max_steps:
                break
        print(f"epoch {epoch} done in {time.perf_counter() - t_epoch:.1f}s "
              f"(step {global_step})", flush=True)
        if val_iter is not None and (epoch + 1) % cfg.val_freq == 0:
            val_metrics = validate(model, val_iter, device)
            print("[val] " + " ".join(f"{k}={v:.4f}" for k, v in sorted(val_metrics.items())),
                  flush=True)
        if (epoch + 1) % cfg.get("save_freq", 5) == 0 or global_step >= max_steps:
            ckpt.save(epoch + 1, {"model": model.state_dict(), "optimizer": tx.state_dict(),
                                  "step": global_step})
        if global_step >= max_steps:
            break
    if len(history) > 1:
        print(f"train step: median {statistics.median(h['ms'] for h in history[1:]):.1f} ms "
              f"over steps 2..{len(history)}", flush=True)
    return dict(model=model, optimizer=tx, step=global_step, history=history,
                first_step_zero_grads=zero_grads or [], val=val_metrics)


@torch.no_grad()
def validate(model, val_iter, device) -> dict:
    """IoU per click (``iou(i)``) and the best-of-multimask IoU of the first
    click, averaged over the validation masks (evaluation clicks: every
    iteration adds one)."""
    from ..models.loss import compute_iou

    model.eval()
    agg = defaultdict(list)
    for batch_np in val_iter:
        b = to_device(batch_np, device)
        outputs = model(b["coords"], b["features"], b["gt_masks"], is_eval=True)
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
