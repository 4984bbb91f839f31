"""The training step on one device (counterpart of
point_sam_tpu/parallel/train_step.py without its mesh, FSDP and TP
branches): forward with simulated clicks, criterion, backward with in-step
gradient accumulation, clip-by-value, AdamW, schedule.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..models.loss import criterion as default_criterion


class ClippedAdamW:
    """Clip every gradient to [-max_grad_value, max_grad_value], then an
    AdamW step at the schedule's rate for the current update count (the
    optax chain ``clip`` -> ``adamw``; torch's decoupled weight decay is
    optax's, and like optax the first update uses the rate at count 0)."""

    def __init__(self, params, lr_schedule: Callable[[int], float], *,
                 weight_decay: float = 0.1, max_grad_value: float = 1.0,
                 b1: float = 0.9, b2: float = 0.999):
        self.params = [p for p in params if p.requires_grad]
        self.max_grad_value = max_grad_value
        self.lr_schedule = lr_schedule
        self.opt = torch.optim.AdamW(self.params, lr=lr_schedule(0), betas=(b1, b2),
                                     eps=1e-8, weight_decay=weight_decay)
        self.count = 0

    def zero_grad(self):
        self.opt.zero_grad(set_to_none=True)

    def step(self):
        torch.nn.utils.clip_grad_value_(self.params, self.max_grad_value)
        for group in self.opt.param_groups:
            group["lr"] = self.lr_schedule(self.count)
        self.opt.step()
        self.count += 1

    def state_dict(self) -> dict:
        return {"opt": self.opt.state_dict(), "count": self.count}

    def load_state_dict(self, state: dict):
        self.opt.load_state_dict(state["opt"])
        self.count = state["count"]


def make_optimizer(params, lr_schedule: Callable[[int], float], weight_decay: float = 0.1,
                   max_grad_value: float = 1.0, b1: float = 0.9,
                   b2: float = 0.999) -> ClippedAdamW:
    """AdamW + clip-by-value, the reference recipe."""
    return ClippedAdamW(params, lr_schedule, weight_decay=weight_decay,
                        max_grad_value=max_grad_value, b1=b1, b2=b2)


def _metrics_from_aux(aux, gt_flat) -> dict:
    """Scalar metrics of the first and last click iterations."""
    metrics = {}
    for tag, i in (("first", 0), ("last", len(aux) - 1)):
        pred = aux[i]["best_masks"] > 0
        gt = gt_flat
        fg = gt.sum(-1).clamp_min(1)
        bg = (~gt).sum(-1).clamp_min(1)
        metrics[f"{tag}/acc"] = (pred == gt).float().mean()
        metrics[f"{tag}/fg_acc"] = ((pred & gt).sum(-1) / fg).mean()
        metrics[f"{tag}/bg_acc"] = ((~pred & ~gt).sum(-1) / bg).mean()
        metrics[f"{tag}/iou"] = aux[i]["iou"].float().mean()
        metrics[f"{tag}/loss_mask"] = aux[i]["loss_mask"]
        metrics[f"{tag}/loss_iou"] = aux[i]["loss_iou"]
    return metrics


def train_step(model, tx: ClippedAdamW, batch: dict, generator: torch.Generator, *,
               criterion: Callable = default_criterion, accum_steps: int = 1) -> dict:
    """One optimizer step over ``batch`` (coords [B, N, 3], features
    [B, N, C], gt_masks [B, M, N] on the model's device), split into
    ``accum_steps`` micro-batches whose gradients are averaged.

    Returns the detached metrics (tensors), averaged over micro-batches,
    with the loss under "loss".
    """
    B = batch["coords"].shape[0]
    if B % accum_steps:
        raise ValueError(f"batch {B} is not divisible by accum_steps {accum_steps}")
    mb = B // accum_steps
    model.train()
    tx.zero_grad()
    total: dict = {}
    for a in range(accum_steps):
        part = {k: v[a * mb:(a + 1) * mb] for k, v in batch.items()}
        outputs = model(part["coords"], part["features"], part["gt_masks"],
                        generator=generator)
        gt_flat = part["gt_masks"].reshape(-1, part["gt_masks"].shape[-1])
        loss, aux = criterion(outputs, gt_flat)
        (loss / accum_steps).backward()
        metrics = dict(_metrics_from_aux(aux, gt_flat), loss=loss)
        for k, v in metrics.items():
            total[k] = total.get(k, 0.0) + v.detach() / accum_steps
    tx.step()
    return total
