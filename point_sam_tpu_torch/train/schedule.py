"""LR schedule (counterpart of point_sam_tpu/train/schedule.py): the
reference's warmup-multistep, a linear (or constant) warmup factor times a
step decay at the milestones."""

from __future__ import annotations

from typing import Sequence


def warmup_multistep(base_lr: float, milestones: Sequence[int], gamma: float = 0.1,
                     warmup_factor: float = 0.001, warmup_iters: int = 1000,
                     warmup_method: str = "linear"):
    """Returns step -> learning rate (a plain function of the step count)."""
    if list(milestones) != sorted(milestones):
        raise ValueError(f"milestones must be increasing, got {milestones}")
    if warmup_method not in ("linear", "constant"):
        raise ValueError(f"unknown warmup method {warmup_method!r}")
    ms = list(milestones)

    def schedule(step: int) -> float:
        if warmup_method == "linear":
            alpha = min(step / max(warmup_iters, 1), 1.0)
            wf = warmup_factor * (1.0 - alpha) + alpha
        else:
            wf = warmup_factor if step < warmup_iters else 1.0
        return base_lr * wf * gamma ** sum(step >= m for m in ms)

    return schedule
