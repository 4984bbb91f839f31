"""What every comparison that decides ``correct`` shares: the gap of two
tensors, the share of entries that differ, and the verdict of numbers
against their limits. Each loop (``psam_bench/loops/<loop>.py``) works out
its own numbers from the program's outputs and the plain reference's."""

from __future__ import annotations

import torch


def rel(a: torch.Tensor, b: torch.Tensor) -> float:
    """||a - b|| / ||b|| in fp64."""
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def share_differ(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.long().reshape(-1), b.long().reshape(-1)
    return float((a != b).double().mean())


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(every limited number within its limit, {name: {value, limit}} of
    the numbers compared). A limit with no number, or no limit at all, is
    not correct; a number without a limit is a reading, not compared."""
    shown = {k: {"value": numbers.get(k), "limit": v} for k, v in sorted(limits.items())}
    ok = bool(shown) and all(v["value"] is not None and v["value"] <= v["limit"]
                             for v in shown.values())
    return ok, shown
