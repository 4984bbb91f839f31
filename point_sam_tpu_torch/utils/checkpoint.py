"""Keep-k training checkpoints with torch.save (the counterpart of the JAX
trainer's orbax ``CheckpointManager(max_to_keep=1)``).

A checkpoint is one file ``<dir>/ckpt_<epoch>.pt`` holding a dict (model,
optimizer with its schedule count, global step). It is written to a
temporary name and renamed, so a reader never sees half a file; after a
save only the newest ``max_to_keep`` files remain.
"""

from __future__ import annotations

import os
import re
from pathlib import Path

import torch

_NAME = re.compile(r"^ckpt_(\d+)\.pt$")


class CheckpointManager:
    def __init__(self, directory, max_to_keep: int = 1):
        self.dir = Path(directory)
        self.max_to_keep = max_to_keep
        self.dir.mkdir(parents=True, exist_ok=True)

    def steps(self) -> list[int]:
        return sorted(int(m.group(1)) for f in self.dir.iterdir() if (m := _NAME.match(f.name)))

    def latest_step(self) -> int | None:
        steps = self.steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: dict) -> Path:
        path = self.dir / f"ckpt_{step}.pt"
        tmp = self.dir / f".ckpt_{step}.{os.getpid()}.tmp"
        torch.save(state, tmp)
        os.replace(tmp, path)
        for old in self.steps()[:-self.max_to_keep]:
            (self.dir / f"ckpt_{old}.pt").unlink()
        return path

    def restore(self, step: int, map_location=None) -> dict:
        return torch.load(self.dir / f"ckpt_{step}.pt", map_location=map_location,
                          weights_only=True)
