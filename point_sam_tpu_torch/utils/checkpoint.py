"""Keep-k training checkpoints with torch.save (the counterpart of the JAX
trainer's orbax ``CheckpointManager(max_to_keep=1)``), and the one weight
loader of every entry point, ``load_weights`` (counterpart of JAX's
``utils/checkpoint.py::load_variables``).

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


def load_weights(path, model) -> dict:
    """Load weights from ``path`` into ``model`` (its parameters keep their
    dtypes and device). ``path`` is one of:

    - a reference ``.safetensors`` file: loaded non-strict through the key
      triage (``utils.convert.load_torch_safetensors``), with a warning line
      for unmapped torch keys and one for unfilled model keys;
    - a trainer checkpoint directory (``CheckpointManager``): its latest
      ``ckpt_<epoch>.pt``, the ``"model"`` entry, loaded strictly;
    - any other file: a ``torch.save`` state dict with the reference's key
      names, loaded strictly.

    Returns the load's report (``utils.convert.load_reference_state_dict``'s
    fields; a strict load maps every key).
    """
    p = Path(path)
    if p.is_file() and p.suffix == ".safetensors":
        from .convert import load_torch_safetensors

        report = load_torch_safetensors(p, model, strict=False)
        if report["unmapped"]:
            print(f"warning: {len(report['unmapped'])} unmapped torch keys "
                  f"(first: {report['unmapped'][:3]})")
        if report["unfilled"]:
            print(f"warning: {len(report['unfilled'])} unfilled params "
                  f"(first: {report['unfilled'][:3]})")
        return report
    device = next(model.parameters()).device
    if p.is_dir():
        mgr = CheckpointManager(p)
        step = mgr.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {p}")
        state = mgr.restore(step, map_location=device)["model"]
    elif p.is_file():
        state = torch.load(p, map_location=device, weights_only=True)
    else:
        raise FileNotFoundError(path)
    model.load_state_dict(state, strict=True)
    return dict(mapped=len(state), unmapped=[], recognized_unused=[], variant_unsupported=[],
                unfilled=[])
