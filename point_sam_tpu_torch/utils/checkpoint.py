"""Keep-k training checkpoints with torch.save (the counterpart of the JAX
trainer's orbax ``CheckpointManager(max_to_keep=1)``), and the one weight
loader of every entry point, ``load_weights`` (counterpart of JAX's
``utils/checkpoint.py::load_variables``).

A checkpoint is one file ``<dir>/ckpt_<epoch>.pt`` holding a dict (model,
optimizer with its schedule count, global step). It is written to a
temporary name and renamed, so a reader never sees half a file; after a
save only the newest ``max_to_keep`` files remain.

Under DDP or FSDP, ``gather_train_state`` assembles the full model and
optimizer state on rank 0's host (``get_state_dict``) in that same layout,
which rank 0 writes; ``load_train_state`` scatters such a state from rank 0
to every rank's replica or shard (``set_model_state_dict`` and
``set_optimizer_state_dict``). A checkpoint so
written resumes at any world size, and in a one-process run.
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


def _param_names(model) -> list[str]:
    """The names of the parameters an optimizer over ``model.parameters()``
    holds, in its order (the indices of a torch optimizer's state dict)."""
    from ..parallel.train_step import unwrap

    return [n for n, p in unwrap(model).named_parameters() if p.requires_grad]


def gather_train_state(model, tx) -> dict:
    """The full model and optimizer state of a DDP or FSDP run, a
    collective: on rank 0 ``{"model": ..., "optimizer": {"opt": ...,
    "count": ...}}`` on the host, the layout ``ClippedAdamW.state_dict``
    and a one-process trainer write; ``{}`` on the other ranks."""
    import torch.distributed as dist
    from torch.distributed.checkpoint.state_dict import StateDictOptions, get_state_dict

    msd, osd = get_state_dict(model, tx.opt,
                              options=StateDictOptions(full_state_dict=True, cpu_offload=True))
    if dist.get_rank() != 0:
        return {}
    index = {n: i for i, n in enumerate(_param_names(model))}
    opt = {"state": {index[n]: v for n, v in osd["state"].items()},
           "param_groups": [dict(g, params=[index[n] for n in g["params"]])
                            for g in osd["param_groups"]]}
    return {"model": msd, "optimizer": {"opt": opt, "count": tx.count}}


def load_train_state(model, tx, state: dict) -> None:
    """Load ``state`` (rank 0's, in ``gather_train_state``'s layout; the
    other ranks may pass ``{}``) into every rank's model and optimizer, a
    collective: rank 0 broadcasts each tensor and each rank keeps its
    replica or shard. The schedule count is broadcast too."""
    import torch.distributed as dist
    from torch.distributed.checkpoint.state_dict import (
        StateDictOptions,
        set_model_state_dict,
        set_optimizer_state_dict,
    )

    msd, osd, count = {}, {}, [None]
    if dist.get_rank() == 0:
        names = _param_names(model)
        opt = state["optimizer"]["opt"]
        msd = state["model"]
        osd = {"state": {names[i]: v for i, v in opt["state"].items()},
               "param_groups": [dict(g, params=[names[i] for i in g["params"]])
                                for g in opt["param_groups"]]}
        count = [state["optimizer"]["count"]]
    # Model and optimizer apart: set_state_dict would skip the model on a
    # rank whose (empty) model state dict marks the call optimizer-only.
    options = StateDictOptions(full_state_dict=True, broadcast_from_rank0=True)
    set_model_state_dict(model, msd, options=options)
    set_optimizer_state_dict(model, tx.opt, osd, options=options)
    dist.broadcast_object_list(count, src=0)
    tx.count = count[0]
