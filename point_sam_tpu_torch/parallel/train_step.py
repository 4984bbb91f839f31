"""The training step (counterpart of point_sam_tpu/parallel/train_step.py):
forward with simulated clicks, criterion, backward with in-step gradient
accumulation, clip-by-value, AdamW, schedule.

One step serves four kinds of model:

- a plain module: one process, the whole batch;
- a ``DistributedDataParallel`` wrapper (``param_sharding: replicated``,
  ``ddp``): each rank's slice of the global batch; every micro-batch but
  the last runs under ``no_sync()``, so the gradients are all-reduced
  (averaged) once an optimizer step, as JAX's in-step ``lax.scan`` does;
- a module under FSDP2's ``fully_shard`` (``param_sharding: fsdp``,
  ``parallel.fsdp``): as DDP, the gradients reduce-scattered into each
  rank's shard after every micro-batch;
- a module split by ``parallel.tensor_parallel.shard_model`` (JAX's
  ``param_sharding="tp"`` branch over ``make_mesh_2d``):
  each data group's slice of the global batch, the same on every rank of
  a model group; after the last micro-batch every gradient is averaged
  over the data group. Within a model group the whole parameters' gradients
  already agree (Megatron's f and g), and a split one's is its slice of
  the whole gradient; the clip is by value, so a shard clips as the whole
  would.

The loss is a plain mean over masks and every rank's slice holds as many,
so the averaged gradient is the global batch's. The host draws of the
click loop (``models.pc_sam.click_draws``) and the random sampler's noise
come out as in a one-process step of the global batch: every rank replays
the draws of each global micro-batch from the same generator, and the
noise is drawn for a whole global micro-batch and sliced (``rows``).
"""

from __future__ import annotations

from contextlib import nullcontext
from typing import Callable

import torch
import torch.distributed as dist

from ..models.loss import criterion as default_criterion
from ..models.pc_sam import click_draws


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


def data_parallel(model) -> tuple[int, int, str | None]:
    """(rank, world size, kind) of a model: kind "ddp" for a
    ``DistributedDataParallel`` wrapper, "fsdp" for a module under
    ``fully_shard``, "tp" for a tensor-parallel module (its data group's
    rank and size), None for a plain module (rank 0 of 1)."""
    from torch.distributed.fsdp import FSDPModule
    from torch.nn.parallel import DistributedDataParallel

    tp = getattr(model, "tensor_parallel", None)
    if tp is not None:
        return tp.data_rank, tp.n_data, "tp"
    if isinstance(model, DistributedDataParallel):
        kind = "ddp"
    elif isinstance(model, FSDPModule):
        kind = "fsdp"
    else:
        return 0, 1, None
    return dist.get_rank(), dist.get_world_size(), kind


def unwrap(model):
    """The module a ``DistributedDataParallel`` wraps, else ``model``."""
    return model.module if data_parallel(model)[2] == "ddp" else model


def wrap_ddp(model, device, *, find_unused_parameters: bool = False):
    """``model`` (on ``device``) under ``DistributedDataParallel``: one
    rank a card (``device_ids``) on CUDA."""
    from torch.nn.parallel import DistributedDataParallel

    device = torch.device(device)
    ids = [device.index if device.index is not None else torch.cuda.current_device()] \
        if device.type == "cuda" else None
    return DistributedDataParallel(model, device_ids=ids,
                                   find_unused_parameters=find_unused_parameters)


def unused_parameters(model, batch: dict, generator: torch.Generator | None, *,
                      criterion: Callable = default_criterion) -> list[str]:
    """The names of the parameters of a plain ``model`` that get no
    gradient tensor in a forward and backward of the first cloud of
    ``batch`` (a copy of ``generator`` draws its clicks; the gradients are
    cleared after). DDP needs ``find_unused_parameters`` only when this
    is not empty."""
    part = {k: v[:1] for k, v in batch.items()}
    gen = None
    if generator is not None:
        gen = torch.Generator(generator.device)
        gen.set_state(generator.get_state())
    model.train()
    model.zero_grad(set_to_none=True)
    outputs = model(part["coords"], part["features"], part["gt_masks"], generator=gen)
    loss, _ = criterion(outputs, part["gt_masks"].reshape(-1, part["gt_masks"].shape[-1]))
    loss.backward()
    names = [n for n, p in model.named_parameters() if p.requires_grad and p.grad is None]
    model.zero_grad(set_to_none=True)
    return names


def zero_grad_names(model) -> list[str]:
    """The parameters whose gradient is missing or all zero on every rank
    (a collective under FSDP, where each rank holds a shard of each)."""
    from torch.distributed.tensor import DTensor

    named = list(unwrap(model).named_parameters())

    def local(g):
        return g.to_local() if isinstance(g, DTensor) else g

    nonzero = [p.grad is not None and bool(local(p.grad).ne(0).any()) for _, p in named]
    kind = data_parallel(model)[2]
    if kind in ("fsdp", "tp"):
        flags = torch.tensor(nonzero, dtype=torch.int32, device=local(named[0][1]).device)
        group = model.tensor_parallel.model if kind == "tp" else None
        dist.all_reduce(flags, op=dist.ReduceOp.MAX, group=group)
        nonzero = flags.bool().tolist()
    return [n for (n, _), nz in zip(named, nonzero) if not nz]


def _generator_at(like: torch.Generator, state: torch.Tensor) -> torch.Generator:
    gen = torch.Generator(like.device)
    gen.set_state(state)
    return gen


def train_step(model, tx: ClippedAdamW, batch: dict, generator: torch.Generator | None, *,
               criterion: Callable = default_criterion, accum_steps: int = 1) -> dict:
    """One optimizer step over ``batch`` (coords [B, N, 3], features
    [B, N, C], gt_masks [B, M, N] on the model's device), split into
    ``accum_steps`` micro-batches whose gradients are averaged. Under DDP
    or FSDP ``batch`` is this rank's slice of the global batch (the
    iterator's, ``BatchIterator(process_index, process_count)``), and
    micro-batch ``a`` of the global batch is rows ``[a, a + 1) * B_global
    / accum_steps``, as JAX splits it.

    Returns the detached metrics (tensors), averaged over micro-batches
    (and over ranks: the global batch's), with the loss under "loss". A
    tensor-parallel model takes its data group's slice (``rank`` and
    ``world`` are the data group's).
    """
    rank, world, kind = data_parallel(model)
    B = batch["coords"].shape[0]
    if B % accum_steps:
        raise ValueError(f"batch {B} is not divisible by accum_steps {accum_steps}")
    mb = B // accum_steps
    global_mb = B * world // accum_steps
    net = unwrap(model)
    # The generator state at the start of each global micro-batch, as a
    # one-process step over the global batch would reach it.
    starts = []
    if generator is not None:
        for _ in range(accum_steps):
            starts.append(generator.get_state())
            click_draws(net.cfg, generator, sampler=net.click_sampler)
    model.train()
    tx.zero_grad()
    total: dict = {}
    for a in range(accum_steps):
        part = {k: v[a * mb:(a + 1) * mb] for k, v in batch.items()}
        row = rank * B + a * mb  # this micro-batch's first row in the global batch
        g = row // global_mb
        gen = None if generator is None else _generator_at(generator, starts[g])
        # These rows' place in their global micro-batch (a one-process step
        # takes every micro-batch whole).
        rows = {} if global_mb == mb else {"rows": (row - g * global_mb, global_mb)}
        sync = model.no_sync() if kind == "ddp" and a < accum_steps - 1 else nullcontext()
        with sync:
            outputs = model(part["coords"], part["features"], part["gt_masks"],
                            generator=gen, **rows)
            gt_flat = part["gt_masks"].reshape(-1, part["gt_masks"].shape[-1])
            loss, aux = criterion(outputs, gt_flat)
            (loss / accum_steps).backward()
        metrics = dict(_metrics_from_aux(aux, gt_flat), loss=loss)
        for k, v in metrics.items():
            total[k] = total.get(k, 0.0) + v.detach() / accum_steps
    group = model.tensor_parallel.data if kind == "tp" else None
    if kind == "tp" and world > 1:
        _average_grads(model, group, world)
    if world > 1:
        keys = sorted(total)
        flat = torch.stack([total[k].float() for k in keys])
        dist.all_reduce(flat, group=group)
        total = dict(zip(keys, (flat / world).unbind()))
    tx.step()
    return total


def _average_grads(model, group, world: int) -> None:
    """Average every gradient over ``group`` (a tensor-parallel model's
    data group): one all-reduce over the (fp32) gradients laid end to end."""
    grads = [p.grad for p in model.parameters() if p.grad is not None]
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=group)
    flat /= world
    for g, part in zip(grads, flat.split([g.numel() for g in grads])):
        g.copy_(part.view_as(g))
