"""The multi-process runtime of the port over ``torch.distributed``
(counterpart of point_sam_tpu/parallel/distributed.py).

The reference trains one process per GPU under ``accelerate launch`` with
NCCL DDP (reference train.py:163-176). Here the same duties are:

- ``initialize()`` joins a process group: NCCL when the run's device is
  CUDA (each process on ``cuda:{LOCAL_RANK}``), gloo on the CPU. A CUDA
  run never drops to gloo unless the caller names it;
- ``maybe_initialize(cfg)`` reads the run config's ``distributed:``
  section, the one the JAX trainer reads, or torchrun's environment;
- per-rank batches: ``datasets.build.BatchIterator(process_index,
  process_count)`` gives each rank its slice of every global batch;
- ``is_main_process()`` gates printing, logging and checkpoint writes.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

# torchrun's rendezvous variables (env://).
TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")

def backend_for(device) -> str:
    """The process group backend of a run on ``device``."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def initialize(init_method: str | None = None, world_size: int | None = None,
               rank: int | None = None, *, device=None, backend: str | None = None,
               ) -> torch.device:
    """Join (or create) the default process group; returns the run's device.

    Args:
        init_method: ``tcp://host:port``, or None for torchrun's ``env://``
            (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT).
        world_size, rank: with a ``tcp://`` init method.
        device: "cuda" (default) or "cpu". A CUDA device without an index
            becomes ``cuda:{LOCAL_RANK}`` (else ``cuda:{rank % cards}``)
            and the current device; one with an index is taken as given.
        backend: the group's backend, by default ``backend_for(device)``
            (NCCL on CUDA, gloo on the CPU). Naming another one is the only
            way a CUDA run gets gloo.

    A second call is a no-op that returns the run's device; it raises if
    the existing group's backend is not the one this call asks for.
    """
    dev = torch.device(device or "cuda")
    want = backend or backend_for(dev)
    if dist.is_initialized():
        have = dist.get_backend()
        if have != want:
            raise RuntimeError(f"a {have} process group exists; this run asks for {want}")
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        return dev
    if init_method is None:
        missing = [v for v in TORCHRUN_ENV if v not in os.environ]
        if missing:
            raise RuntimeError(f"env:// initialisation needs {missing} (launch with torchrun)")
        init_method = "env://"
        rank = int(os.environ["RANK"]) if rank is None else rank
        world_size = int(os.environ["WORLD_SIZE"]) if world_size is None else world_size
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: a distributed run on the CPU needs device='cpu'")
        if dev.index is None:
            dev = torch.device("cuda", int(os.environ.get(
                "LOCAL_RANK", rank % torch.cuda.device_count())))
        torch.cuda.set_device(dev)
    kwargs = dict(device_id=dev) if want == "nccl" else {}
    dist.init_process_group(want, init_method=init_method, world_size=world_size, rank=rank,
                            **kwargs)
    return dev


def maybe_initialize(cfg, device=None) -> bool:
    """Config- or environment-driven ``initialize`` for the trainer.

    Triggers on a ``distributed`` section in ``cfg`` --
    ``{coordinator_address: host:port, num_processes, process_id}`` (a
    ``tcp://`` rendezvous) or ``auto`` (torchrun's ``env://``) -- or, with
    no section, on torchrun's variables in the environment. Returns True
    when this call created the process group; False when there is nothing
    to join or the group already exists (then it only checks its backend).
    """
    section = cfg.get("distributed") if hasattr(cfg, "get") else None
    from_env = all(v in os.environ for v in TORCHRUN_ENV)
    if not section and not from_env:
        return False
    existed = dist.is_initialized()
    if section and section != "auto":
        initialize(f"tcp://{section['coordinator_address']}", int(section["num_processes"]),
                   int(section["process_id"]), device=device)
    else:
        initialize(device=device)
    return not existed


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_main_process() -> bool:
    return process_index() == 0


def shutdown() -> None:
    """Wait for every rank, then leave and destroy the process group."""
    if not dist.is_initialized():
        return
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()
    dist.destroy_process_group()
