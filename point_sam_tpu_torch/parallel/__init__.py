"""The train step and the multi-process layer of the PyTorch port: process
groups, DDP and FSDP2 train steps, point-sharded geometry (tensor
parallelism is not ported yet, ROADMAP.md)."""

from .distributed import (
    initialize,
    is_main_process,
    maybe_initialize,
    process_count,
    process_index,
    shutdown,
)
from .fsdp import shard_dim, shard_model
from .sharded_geometry import sharded_knn, sharded_min_sq_dist_to_complement
from .train_step import (
    ClippedAdamW,
    data_parallel,
    make_optimizer,
    train_step,
    unused_parameters,
    unwrap,
    wrap_ddp,
    zero_grad_names,
)

__all__ = [
    "ClippedAdamW",
    "data_parallel",
    "initialize",
    "is_main_process",
    "make_optimizer",
    "maybe_initialize",
    "process_count",
    "process_index",
    "shard_dim",
    "shard_model",
    "sharded_knn",
    "sharded_min_sq_dist_to_complement",
    "shutdown",
    "train_step",
    "unused_parameters",
    "unwrap",
    "wrap_ddp",
    "zero_grad_names",
]
