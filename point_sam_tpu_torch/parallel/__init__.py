"""The train step and the multi-process layer of the PyTorch port: process
groups, DDP, FSDP2 and tensor-parallel train steps, point-sharded geometry.

``shard_model`` is FSDP2's (``parallel.fsdp``); the tensor-parallel one is
``tp_shard_model`` here (``parallel.tensor_parallel.shard_model``)."""

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
from .tensor_parallel import TPGroups, tp_gather_state_dict, tp_groups, tp_plan
from .tensor_parallel import shard_model as tp_shard_model
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
    "TPGroups",
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
    "tp_gather_state_dict",
    "tp_groups",
    "tp_plan",
    "tp_shard_model",
    "train_step",
    "unused_parameters",
    "unwrap",
    "wrap_ddp",
    "zero_grad_names",
]
