"""Parameter and optimizer-state sharding over the ranks (FSDP2), the
counterpart of point_sam_tpu/parallel/fsdp.py.

The reference trains with DDP only (train.py:163-176): fine for ViT-L, but
the EVA-giant's fp32 parameters and AdamW moments are the bulk of a card's
memory. ``shard_model`` puts each ViT block under ``fully_shard`` (a unit
of its own: all-gathered for its forward, freed after it, gathered again
for its backward and for a recompute under remat), then the root, which
holds the rest: the tokenizer's patch encoder, the prompt encoders and the
mask decoder. The root's parameters are gathered once a forward and stay
gathered until its backward is done (FSDP2 does not reshard the root after
the forward), so the kernels that read weights directly (K2 / K7 through
``PatchEncoder.fused_params``, K4 / K11 through ``tail_params``) always get
plain unsharded tensors, in every iteration of the click loop.

Sharded from birth: the model is built on the host and pretrained weights
are applied there (``train.trainer``); ``fully_shard`` moves one unit at a
time to the card and keeps this rank's shard, so the card never holds the
full model. AdamW is created after sharding, so its moments are sharded
like the parameters. Parameters stay fp32 (no mixed-precision policy), as
on one device.

Each parameter is split along its largest axis that divides by the world
size (the first of equal ones), else along axis 0 with padding: the
choice of JAX's ``_leaf_spec``, but every leaf is sharded (JAX keeps
leaves under 2**14 elements whole).
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def shard_dim(shape, world: int) -> int:
    """The axis a parameter of ``shape`` is split along."""
    best = None
    for i, s in enumerate(shape):
        if s % world == 0 and (best is None or s > shape[best]):
            best = i
    return 0 if best is None else best


def shard_model(model: torch.nn.Module, device) -> torch.nn.Module:
    """Apply ``fully_shard`` to each ViT block of ``model``, then to the
    root, over all ranks of the default group on ``device``'s type.
    Returns ``model`` (FSDP2 shards in place)."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.fsdp import fully_shard
    from torch.distributed.tensor import Shard

    from ..models.vit import EvaBlock

    world = dist.get_world_size()
    mesh = init_device_mesh(torch.device(device).type, (world,))

    def place(param):
        return Shard(shard_dim(param.shape, world))

    for block in [m for m in model.modules() if isinstance(m, EvaBlock)]:
        fully_shard(block, mesh=mesh, shard_placement_fn=place)
    fully_shard(model, mesh=mesh, shard_placement_fn=place)
    return model
