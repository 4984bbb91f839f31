"""Tensor (model) parallelism of the ViT backbone over a process group
(counterpart of point_sam_tpu/parallel/tensor_parallel.py).

Megatron's layout, block by block (``models/vit.py``), over the ranks of a
model group of size W:

- q / k / v projections (or EVA-giant's fused ``qkv``): column-parallel,
  each rank holds heads [r * H / W, (r + 1) * H / W), so attention (K3 /
  K6 at EVA02's head size 64, K5 at EVA-giant's 88) runs on the rank's
  heads with no communication; the q and v biases go with them;
- the attention's ``proj``: row-parallel (``RowParallelDense``: fp32
  partial sums, one fp32 all-reduce, the bias once, one cast);
- SwiGLU ``fc1_g`` / ``fc1_x`` (or the GELU MLP's ``fc1``):
  column-parallel over the hidden axis; ``fc2`` row-parallel; the EVA02
  sub-LN over the split hidden axis keeps the whole axis's statistics
  (``ShardedLayerNorm``: two all-reduces, fp32);
- everything else (LayerNorms over the embed axis, the patch encoder, the
  prompt encoders, the decoder, whose small transformer also has an
  ``mlp``): whole on every rank.

The collectives (``models/layers.py``) are Megatron's f (``tp_copy``: identity forward, the input
gradient all-reduced backward) at the input of each attention and MLP, and
g (``tp_reduce``: all-reduce forward, identity backward) after each
row-parallel product: ``all_reduce`` only, which gloo runs on CPU and CUDA
tensors and NCCL on one card a rank.

``tp_plan`` is JAX's ``_TP_RULES`` / ``_spec_for`` in the port's key
names, with its fallback: a leaf whose split axis W does not divide stays
whole, and so, because every leaf of an attention or an MLP splits one
axis, does its whole attention or MLP. EVA02-L's SwiGLU hidden is
int(1024 * 4 * 2 / 3) = 2730, so at W = 4 the MLPs stay whole while the
16 heads split; at W = 2 everything splits. Two placements differ from
JAX's, with the same numbers:

- the fused ``qkv.weight`` [3D, D]: JAX's rule cuts the [D, 3D] kernel's
  last axis contiguously (at W = 2 rank 0 holds all of q and half of k,
  and GSPMD reshards it); the port cuts each third by heads, rows
  [r * D / W, (r + 1) * D / W) of q, of k and of v;
- an attention whose head count W does not divide, or with
  ``attn_inner_norm``, stays whole here (GSPMD would reshard the heads or
  gather the norm's axis; a rank runs attention on whole heads only).

Usage (every rank builds the same whole model, then keeps its slices):

    groups = tp_groups(n_data, n_model)        # JAX's make_mesh_2d
    shard_model(model, groups)                 # in place
    train_step(model, tx, my_batch, gen)       # my data group's rows
    tp_gather_state_dict(model)                # one process's layout
"""

from __future__ import annotations

import dataclasses
import re

import torch
import torch.distributed as dist
from torch import nn

from ..models.layers import RowParallelDense, ShardedLayerNorm

# (key suffix within a ViT block, mode): "col" splits a weight's output
# features (dim 0 of [out, in]), "row" its input features (dim 1), "vec" a
# vector's only axis. JAX's _TP_RULES, key for key.
_TP_RULES: tuple[tuple[str, str], ...] = (
    ("attn.q_proj.weight", "col"),
    ("attn.k_proj.weight", "col"),
    ("attn.v_proj.weight", "col"),
    ("attn.qkv.weight", "col"),
    ("attn.q_proj.bias", "vec"),
    ("attn.v_proj.bias", "vec"),
    ("attn.q_bias", "vec"),  # JAX's attn/qkv/bias, whose k third is zero
    ("attn.v_bias", "vec"),
    ("attn.proj.weight", "row"),
    ("mlp.fc1_g.weight", "col"),
    ("mlp.fc1_x.weight", "col"),
    ("mlp.fc1.weight", "col"),
    ("mlp.fc1_g.bias", "vec"),
    ("mlp.fc1_x.bias", "vec"),
    ("mlp.fc1.bias", "vec"),
    ("mlp.norm.weight", "vec"),
    ("mlp.norm.bias", "vec"),
    ("mlp.fc2.weight", "row"),
)
_RULES = dict(_TP_RULES)
_BLOCK = re.compile(r"(pc_encoder\.transformer\.blocks\.\d+)\.(.+)$")
_DIM = {"col": 0, "row": 1, "vec": 0}


@dataclasses.dataclass(frozen=True)
class TPGroups:
    """This rank's groups of a (data, model) grid of the world, JAX's
    ``make_mesh_2d(n_data, n_model)``: rank = d * n_model + m; the model
    group holds the ranks of one d, the data group those of one m."""

    data: object
    model: object
    n_data: int
    n_model: int
    data_rank: int
    model_rank: int


def tp_groups(n_data: int, n_model: int) -> TPGroups:
    """Split the default group into data x model groups (every rank calls
    this, in the same order, as ``dist.new_group`` asks)."""
    world, rank = dist.get_world_size(), dist.get_rank()
    if n_data * n_model != world:
        raise ValueError(f"a {n_data} x {n_model} grid needs {n_data * n_model} ranks, "
                         f"have {world}")
    data = model = None
    for d in range(n_data):
        ranks = [d * n_model + m for m in range(n_model)]
        g = dist.new_group(ranks)
        if rank in ranks:
            model = g
    for m in range(n_model):
        ranks = [d * n_model + m for d in range(n_data)]
        g = dist.new_group(ranks)
        if rank in ranks:
            data = g
    return TPGroups(data, model, n_data, n_model, rank // n_model, rank % n_model)


def _split_axis(key: str, shape, mode: str) -> int:
    """The length of the axis ``mode`` splits (a fused qkv weight: a third's)."""
    n = shape[_DIM[mode]]
    return n // 3 if key.endswith("attn.qkv.weight") else n


def tp_plan(model: nn.Module, n_model: int) -> dict[str, str | None]:
    """For every state-dict key of ``model``: "col", "row", "vec", or None
    (whole on every rank), at a model group of ``n_model`` ranks. Only the
    ViT's blocks (``pc_encoder.transformer.blocks.*``) are split; a block's
    attention or MLP is split only where ``n_model`` divides every axis it
    splits (and, for attention, its head count, without
    ``attn_inner_norm``). ``model`` may live on the ``meta`` device."""
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    plan = dict.fromkeys(shapes)
    vit = model.pc_encoder.transformer
    heads_ok = vit.cfg.num_heads % n_model == 0 and not vit.cfg.attn_inner_norm
    parts: dict[tuple[str, str], list[str]] = {}
    for key in shapes:
        m = _BLOCK.match(key)
        if m and m.group(2) in _RULES:
            parts.setdefault((m.group(1), m.group(2).split(".")[0]), []).append(key)
    for (_, part), keys in parts.items():
        modes = {k: _RULES[_BLOCK.match(k).group(2)] for k in keys}
        ok = all(_split_axis(k, shapes[k], mode) % n_model == 0 for k, mode in modes.items())
        if ok and (part != "attn" or heads_ok):
            plan.update(modes)
    return plan


def _slice(key: str, t: torch.Tensor, mode: str, rank: int, world: int) -> torch.Tensor:
    """This rank's slice of a whole leaf."""
    t = t.detach()
    if key.endswith("attn.qkv.weight"):  # each third by heads
        d = t.shape[0] // 3
        n = d // world
        return t.reshape(3, d, -1)[:, rank * n:(rank + 1) * n].reshape(3 * n, -1).clone()
    n = t.shape[_DIM[mode]] // world
    return t.narrow(_DIM[mode], rank * n, n).clone()


def _col(dense, key, rank, world):
    """Keep this rank's output features of a Dense (weight and bias)."""
    dense.weight = nn.Parameter(_slice(f"{key}.weight", dense.weight, "col", rank, world))
    if dense.bias is not None:
        dense.bias = nn.Parameter(_slice(f"{key}.bias", dense.bias, "vec", rank, world))


def _row(dense, key, rank, world, group) -> RowParallelDense:
    w = _slice(f"{key}.weight", dense.weight, "row", rank, world)
    b = None if dense.bias is None else dense.bias.detach().clone()
    return RowParallelDense(w, b, group, dtype=dense.dtype)


def shard_model(model: nn.Module, groups: TPGroups) -> nn.Module:
    """Split ``model``'s ViT over ``groups``' model group (``tp_groups``;
    ``train_step`` averages the gradients over its data group), in place,
    by ``tp_plan``; returns ``model``.

    Every rank must hold the same whole model (the same weights file or
    seed). The model records its layout as ``model.tensor_parallel``;
    build the optimizer after this call."""
    group, rank, world = groups.model, groups.model_rank, groups.n_model
    if world != dist.get_world_size(group) or rank != dist.get_rank(group):
        raise ValueError("TPGroups do not match the model group")
    plan = tp_plan(model, world)
    for i, block in enumerate(model.pc_encoder.transformer.blocks):
        pre = f"pc_encoder.transformer.blocks.{i}"
        attn, mlp = block.attn, block.mlp
        if plan.get(f"{pre}.attn.proj.weight") == "row":
            if attn.qkv_fused:
                _col(attn.qkv, f"{pre}.attn.qkv", rank, world)
                for name in ("q_bias", "v_bias"):
                    setattr(attn, name, nn.Parameter(
                        _slice(name, getattr(attn, name), "vec", rank, world)))
            else:
                for name in ("q_proj", "k_proj", "v_proj"):
                    _col(getattr(attn, name), f"{pre}.attn.{name}", rank, world)
            attn.proj = _row(attn.proj, f"{pre}.attn.proj", rank, world, group)
            attn.num_heads //= world
            attn.tp_group = group
        if plan.get(f"{pre}.mlp.fc2.weight") == "row":
            for name in ("fc1_g", "fc1_x", "fc1"):
                if hasattr(mlp, name):
                    _col(getattr(mlp, name), f"{pre}.mlp.{name}", rank, world)
            norm = getattr(mlp, "norm", None)
            if norm is not None:
                mlp.norm = ShardedLayerNorm(
                    _slice("", norm.weight, "vec", rank, world),
                    _slice("", norm.bias, "vec", rank, world),
                    norm.weight.shape[0], group, dtype=norm.dtype)
            mlp.fc2 = _row(mlp.fc2, f"{pre}.mlp.fc2", rank, world, group)
            mlp.tp_group = group
    model.tensor_parallel = groups
    model.tp_plan = plan
    return model


def tp_gather_state_dict(model: nn.Module,
                         tensors: dict[str, torch.Tensor] | None = None
                         ) -> dict[str, torch.Tensor]:
    """The whole model's state dict (the one-process layout, the keys and
    shapes a checkpoint holds) from a ``shard_model``-ed model: each split
    leaf all-gathered over the model group, the rest as it is. A
    collective: every rank of the model group calls it.

    ``tensors``: gather these instead, keyed as the state dict (a subset of
    it, e.g. the parameters' gradients)."""
    tp = model.tensor_parallel
    out = {}
    for key, t in (model.state_dict() if tensors is None else tensors).items():
        mode = model.tp_plan.get(key)
        t = t.detach()
        if mode is None:
            out[key] = t.clone()
            continue
        parts = [torch.empty_like(t) for _ in range(tp.n_model)]
        dist.all_gather(parts, t.contiguous(), group=tp.model)
        if key.endswith("attn.qkv.weight"):  # each rank's q, k and v rows
            parts = [p.reshape(3, -1, p.shape[-1]) for p in parts]
            out[key] = torch.cat(parts, 1).reshape(-1, t.shape[-1])
        else:
            out[key] = torch.cat(parts, _DIM[mode])
    return out
