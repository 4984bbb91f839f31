"""Shared building blocks (counterpart of point_sam_tpu/models/layers.py).

Dtype policy, as in the JAX package: parameters are created in fp32;
``dtype`` is the compute dtype of a module (bf16 on the card for inference,
fp32 on the CPU and in tests). A ``Dense`` casts its input, weight and bias
to ``dtype``; ``cast_params_for_inference`` (models/pc_sam.py) pre-casts the
weights once so that cast is a no-op. LayerNorm keeps fp32 parameters and
fp32 two-pass statistics whatever ``dtype`` is.

Every parameter is initialised from an explicit ``torch.Generator`` on the
module's ``device``; nothing reads torch's global RNG.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn


def normal_(t: torch.Tensor, std: float, generator: torch.Generator | None):
    with torch.no_grad():
        return t.normal_(0.0, std, generator=generator)


def normal_param(shape, std, *, device=None, generator=None) -> nn.Parameter:
    t = torch.empty(shape, dtype=torch.float32, device=device)
    return nn.Parameter(normal_(t, std, generator))


class Dense(nn.Module):
    """Linear layer with the reference's key names (``weight`` [out, in],
    ``bias`` [out]) and flax Dense dtype semantics: input, weight and bias
    are cast to ``dtype``. Weights start as lecun-normal, biases at zero
    (flax's defaults)."""

    def __init__(self, in_features: int, out_features: int, *, bias: bool = True,
                 dtype=torch.float32, device=None, generator=None):
        super().__init__()
        self.dtype = dtype
        self.weight = normal_param((out_features, in_features),
                                   1.0 / math.sqrt(in_features),
                                   device=device, generator=generator)
        self.bias = (nn.Parameter(torch.zeros(out_features, device=device))
                     if bias else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight.to(self.dtype)
        b = None if self.bias is None else self.bias.to(self.dtype)
        return F.linear(x.to(self.dtype), w, b)

    def kernel(self) -> torch.Tensor:
        """The weight in flax ``kernel`` layout [in, out] (a view)."""
        return self.weight.t()


class Embedding(nn.Module):
    """A learned table ``weight`` [num, dim] (the reference's nn.Embedding
    parameters), initialised N(0, 1) from the given generator."""

    def __init__(self, num: int, dim: int, *, device=None, generator=None):
        super().__init__()
        self.weight = normal_param((num, dim), 1.0, device=device, generator=generator)


class LayerNorm(nn.Module):
    """LayerNorm with fp32 two-pass statistics and eps 1e-5 whatever the
    compute dtype; the output is cast to ``dtype``."""

    def __init__(self, dim: int, *, dtype=torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(dim, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        c = x32 - x32.mean(-1, keepdim=True)
        var = (c * c).mean(-1, keepdim=True)
        y = c * (torch.rsqrt(var + 1e-5) * self.weight) + self.bias
        return y.to(self.dtype)


# ------------------------------------------------------ tensor parallelism
# Megatron's two collectives around a tensor-parallel region of the ViT
# (parallel/tensor_parallel.py shards the blocks): ``tp_copy`` (f) at the
# input of a column-parallel group, identity forward and an all-reduce of
# the input gradient backward; ``tp_reduce`` (g) after a row-parallel
# product, an all-reduce forward and identity backward. ``tp_sum`` is an
# all-reduce both ways: a statistic that every rank's shard feeds and
# every rank's output reads.


def _all_reduced(t: torch.Tensor, group) -> torch.Tensor:
    out = t.contiguous().clone()
    dist.all_reduce(out, group=group)
    return out


class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduced(g, ctx.group), None


class _ReduceFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduced(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SumOverTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduced(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduced(g, ctx.group), None


def tp_copy(x: torch.Tensor, group) -> torch.Tensor:
    return _CopyToTP.apply(x, group)


def tp_reduce(x: torch.Tensor, group) -> torch.Tensor:
    return _ReduceFromTP.apply(x, group)


def tp_sum(x: torch.Tensor, group) -> torch.Tensor:
    return _SumOverTP.apply(x, group)


def _mm_fp32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b with an fp32 result: for bf16 operands on the card the product
    accumulates in fp32 and is not rounded to bf16 (``out_dtype``); the
    products of bf16 values are exact in fp32, so on the CPU the fp32
    product of the widened operands is the same function."""
    if a.dtype != torch.float32 and a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return torch.mm(a.float(), b.float())


class _PartialProduct(torch.autograd.Function):
    """x [.., in] @ w[out, in]^T as an fp32 partial sum; the backward is a
    Dense's in the compute dtype (the gradient of the reduced fp32 sum is
    the compute-dtype gradient of the output, widened, so it narrows back
    exactly)."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        out = _mm_fp32(x.reshape(-1, x.shape[-1]), w.t())
        return out.reshape(*x.shape[:-1], w.shape[0])

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.to(x.dtype)
        gx = g @ w
        gw = g.reshape(-1, g.shape[-1]).t() @ x.reshape(-1, x.shape[-1])
        return gx, gw


class RowParallelDense(Dense):
    """A Dense whose input features are split over the ranks of ``group``
    (Megatron's row-parallel linear): each rank's product over its slice is
    an fp32 partial sum, the partials are all-reduced in fp32 (``tp_reduce``),
    the bias is added once and the sum is cast to ``dtype`` once (bf16
    matmuls accumulate in fp32, and nothing is rounded twice). ``weight`` is
    this rank's [out, in / W] slice; ``bias`` [out] is whole."""

    def __init__(self, weight: torch.Tensor, bias: torch.Tensor | None, group, *, dtype):
        nn.Module.__init__(self)
        self.dtype = dtype
        self.group = group
        self.weight = nn.Parameter(weight)
        self.bias = None if bias is None else nn.Parameter(bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        part = _PartialProduct.apply(x.to(self.dtype), self.weight.to(self.dtype))
        out = tp_reduce(part, self.group)
        if self.bias is not None:
            out = out + self.bias.float()
        return out.to(self.dtype)


class ShardedLayerNorm(LayerNorm):
    """LayerNorm over a feature axis split over the ranks of ``group``
    (the EVA02 sub-LN under tensor parallelism): the statistics are the
    whole axis's, fp32 and two-pass as ``LayerNorm``'s, from two
    all-reduces (the sum, then the sum of squared deviations). ``weight``
    and ``bias`` are this rank's slices; ``dim`` is the whole axis."""

    def __init__(self, weight: torch.Tensor, bias: torch.Tensor, dim: int, group, *, dtype):
        nn.Module.__init__(self)
        self.dtype = dtype
        self.dim = dim
        self.group = group
        self.weight = nn.Parameter(weight)
        self.bias = nn.Parameter(bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        mean = tp_sum(x32.sum(-1, keepdim=True), self.group) / self.dim
        c = x32 - mean
        var = tp_sum((c * c).sum(-1, keepdim=True), self.group) / self.dim
        y = c * (torch.rsqrt(var + 1e-5) * self.weight) + self.bias
        return y.to(self.dtype)


class GELU(nn.Module):
    """GELU with the erf (default) or tanh form; no parameters."""

    def __init__(self, act: str = "erf"):
        super().__init__()
        self.approximate = "tanh" if act == "tanh" else "none"

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.gelu(x, approximate=self.approximate)


class MLPBlock(nn.Module):
    """Linear-act-Linear (reference transformer.py:240-253): ``lin1``, ``lin2``."""

    def __init__(self, dim: int, mlp_dim: int, out_dim: int, *, act=F.gelu,
                 dtype=torch.float32, device=None, generator=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device, generator=generator)
        self.lin1 = Dense(dim, mlp_dim, **kw)
        self.lin2 = Dense(mlp_dim, out_dim, **kw)
        self.act = act

    def forward(self, x):
        return self.lin2(self.act(self.lin1(x)))


class MLP(nn.Module):
    """N-layer ReLU MLP head (reference mask_decoder.py:189-211): ``layers.{j}``."""

    def __init__(self, in_dim: int, hidden_dim: int, output_dim: int, num_layers: int,
                 *, sigmoid_output: bool = False, dtype=torch.float32, device=None,
                 generator=None):
        super().__init__()
        dims = [in_dim] + [hidden_dim] * (num_layers - 1) + [output_dim]
        self.layers = nn.ModuleList(
            Dense(dims[i], dims[i + 1], dtype=dtype, device=device, generator=generator)
            for i in range(num_layers)
        )
        self.sigmoid_output = sigmoid_output

    def forward(self, x):
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = F.relu(x)
        return torch.sigmoid(x) if self.sigmoid_output else x


class PointNetLayer(nn.Sequential):
    """Dense-LN-GELU-Dense, the conv unit of the PointNet patch encoder
    (reference common.py:486-497); keys ``0`` / ``1`` / ``3`` as in the
    reference's ``nn.Sequential``."""

    def __init__(self, in_dim: int, hidden_dim: int, out_dim: int, *, act: str = "erf",
                 dtype=torch.float32, device=None, generator=None):
        kw = dict(dtype=dtype, device=device, generator=generator)
        super().__init__(
            Dense(in_dim, hidden_dim, **kw),
            LayerNorm(hidden_dim, dtype=dtype, device=device),
            GELU(act),
            Dense(hidden_dim, out_dim, **kw),
        )


class CoordMLP(nn.Sequential):
    """3 -> hidden -> GELU -> out positional embedding of patch centres
    (reference pc_encoder.py:102-104); keys ``0`` / ``2``."""

    def __init__(self, hidden_dim: int, out_dim: int, *, dtype=torch.float32,
                 device=None, generator=None):
        kw = dict(dtype=dtype, device=device, generator=generator)
        super().__init__(Dense(3, hidden_dim, **kw), GELU(), Dense(hidden_dim, out_dim, **kw))
