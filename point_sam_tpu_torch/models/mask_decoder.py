"""Mask decoder (counterpart of point_sam_tpu/models/mask_decoder.py).

Concat [iou_token, mask_tokens, sparse prompts], broadcast the cloud's
tokens B -> B*M and add the dense prompt embeddings, run the two-way
transformer, then upscale to all N points and dot with the per-mask
hypernetwork outputs; an IoU head scores each mask (reference
mask_decoder.py:21-184).

The upscale's first Dense (``output_upscaling.0``) is applied on the G
token side: the 3-NN weights sum to 1, so Dense(interp(x)) = interp(Dense(x))
and the projection costs N/G times less. The rest of the tail runs in
``ops.decoder_tail``, which routes by shape as the JAX decoder does:
kernel K4 (interpolation fused in) where JAX's K4 gate holds, else a plain
3-NN gather and kernel K11.

With ``point_group`` set (``models.pc_sam.for_sharded_eval``, the
big-scene evaluator) the N-point tail is split over the group's ranks:
rank r decodes rows [r * n, (r + 1) * n) of the 3-NN geometry, n = ceil(N
/ W), against the whole tokens (the route chosen at n rows: K4 where the
gate holds, else the gather and K11), and an all-gather along N returns
the whole [B*M, C, N] logits to every rank (JAX's ``point_mesh`` decode;
evaluation only: no gradient crosses the gather).
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch import nn

from ..ops import decoder_tail, repeat_interleave
from .layers import GELU, MLP, Dense, Embedding, LayerNorm
from .transformer import TwoWayTransformer


class OutputUpscaling(nn.Sequential):
    """Linear-LN-GELU-Linear-GELU (reference mask_decoder.py:53-59); keys
    ``0`` / ``1`` / ``3``; ``out_dim`` (default ``dim``) is the width after
    the first Linear (the hier decoder's stage 1 halves it)."""

    def __init__(self, dim: int, out_dim: int | None = None, *, dtype=torch.float32,
                 device=None, generator=None):
        kw = dict(dtype=dtype, device=device, generator=generator)
        o = out_dim or dim
        super().__init__(Dense(dim, o, **kw), LayerNorm(o, dtype=dtype, device=device),
                         GELU(), Dense(o, o, **kw), GELU())

    def tail_params(self) -> tuple:
        """(ln_scale, ln_bias, Dense_1 kernel [in, out], Dense_1 bias)."""
        return (self[1].weight, self[1].bias, self[3].kernel(), self[3].bias)


class TwoWayDecoderTrunk(nn.Module):
    """The decoder half both decoders share: the output tokens (IoU token
    and mask tokens) and the prompt tokens attend to the cloud's tokens in
    the two-way transformer (reference mask_decoder.py:21-145); the IoU head
    scores the masks. The upscaling and hypernetworks are each decoder's."""

    def __init__(self, transformer_dim: int, num_multimask_outputs: int, iou_head_depth: int,
                 iou_head_hidden_dim: int, depth: int, num_heads: int, mlp_dim: int, *,
                 dtype=torch.float32, device=None, generator=None):
        super().__init__()
        D = transformer_dim
        kw = dict(dtype=dtype, device=device, generator=generator)
        self.dtype = dtype
        self.num_mask_tokens = num_multimask_outputs + 1
        self.iou_token = Embedding(1, D, device=device, generator=generator)
        self.mask_tokens = Embedding(self.num_mask_tokens, D, device=device,
                                     generator=generator)
        self.transformer = TwoWayTransformer(depth, D, num_heads, mlp_dim, **kw)
        self.iou_prediction_head = MLP(D, iou_head_hidden_dim, self.num_mask_tokens,
                                       iou_head_depth, **kw)

    def two_way(self, pc_embeddings, pc_pe, sparse_prompt_embeddings, dense_prompt_embeddings,
                prompt_valid=None):
        """Returns (hs [B*M, T, D] token outputs, src [B*M, G, D] cloud tokens)."""
        BM = sparse_prompt_embeddings.shape[0]
        D = pc_embeddings.shape[-1]
        out_tokens = torch.cat([self.iou_token.weight, self.mask_tokens.weight], 0)
        out_tokens = out_tokens.to(self.dtype).expand(BM, -1, D)
        tokens = torch.cat([out_tokens, sparse_prompt_embeddings.to(self.dtype)], dim=1)
        token_valid = None
        if prompt_valid is not None:
            ones = torch.ones((BM, 1 + self.num_mask_tokens), dtype=torch.bool,
                              device=prompt_valid.device)
            token_valid = torch.cat([ones, prompt_valid], dim=1)

        repeats = BM // pc_embeddings.shape[0]
        src = repeat_interleave(pc_embeddings, repeats, axis=0)
        pos_src = repeat_interleave(pc_pe, repeats, axis=0).to(self.dtype)
        dense = dense_prompt_embeddings
        if dense.shape[0] != BM:
            dense = repeat_interleave(dense, BM // dense.shape[0], axis=0)
        src = src + dense
        return self.transformer(src, pos_src, tokens, token_valid=token_valid)

    def token_slice(self, multimask_output: bool) -> range:
        """Tokens 1..C for multimask output, token 0 otherwise."""
        return range(1, self.num_mask_tokens) if multimask_output else range(0, 1)

    def iou(self, hs, token_slice) -> torch.Tensor:
        return self.iou_prediction_head(hs[:, 0]).float()[:, list(token_slice)]


class MaskDecoder(TwoWayDecoderTrunk):
    def __init__(self, transformer_dim: int = 256, num_multimask_outputs: int = 3,
                 iou_head_depth: int = 3, iou_head_hidden_dim: int = 256, depth: int = 2,
                 num_heads: int = 8, mlp_dim: int = 2048, *, dtype=torch.float32,
                 device=None, generator=None):
        kw = dict(dtype=dtype, device=device, generator=generator)
        super().__init__(transformer_dim, num_multimask_outputs, iou_head_depth,
                         iou_head_hidden_dim, depth, num_heads, mlp_dim, **kw)
        D = transformer_dim
        self.output_upscaling = OutputUpscaling(D, **kw)
        self.output_hypernetworks_mlps = nn.ModuleList(
            MLP(D, D, D, 3, **kw) for _ in range(self.num_mask_tokens))
        self.point_group = None  # see the module docstring

    def forward(self, pc_embeddings, pc_pe, sparse_prompt_embeddings,
                dense_prompt_embeddings, *, interp_index, interp_weight,
                prompt_valid=None, multimask_output: bool = True):
        """Args:
            pc_embeddings, pc_pe: [B, G, D].
            sparse_prompt_embeddings: [B*M, P, D]; prompt_valid [B*M, P].
            dense_prompt_embeddings: [B*M or B, G, D].
            interp_index / interp_weight: [B, N, 3] cached 3-NN geometry.
            multimask_output: True -> tokens 1..C, False -> token 0.

        Returns:
            (masks [B*M, C, N] fp32 logits, iou_pred [B*M, C] fp32).
        """
        hs, src = self.two_way(pc_embeddings, pc_pe, sparse_prompt_embeddings,
                               dense_prompt_embeddings, prompt_valid)
        mask_tokens_out = hs[:, 1:1 + self.num_mask_tokens]
        h1 = self.output_upscaling[0](src)  # Dense_0 on the G tokens
        token_slice = self.token_slice(multimask_output)
        hyper_in = torch.stack(
            [self.output_hypernetworks_mlps[i](mask_tokens_out[:, i]) for i in token_slice],
            dim=1)  # [B*M, C, D]
        params = self.output_upscaling.tail_params()
        if self.point_group is None:
            masks = decoder_tail(h1, interp_index, interp_weight, params, hyper_in,
                                 cdt=self.dtype)
        else:
            masks = _point_sharded_tail(h1, interp_index, interp_weight, params, hyper_in,
                                        self.dtype, self.point_group)
        return masks, self.iou(hs, token_slice)


def _point_sharded_tail(h1, index, weight, params, hyper, cdt, group):
    """``decoder_tail`` on this rank's rows of the geometry, then the
    ranks' logits gathered along N (a short last shard padded with zero
    weights, its extra logits dropped)."""
    if torch.is_grad_enabled() and h1.requires_grad:
        raise RuntimeError("the point-sharded decode is for evaluation: no gradient "
                           "crosses its all-gather")
    world, rank = dist.get_world_size(group), dist.get_rank(group)
    N = index.shape[1]
    n = -(-N // world)
    lo, hi = min(rank * n, N), min((rank + 1) * n, N)
    idx, w = index[:, lo:hi], weight[:, lo:hi]
    if hi - lo < n:
        pad = (idx.shape[0], n - (hi - lo), idx.shape[2])
        idx, w = torch.cat([idx, idx.new_zeros(pad)], 1), torch.cat([w, w.new_zeros(pad)], 1)
    local = decoder_tail(h1, idx.contiguous(), w.contiguous(), params, hyper, cdt=cdt)
    parts = [torch.empty_like(local) for _ in range(world)]
    dist.all_gather(parts, local.contiguous(), group=group)
    return torch.cat(parts, dim=-1)[..., :N]
