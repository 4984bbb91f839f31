"""Mask decoder (counterpart of point_sam_tpu/models/mask_decoder.py).

Concat [iou_token, mask_tokens, sparse prompts], broadcast the cloud's
tokens B -> B*M and add the dense prompt embeddings, run the two-way
transformer, then upscale to all N points and dot with the per-mask
hypernetwork outputs; an IoU head scores each mask (reference
mask_decoder.py:21-184).

The upscale's first Dense (``output_upscaling.0``) is applied on the G
token side: the 3-NN weights sum to 1, so Dense(interp(x)) = interp(Dense(x))
and the projection costs N/G times less. The rest of the tail runs in
``ops.interp_upscale_hyper_fused`` (kernel K4 on the card).
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops import interp_upscale_hyper_fused, repeat_interleave
from .layers import GELU, MLP, Dense, Embedding, LayerNorm
from .transformer import TwoWayTransformer


class OutputUpscaling(nn.Sequential):
    """Linear-LN-GELU-Linear-GELU (reference mask_decoder.py:53-59); keys
    ``0`` / ``1`` / ``3``."""

    def __init__(self, dim: int, *, dtype=torch.float32, device=None, generator=None):
        kw = dict(dtype=dtype, device=device, generator=generator)
        super().__init__(Dense(dim, dim, **kw), LayerNorm(dim, dtype=dtype, device=device),
                         GELU(), Dense(dim, dim, **kw), GELU())

    def tail_params(self) -> tuple:
        """(ln_scale, ln_bias, Dense_1 kernel [in, out], Dense_1 bias)."""
        return (self[1].weight, self[1].bias, self[3].kernel(), self[3].bias)


class MaskDecoder(nn.Module):
    def __init__(self, transformer_dim: int = 256, num_multimask_outputs: int = 3,
                 iou_head_depth: int = 3, iou_head_hidden_dim: int = 256, depth: int = 2,
                 num_heads: int = 8, mlp_dim: int = 2048, *, dtype=torch.float32,
                 device=None, generator=None):
        super().__init__()
        D = transformer_dim
        kw = dict(dtype=dtype, device=device, generator=generator)
        self.dtype = dtype
        self.num_mask_tokens = num_multimask_outputs + 1
        self.iou_token = Embedding(1, D, device=device, generator=generator)
        self.mask_tokens = Embedding(self.num_mask_tokens, D, device=device,
                                     generator=generator)
        self.transformer = TwoWayTransformer(depth, D, num_heads, mlp_dim, **kw)
        self.output_upscaling = OutputUpscaling(D, **kw)
        self.output_hypernetworks_mlps = nn.ModuleList(
            MLP(D, D, D, 3, **kw) for _ in range(self.num_mask_tokens))
        self.iou_prediction_head = MLP(D, iou_head_hidden_dim, self.num_mask_tokens,
                                       iou_head_depth, **kw)

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

        hs, src = self.transformer(src, pos_src, tokens, token_valid=token_valid)
        iou_token_out = hs[:, 0]
        mask_tokens_out = hs[:, 1:1 + self.num_mask_tokens]

        h1 = self.output_upscaling[0](src)  # Dense_0 on the G tokens
        token_slice = (range(1, self.num_mask_tokens) if multimask_output else range(0, 1))
        hyper_in = torch.stack(
            [self.output_hypernetworks_mlps[i](mask_tokens_out[:, i]) for i in token_slice],
            dim=1)  # [B*M, C, D]
        masks = interp_upscale_hyper_fused(
            h1, interp_index, interp_weight, self.output_upscaling.tail_params(),
            hyper_in, cdt=self.dtype)
        iou_pred = self.iou_prediction_head(iou_token_out).float()[:, list(token_slice)]
        return masks, iou_pred
