"""PointNet patch encoder (counterpart of point_sam_tpu/models/patch_encoder.py).

[B, L, K, C_in] group features -> [B, L, C_out] patch embeddings:
MLP -> max-pool over K -> concat[max, x] -> MLP -> max-pool (reference
common.py:477-506). The forward always goes through
``ops.patch_encoder_fused``: kernel K2 on the card, its plain torch version
on the CPU. The ``conv1`` / ``conv2`` submodules hold the parameters under
the reference's key names.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..ops import patch_encoder_fused
from .layers import PointNetLayer


class PatchEncoder(nn.Module):
    def __init__(self, in_channels: int, out_channels: int,
                 hidden_dims: Sequence[int] = (128, 512), *, act: str = "erf",
                 dtype=torch.float32, device=None, generator=None):
        super().__init__()
        h0, h1 = hidden_dims
        kw = dict(act=act, dtype=dtype, device=device, generator=generator)
        self.conv1 = PointNetLayer(in_channels, h0, h0, **kw)
        self.conv2 = PointNetLayer(2 * h0, h1, out_channels, **kw)
        self.act = act
        self.dtype = dtype

    def fused_params(self) -> tuple:
        """The 12 parameters in the fused op's order; matrices [in, out]."""
        c1, c2 = self.conv1, self.conv2
        return (c1[0].kernel(), c1[0].bias, c1[1].weight, c1[1].bias,
                c1[3].kernel(), c1[3].bias,
                c2[0].kernel(), c2[0].bias, c2[1].weight, c2[1].bias,
                c2[3].kernel(), c2[3].bias)

    def forward(self, point_patches: torch.Tensor) -> torch.Tensor:
        B, L, K, C = point_patches.shape
        return patch_encoder_fused(
            point_patches.reshape(B, L * K, C), self.fused_params(),
            num_groups=L, group_size=K, cdt=self.dtype, act=self.act)
