"""PointNet patch encoders (counterpart of point_sam_tpu/models/patch_encoder.py).

``PatchEncoder``: [B, L, K, C_in] group features -> [B, L, C_out] patch
embeddings: MLP -> max-pool over K -> concat[max, x] -> MLP -> max-pool
(reference common.py:477-506). The forward always goes through
``ops.patch_encoder_fused``: kernel K2 on the card, its plain torch version
on the CPU.

``PatchEncoderNN``: the voronoi form (reference common.py:508-535), per-point
features with each point's centre index; the max-pools are segment maxima
over each centre's points (``ops.scatter_max``, plain torch), broadcast back
to the points for the concat (``ops.gather_segments``).

The ``conv1`` / ``conv2`` submodules hold the parameters under the
reference's key names.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..ops import gather_segments, patch_encoder_fused, scatter_max
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


class PatchEncoderNN(nn.Module):
    """[B, N, C_in] point features + centre index [B, N] -> [B, L, C_out]
    with L = ``num_centers``; a centre that receives no point gets 0."""

    def __init__(self, in_channels: int, out_channels: int, num_centers: int,
                 hidden_dims: Sequence[int] = (128, 512), *, dtype=torch.float32,
                 device=None, generator=None):
        super().__init__()
        h0, h1 = hidden_dims
        kw = dict(dtype=dtype, device=device, generator=generator)
        self.num_centers = num_centers
        self.dtype = dtype
        self.conv1 = PointNetLayer(in_channels, h0, h0, **kw)
        self.conv2 = PointNetLayer(2 * h0, h1, out_channels, **kw)

    def forward(self, point_features: torch.Tensor, nn_idx: torch.Tensor) -> torch.Tensor:
        x = self.conv1(point_features.to(self.dtype))
        y = scatter_max(x, nn_idx, self.num_centers)  # [B, L, h0]
        x = torch.cat([gather_segments(y, nn_idx), x], dim=-1)
        return scatter_max(self.conv2(x), nn_idx, self.num_centers)
