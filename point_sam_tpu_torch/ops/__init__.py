"""Geometry and kernel ops of the PyTorch port.

Four ops launch hand-written Hopper kernels on CUDA tensors and run their
plain torch versions on CPU tensors; two of them also have a backward
kernel (autograd Functions):

- ``fps_with_interp`` -> K1 (csrc/fps_interp.cu)
- ``patch_encoder_fused`` -> K2 (csrc/patch_encoder.cu), backward K7
  (csrc/patch_encoder_bwd.cu)
- ``mha_flat`` -> K3 (csrc/attention.cu), backward K6 (csrc/attention_bwd.cu)
- ``interp_upscale_hyper_fused`` -> K4 (csrc/upscale.cu), backward a plain
  torch recompute

``sample_prompts`` is the training click simulator (plain torch).
"""

from .attention import mha_flat
from .distance import sq_dist, sq_dist_to_point
from .fps import fps, fps_with_interp
from .group import (
    batch_index_select,
    group_features,
    group_points,
    repeat_interleave,
)
from .interp import (
    compute_interp_weights,
    interpolate_features,
    interpolate_features_repeated,
)
from .knn import knn
from .patch_encoder_pallas import patch_encoder_fused
from .sampler import sample_prompts, sample_prompts_random
from .upscale_pallas import interp_upscale_hyper_fused

__all__ = [
    "batch_index_select",
    "compute_interp_weights",
    "fps",
    "fps_with_interp",
    "group_features",
    "group_points",
    "interp_upscale_hyper_fused",
    "interpolate_features",
    "interpolate_features_repeated",
    "knn",
    "mha_flat",
    "patch_encoder_fused",
    "repeat_interleave",
    "sample_prompts",
    "sample_prompts_random",
    "sq_dist",
    "sq_dist_to_point",
]
