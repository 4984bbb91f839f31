"""Geometry and kernel ops of the PyTorch port.

These ops launch hand-written Hopper kernels on CUDA tensors and run their
plain torch versions on CPU tensors; two kernels also have a backward
kernel (autograd Functions):

- ``fps_with_interp`` -> K1 (csrc/fps_interp.cu)
- ``fps`` -> K8 (csrc/fps_interp.cu, selection only); ``fps_gather`` is
  ``fps`` and a gather of the sampled coordinates
- ``compute_interp_weights`` -> K10 (csrc/interp.cu)
- ``patch_encoder_fused`` -> K2 (csrc/patch_encoder.cu), backward K7
  (csrc/patch_encoder_bwd.cu)
- ``mha_flat`` -> K3 (csrc/attention.cu), backward K6 (csrc/attention_bwd.cu),
  for head sizes 64 and 128; ``mha`` (and ``mha_flat`` at other head
  sizes) -> K5 (csrc/attention.cu), backward a plain torch recompute
- ``fps_with_interp_knn`` -> K9 (csrc/fps_interp.cu: K1's launch, then the
  binned kNN over its centres), the tokenizer's ``knn_method="approx"``
  where its gate holds
- ``knn`` at k > 4 -> K12 (csrc/knn.cu), exact or over strided bins
  (``method="approx"``); k <= 4 stays plain torch
- ``decoder_tail`` -> K4 (``interp_upscale_hyper_fused``, interpolation
  fused in) or a plain 3-NN gather and K11 (``upscale_hyper_fused``), both
  in csrc/upscale.cu, backward a plain torch recompute

``sample_prompts`` is the training click simulator and ``scatter_max`` the
voronoi tokenizer's segment max (plain torch).
"""

from .attention import mha, mha_flat
from .distance import sq_dist, sq_dist_to_point
from .fps import fps, fps_gather, fps_with_interp, fps_with_interp_knn
from .group import (
    batch_index_select,
    group_features,
    group_points,
    group_voronoi,
    repeat_interleave,
)
from .interp import (
    compute_interp_weights,
    interpolate_features,
    interpolate_features_repeated,
)
from .knn import knn, nn1
from .patch_encoder_pallas import patch_encoder_fused
from .sampler import sample_prompts, sample_prompts_random
from .scatter import gather_segments, scatter_max
from .upscale_pallas import decoder_tail, interp_upscale_hyper_fused, upscale_hyper_fused

__all__ = [
    "batch_index_select",
    "compute_interp_weights",
    "decoder_tail",
    "fps",
    "fps_gather",
    "fps_with_interp",
    "fps_with_interp_knn",
    "gather_segments",
    "group_features",
    "group_points",
    "group_voronoi",
    "interp_upscale_hyper_fused",
    "interpolate_features",
    "interpolate_features_repeated",
    "knn",
    "mha",
    "mha_flat",
    "nn1",
    "patch_encoder_fused",
    "repeat_interleave",
    "sample_prompts",
    "sample_prompts_random",
    "scatter_max",
    "sq_dist",
    "sq_dist_to_point",
    "upscale_hyper_fused",
]
