"""point_sam_tpu_torch: the PyTorch / CUDA (NVIDIA Hopper) port of point_sam_tpu.

Interactive inference (``serving.Predictor`` over ``models.PointCloudSAM``)
and training (``train.trainer``) run on one H100 with hand-written CUDA
kernels (see ``ops``): four forward kernels and two backward kernels; on
the CPU every kernel has a plain torch version. The JAX package ``point_sam_tpu``
is the reference this port is tested against; this package never imports
it (or JAX).
"""

import torch

# fp32 matmuls stay full fp32 on the card. TF32 keeps ~3 decimal digits,
# and the kNN distance expansion |q|^2 - 2qk + |k|^2 is rank-sensitive: a
# truncated cross term collapsed top-256 neighbour recall to 0.51 in the
# reference's measurement (point_sam_tpu/ops/distance.py). Both switches are
# set explicitly because cuDNN defaults to TF32.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from . import datasets, models, ops, parallel, serving, train, utils  # noqa: E402

__all__ = ["datasets", "models", "ops", "parallel", "serving", "train", "utils"]
