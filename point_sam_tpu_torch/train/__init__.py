"""Training of the PyTorch port: the LR schedule and the trainer entry point
(``python -m point_sam_tpu_torch.train.trainer``)."""

from .schedule import warmup_multistep

__all__ = ["warmup_multistep"]
