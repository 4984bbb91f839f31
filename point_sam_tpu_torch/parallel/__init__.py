"""The train step of the PyTorch port (one device; the multi-GPU branches
come with the multi-GPU slice)."""

from .train_step import ClippedAdamW, make_optimizer, train_step

__all__ = ["ClippedAdamW", "make_optimizer", "train_step"]
