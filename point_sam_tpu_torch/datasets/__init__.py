"""Datasets of the PyTorch port (numpy only): the offline synthetic scenes,
the transform chain and the batcher."""

from .build import BatchIterator, ConcatDataset, HFDataset, build_dataset
from .synthetic import SyntheticDataset, generate_scene
from .transforms import build_transforms

__all__ = ["BatchIterator", "ConcatDataset", "HFDataset", "SyntheticDataset",
           "build_dataset", "build_transforms", "generate_scene"]
