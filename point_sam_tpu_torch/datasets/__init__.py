"""Datasets of the PyTorch port (numpy only): the offline synthetic scenes,
the transform chain, the batcher, the validation (scene, mask) rows and the
preprocessing tools (``preprocess``)."""

from .build import BatchIterator, ConcatDataset, FlatMaskDataset, HFDataset, build_dataset
from .synthetic import SyntheticDataset, generate_scene
from .transforms import build_transforms

__all__ = ["BatchIterator", "ConcatDataset", "FlatMaskDataset", "HFDataset",
           "SyntheticDataset", "build_dataset", "build_transforms", "generate_scene"]
