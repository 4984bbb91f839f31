"""Serving surface of the PyTorch port: the interactive ``Predictor``."""

from .predictor import DEFAULT_POINT_BUCKETS, Predictor

__all__ = ["DEFAULT_POINT_BUCKETS", "Predictor"]
