"""Utilities of the PyTorch port."""

from .checkpoint import CheckpointManager
from .config import build_model, load_config
from .convert import state_dict_from_flax, torch_key_for

__all__ = ["CheckpointManager", "build_model", "load_config", "state_dict_from_flax",
           "torch_key_for"]
