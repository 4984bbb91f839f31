"""Utilities of the PyTorch port."""

from .checkpoint import CheckpointManager
from .config import build_model, load_config
from .convert import state_dict_from_flax, torch_key_for
from .seeding import seed_everything

__all__ = ["CheckpointManager", "build_model", "load_config", "seed_everything",
           "state_dict_from_flax", "torch_key_for"]
