"""Utilities of the PyTorch port."""

from .convert import state_dict_from_flax, torch_key_for

__all__ = ["state_dict_from_flax", "torch_key_for"]
