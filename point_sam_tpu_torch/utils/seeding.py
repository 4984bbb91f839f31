"""Seeding helpers (counterpart of point_sam_tpu/utils/seeding.py).

``seed_everything`` pins python's, numpy's and torch's global generators
(the CPU's and, where there is one, every CUDA device's) and returns a
seeded ``torch.Generator``, where JAX returns a root PRNG key: the port's
modules draw from an explicit generator, never from the global one.
``worker_rng`` gives each logical worker or stream its own numpy Generator,
as JAX's does, draw for draw.
"""

from __future__ import annotations

import random

import numpy as np
import torch


def seed_everything(seed: int) -> torch.Generator:
    """Seed python, numpy and torch; return a CPU ``torch.Generator``
    seeded with ``seed``."""
    random.seed(seed)
    np.random.seed(seed % (2**32))
    torch.manual_seed(seed)  # the CPU's and every CUDA device's, where present
    return torch.Generator().manual_seed(seed)


def worker_rng(seed: int, worker_id: int) -> np.random.Generator:
    """An independent numpy Generator per logical worker or stream, from
    ``SeedSequence([seed, worker_id])``."""
    ss = np.random.SeedSequence([seed, worker_id])
    return np.random.default_rng(ss)
