"""Seeded weights, made on the device in one draw.

One ``torch.randn`` of every element of every tensor of the model's state
dict, from a generator on the device seeded by ``--seed``, then each
tensor's slice scaled in place: matrices (and tables) N(0, 1/fan_in),
LayerNorm scales 1 + 0.1 N(0, 1), other vectors (biases) 0.1 N(0, 1), the
random-Fourier matrix N(0, 1). The same seed and names give the same
values to the program and to the reference.
"""

from __future__ import annotations

import math

import torch


def seeded_state(shapes: dict, seed: int, device) -> dict:
    """name -> fp32 tensor (views of one buffer) for ``shapes`` (name ->
    shape, in state-dict order)."""
    total = sum(math.prod(s) for s in shapes.values())
    g = torch.Generator(device=device).manual_seed(seed % (1 << 63))
    flat = torch.randn(total, generator=g, device=device, dtype=torch.float32)
    out, off = {}, 0
    for name, shape in shapes.items():
        n = math.prod(shape)
        t = flat[off:off + n].view(shape)
        off += n
        if name.endswith("positional_encoding_gaussian_matrix"):
            pass
        elif len(shape) >= 2:
            t.mul_(1.0 / math.sqrt(shape[1]))
        elif name.endswith(".weight") and _is_norm(name):
            t.mul_(0.1).add_(1.0)
        else:
            t.mul_(0.1)
        out[name] = t
    return out


def _is_norm(name: str) -> bool:
    """A LayerNorm's scale: a module named for a norm, or slot 1 of the
    PointNet units and of the decoder's upscaling (nn.Sequential)."""
    return "norm" in name.rsplit(".", 2)[-2] or any(
        name.endswith(f"{s}.1.weight") for s in ("conv1", "conv2", "output_upscaling"))


def shapes_of(model) -> dict:
    return {k: tuple(v.shape) for k, v in model.state_dict().items()}


@torch.no_grad()
def fill(model, seed: int) -> None:
    """Give every parameter and buffer of ``model`` (already on its device)
    its seeded value."""
    device = next(model.parameters()).device
    state = seeded_state(shapes_of(model), seed, device)
    for name, t in model.state_dict(keep_vars=True).items():
        t.copy_(state[name])
    del state
