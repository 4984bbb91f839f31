"""Reader and writer of the ``.safetensors`` format (the reference's
released-checkpoint format), on torch, numpy and json alone.

A file is an 8-byte little-endian header length, a JSON header, then the
raw little-endian bytes of every tensor. The header maps each name to
``{"dtype", "shape", "data_offsets": [begin, end]}`` (offsets into the
byte buffer after the header) and may hold ``"__metadata__"``, a dict of
strings. The writer pads the header with spaces to a multiple of 8 bytes
and lays the tensors out by element size, largest first, then by name, as
the ``safetensors`` package does, so every tensor starts aligned.
"""

from __future__ import annotations

import json
import struct
from pathlib import Path

import numpy as np
import torch

# safetensors dtype name -> torch dtype. torch reads and writes each of them
# from raw bytes, bf16 included (numpy has no bf16).
_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool,
}
_NAMES = {v: k for k, v in _DTYPES.items()}


def load_file(path) -> dict[str, torch.Tensor]:
    """Every tensor of the file at ``path`` (CPU tensors in the file's
    dtypes, sharing one buffer read from the file)."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        data = bytearray(f.read())
    header.pop("__metadata__", None)
    out = {}
    for name, info in header.items():
        dtype = _DTYPES.get(info["dtype"])
        if dtype is None:
            raise ValueError(f"{path}: tensor {name!r} has dtype {info['dtype']}, "
                             f"which is not one of {sorted(_DTYPES)}")
        begin, end = info["data_offsets"]
        shape = tuple(info["shape"])
        count = int(np.prod(shape, dtype=np.int64))
        size = torch.empty((), dtype=dtype).element_size()
        if end - begin != count * size or end > len(data):
            raise ValueError(f"{path}: tensor {name!r} has {end - begin} bytes at "
                             f"{begin}..{end}, expected {count * size}")
        if not count:
            t = torch.empty(0, dtype=dtype)
        elif begin % size:  # a writer that did not align it: copy the bytes
            t = torch.frombuffer(bytearray(data[begin:end]), dtype=dtype)
        else:
            t = torch.frombuffer(data, dtype=dtype, count=count, offset=begin)
        out[name] = t.reshape(shape)
    return out


def save_file(tensors: dict[str, torch.Tensor], path, metadata: dict[str, str] | None = None):
    """Write ``tensors`` (name -> tensor, any device, one of the format's
    dtypes) to ``path`` in the safetensors format."""
    flat = {}
    for name, t in tensors.items():
        t = torch.as_tensor(t).detach()
        if t.dtype not in _NAMES:
            raise ValueError(f"tensor {name!r} has dtype {t.dtype}, which the format lacks")
        flat[name] = t.to("cpu").contiguous()
    order = sorted(flat, key=lambda k: (-flat[k].element_size(), k))
    header, offset = {}, 0
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    for name in order:
        t = flat[name]
        nbytes = t.numel() * t.element_size()
        header[name] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    text = json.dumps(header, separators=(",", ":")).encode()
    text += b" " * (-len(text) % 8)
    tmp = Path(f"{path}.tmp")
    with open(tmp, "wb") as f:
        f.write(struct.pack("<Q", len(text)))
        f.write(text)
        for name in order:
            t = flat[name]
            if t.numel():
                f.write(memoryview(t.reshape(-1).view(torch.uint8).numpy()))
    tmp.replace(path)
