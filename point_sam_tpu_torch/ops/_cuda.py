"""Build and load the hand-written Hopper kernels (``csrc/*.cu``).

The sources are compiled at first use by ``nvcc``, one process per source
file, all started together, and linked into one shared library with a
plain C interface, loaded with ``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
         -Xcompiler -fPIC -c -o <name>.o csrc/<name>.cu     (each source)
    nvcc -shared -o libpsam_kernels.so *.o

The library lands in ``build/point_sam_tpu_torch/<hash>/`` under the
repository root, keyed by a hash of the sources and flags, so an edited
``.cu`` rebuilds and an unchanged one is reused. Every C entry point takes
its pointers and the CUDA stream as ``void*``, launches on that stream,
allocates nothing and returns ``cudaGetLastError()``; ``check`` raises on a
non-zero code. Nothing here runs at import: the CPU tests import every
module of the package on a machine without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "point_sam_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-lineinfo",
)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C signatures (argtypes) of every entry point in csrc/.
_SIGNATURES = {
    "psam_fps_interp": [_P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P],
    "psam_patch_encoder": [_P, _I, _I, _I, _I,
                           _P, _P, _P, _P, _P, _P,
                           _P, _P, _P, _P, _P, _P,
                           _I, _I, _I, _P, _P, _P, _P, _I, _I, _P],
    "psam_attention": [_P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _I, _P],
    "psam_interp_upscale": [_P, _P, _P, _P, _P, _P, _P, _P, _P,
                            _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "psam_attention_bwd": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _I,
                           _P],
    "psam_patch_encoder_bwd": [_P, _P, _P, _P, _P, _I, _I, _I, _I,
                               _P, _P, _P, _P, _P, _P,
                               _P, _P, _P, _P,
                               _P, _P, _P, _P, _P,
                               _I, _I, _I, _P, _P, _P, _I, _P, _I, _I, _I, _P],
    "psam_patch_encoder_bwd_slices": [_I],
    "psam_patch_encoder_bwd_route": [_I, _I, _I, _I, _I, _I],
    "psam_fps": [_P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P],
    "psam_interp_weights": [_P, _P, _I, _I, _I, _F, _P, _P, _P],
    "psam_attention_heads": [_P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _I, _P],
    "psam_upscale_hyper": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "psam_knn_bins": [_P, _P, _P, _I, _I, _I, _I, _P, _P, _P],
    "psam_knn_select": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                        _P, _P, _P],
}


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (PATH or /usr/local/cuda/bin)")
    return found


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def build() -> Path:
    """Compile csrc/ into the hashed build directory (no-op when built)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    out_dir = BUILD_ROOT / h.hexdigest()[:16]
    lib_path = out_dir / "libpsam_kernels.so"
    if lib_path.exists():
        return lib_path
    out_dir.mkdir(parents=True, exist_ok=True)
    # The ranks of a multi-process run share one build: the first to take
    # the lock compiles, the others wait and load its library.
    with open(out_dir / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not lib_path.exists():
            _compile(out_dir, lib_path)
    return lib_path


def _compile(out_dir: Path, lib_path: Path) -> None:
    tag = os.getpid()
    nvcc = _nvcc()
    jobs = []
    for src in (s for s in _sources() if s.suffix == ".cu"):
        obj = out_dir / f"{src.stem}.{tag}.o"
        jobs.append((src.name, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), obj))
    errors = []
    for name, proc, _ in jobs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"{name} ({proc.returncode}):\n{out}")
    if errors:
        raise RuntimeError("nvcc failed: " + "\n".join(errors))
    tmp = out_dir / f"libpsam_kernels.{tag}.so"
    link = subprocess.run([nvcc, "-shared", "-o", str(tmp), *(str(o) for *_, o in jobs)],
                          capture_output=True, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({link.returncode}):\n"
                           f"{link.stdout}\n{link.stderr}")
    for *_, obj in jobs:
        obj.unlink()
    os.replace(tmp, lib_path)  # atomic: a concurrent loader never sees half a file


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.psam_error_string.argtypes = [ctypes.c_int]
    lib.psam_error_string.restype = ctypes.c_char_p
    return lib


def check(name: str, code: int) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if code != 0:
        msg = library().psam_error_string(code).decode()
        raise RuntimeError(f"{name}: CUDA error {code}: {msg}")


def ptr(t: torch.Tensor | None):
    """Device pointer of a tensor (None -> NULL)."""
    return None if t is None else t.data_ptr()


def stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def resolve_device(device=None) -> torch.device:
    """The device of an entry point (Predictor, evaluator, server,
    trainer): ``cuda`` unless another is named; no silent CPU fallback."""
    dev = torch.device(device or "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError('no CUDA device: pass device="cpu" (--device cpu) to run on the CPU')
    return dev


def require_cuda(*tensors: torch.Tensor) -> None:
    """Raise unless every tensor is a contiguous CUDA tensor."""
    for t in tensors:
        if not t.is_cuda:
            raise ValueError("kernel input is not a CUDA tensor")
        if not t.is_contiguous():
            raise ValueError("kernel input is not contiguous")


def counted(wrapper):
    """Give a kernel wrapper its launch counters: ``launches`` in all and
    ``shapes``, the launches by shape and dtype (see ``count_launch``)."""
    wrapper.launches = 0
    wrapper.shapes = {}
    return wrapper


def count_launch(wrapper, **shape) -> None:
    """Tally one launch of ``wrapper``'s kernel. ``shape`` names the sizes
    and dtypes that fix the launch; a check can rebuild inputs from it."""
    wrapper.launches += 1
    key = tuple(shape.items())
    wrapper.shapes[key] = wrapper.shapes.get(key, 0) + 1


def dtype_code(dtype: torch.dtype) -> int:
    """0 = float32, 1 = bfloat16: the compute-dtype switch of csrc/."""
    if dtype == torch.float32:
        return 0
    if dtype == torch.bfloat16:
        return 1
    raise ValueError(f"kernels take float32 or bfloat16, got {dtype}")
