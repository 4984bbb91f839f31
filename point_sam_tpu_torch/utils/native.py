"""ctypes bindings of the native C++ host-side geometry library
(counterpart of point_sam_tpu/utils/native.py).

``csrc/psam_native.cpp`` of this package is compiled at first use,

    g++ -O3 -march=native -std=c++17 -shared -fPIC -pthread psam_native.cpp

into ``build/point_sam_tpu_torch/<hash>/libpsam_native.so`` under the
repository root, keyed by a hash of the source, the flags and the host's
CPU (``-march=native`` code runs only on CPUs like the one that built it),
and bound with ``ctypes``. Where it cannot be built, the call raises with
the compiler's output: there is no silent fallback. The numpy bodies are
the plain versions (``fps_plain``, ``knn_plain``, ``chamfer_plain``,
``normalize_plain``) that the tests hold the library against.

Used for data preprocessing and the evaluation tooling, and as a ground
truth for the card's FPS (K8) and kNN (K12) that shares no code with them.
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import platform
import subprocess
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parents[1] / "csrc" / "psam_native.cpp"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "point_sam_tpu_torch"
CXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-shared", "-fPIC", "-pthread")

_F32P = ctypes.POINTER(ctypes.c_float)
_I32P = ctypes.POINTER(ctypes.c_int32)
_I64 = ctypes.c_int64


def _host_cpu() -> str:
    """The CPU model and its instruction-set flags (Linux), else the
    platform's processor string."""
    try:
        info = Path("/proc/cpuinfo").read_text()
    except OSError:
        return platform.processor()
    keep = [ln for ln in info.splitlines() if ln.startswith(("model name", "flags"))]
    return "\n".join(dict.fromkeys(keep))


def build() -> Path:
    """Compile the library into its hashed build directory (no-op when built)."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(_host_cpu().encode())
    h.update(SRC.read_bytes())
    out_dir = BUILD_ROOT / h.hexdigest()[:16]
    lib_path = out_dir / "libpsam_native.so"
    if lib_path.exists():
        return lib_path
    out_dir.mkdir(parents=True, exist_ok=True)
    with open(out_dir / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not lib_path.exists():
            tmp = out_dir / f"libpsam_native.{os.getpid()}.so"
            try:
                res = subprocess.run(["g++", *CXX_FLAGS, str(SRC), "-o", str(tmp)],
                                     capture_output=True, text=True, timeout=300)
            except (OSError, subprocess.TimeoutExpired) as e:
                raise RuntimeError(f"psam_native: g++ did not run: {e}") from e
            if res.returncode != 0:
                raise RuntimeError(f"psam_native: g++ failed ({res.returncode}):\n"
                                   f"{res.stdout}{res.stderr}")
            os.replace(tmp, lib_path)  # atomic: a concurrent loader never sees half a file
    return lib_path


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded library, built on first call."""
    lib = ctypes.CDLL(str(build()))
    lib.psam_fps.argtypes = [_F32P, _I64, _I64, _I32P]
    lib.psam_fps.restype = None
    lib.psam_knn.argtypes = [_F32P, _I64, _F32P, _I64, _I64, _I32P, _F32P]
    lib.psam_knn.restype = None
    lib.psam_chamfer.argtypes = [_F32P, _I64, _F32P, _I64, _F32P]
    lib.psam_chamfer.restype = None
    lib.psam_normalize.argtypes = [_F32P, _I64, _F32P]
    lib.psam_normalize.restype = ctypes.c_float
    lib.psam_version.argtypes = []
    lib.psam_version.restype = ctypes.c_int
    return lib


def _points(x, name: str) -> np.ndarray:
    a = np.ascontiguousarray(x, dtype=np.float32)
    if a.ndim != 2 or a.shape[1] != 3:
        raise ValueError(f"{name}: expected [n, 3] points, got shape {a.shape}")
    return a


def _f32(a: np.ndarray):
    return a.ctypes.data_as(_F32P)


def _i32(a: np.ndarray):
    return a.ctypes.data_as(_I32P)


def fps_cpu(points: np.ndarray, num_samples: int) -> np.ndarray:
    """[N, 3] -> [G] int32: start at point 0, then the point farthest from
    those chosen, the first index among equals (the rule of ``ops.fps``)."""
    pts = _points(points, "fps_cpu")
    if not 0 < num_samples <= len(pts):
        raise ValueError(f"fps_cpu: num_samples={num_samples} of {len(pts)} points")
    out = np.zeros(num_samples, np.int32)
    library().psam_fps(_f32(pts), len(pts), num_samples, _i32(out))
    return out


def knn_cpu(query: np.ndarray, key: np.ndarray, k: int):
    """Exact kNN -> (d2 [Nq, k] f32, idx [Nq, k] int32), ascending."""
    q, kk = _points(query, "knn_cpu query"), _points(key, "knn_cpu key")
    if not 0 < k <= len(kk):
        raise ValueError(f"knn_cpu: k={k} of {len(kk)} keys")
    idx = np.zeros((len(q), k), np.int32)
    d2 = np.zeros((len(q), k), np.float32)
    library().psam_knn(_f32(q), len(q), _f32(kk), len(kk), k, _i32(idx), _f32(d2))
    return d2, idx


def chamfer_cpu(src: np.ndarray, tgt: np.ndarray) -> np.ndarray:
    """One-directional chamfer: per-src min squared distance to tgt."""
    s, t = _points(src, "chamfer_cpu src"), _points(tgt, "chamfer_cpu tgt")
    if len(t) == 0:
        raise ValueError("chamfer_cpu: no target points")
    out = np.zeros(len(s), np.float32)
    library().psam_chamfer(_f32(s), len(s), _f32(t), len(t), _f32(out))
    return out


def normalize_cpu(points: np.ndarray):
    """Unit-sphere normalisation -> (points, shift, scale): the points less
    their centroid, over their largest norm."""
    pts = _points(points, "normalize_cpu").copy()
    if len(pts) == 0:
        raise ValueError("normalize_cpu: no points")
    shift = np.zeros(3, np.float32)
    scale = library().psam_normalize(_f32(pts), len(pts), _f32(shift))
    return pts, shift, float(scale)


# ------------------------------------------------------------ plain versions


def fps_plain(points: np.ndarray, num_samples: int) -> np.ndarray:
    pts = np.asarray(points, np.float32)
    mind = np.full(len(pts), np.inf, np.float32)
    out = np.zeros(num_samples, np.int32)
    sel = 0
    for s in range(1, num_samples):
        mind = np.minimum(mind, ((pts - pts[sel]) ** 2).sum(-1))
        sel = int(np.argmax(mind))
        out[s] = sel
    return out


def knn_plain(query: np.ndarray, key: np.ndarray, k: int):
    q, kk = np.asarray(query, np.float32), np.asarray(key, np.float32)
    d = ((q[:, None, :] - kk[None, :, :]) ** 2).sum(-1)
    idx = np.argsort(d, axis=1, kind="stable")[:, :k].astype(np.int32)
    return np.take_along_axis(d, idx, 1).astype(np.float32), idx


def chamfer_plain(src: np.ndarray, tgt: np.ndarray) -> np.ndarray:
    s, t = np.asarray(src, np.float32), np.asarray(tgt, np.float32)
    return ((s[:, None, :] - t[None, :, :]) ** 2).sum(-1).min(1)


def normalize_plain(points: np.ndarray):
    pts = np.asarray(points, np.float32)
    shift = pts.mean(0)
    pts = pts - shift
    scale = float(np.linalg.norm(pts, axis=1).max())
    return pts / max(scale, 1e-12), shift, scale
