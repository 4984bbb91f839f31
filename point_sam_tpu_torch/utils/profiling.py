"""Tracing and profiling hooks (counterpart of point_sam_tpu/utils/profiling.py).

- ``trace(log_dir)``: ``torch.profiler`` over the block, CPU activity and,
  where a CUDA device is present, the device's kernels; on exit it writes
  ``<worker>.<time>.pt.trace.json`` into ``log_dir``, a Chrome trace that
  TensorBoard's profiler plugin and Perfetto load.
- ``annotate(name)``: a named range in that trace
  (``torch.profiler.record_function``).
- ``StageTimer``: wall-clock time by named stage; ``stage(name, sync_on=...)``
  synchronises the CUDA devices of the given tensors before it stops the
  clock, so asynchronous launches do not hide device time.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block and write its trace into ``log_dir``."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=acts,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(str(log_dir))):
        yield


def annotate(name: str):
    return torch.profiler.record_function(name)


def _cuda_devices(tree) -> set:
    if isinstance(tree, torch.Tensor):
        return {tree.device} if tree.is_cuda else set()
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return set().union(*(_cuda_devices(t) for t in tree))
    return set()


class StageTimer:
    """Accumulates wall-clock time per named stage."""

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str, sync_on=None):
        """Time the block; with ``sync_on`` (a tensor, or nested lists,
        tuples and dicts of them), wait for the CUDA devices they lie on
        first."""
        t0 = time.perf_counter()
        yield
        for dev in _cuda_devices(sync_on):
            torch.cuda.synchronize(dev)
        self.totals[name] += time.perf_counter() - t0
        self.counts[name] += 1

    def summary(self) -> dict:
        return {
            name: dict(
                total_s=round(self.totals[name], 4),
                mean_ms=round(self.totals[name] / max(self.counts[name], 1) * 1e3, 3),
                count=self.counts[name],
            )
            for name in sorted(self.totals)
        }

    def report(self) -> str:
        return "\n".join(f"{name:32s} {s['mean_ms']:10.2f} ms x{s['count']}"
                         for name, s in self.summary().items())
