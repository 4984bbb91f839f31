"""Dataset construction and fixed-shape batch iteration (the port's own copy
of point_sam_tpu/datasets/build.py, numpy only), with the per-rank slices
of a multi-process run.

The batcher yields numpy batches (coords [B,N,3], features [B,N,C],
gt_masks [B,M,N]) of constant N and M, as the transform chain guarantees.
"""

from __future__ import annotations

import numpy as np

from .synthetic import SyntheticDataset
from .transforms import build_transforms

_HF_RENAMES = {"xyz": "coords", "rgb": "features", "mask": "gt_masks"}


class HFDataset:
    """A huggingface ``datasets`` split (needs the network and the
    ``datasets`` package; imported when built)."""

    def __init__(self, path: str, split: str = "train", transform=None, **load_kwargs):
        import datasets as hfd

        ds = hfd.load_dataset(path, split=split, **load_kwargs)
        renames = {k: v for k, v in _HF_RENAMES.items() if k in ds.column_names}
        if renames:
            ds = ds.rename_columns(renames)
        self.ds = ds.select_columns(["coords", "features", "gt_masks"])
        self.transform = transform

    def __len__(self):
        return len(self.ds)

    def __getitem__(self, i):
        return self.get(i)

    def get(self, i, rng=None):
        """Fetch + transform one example; ``rng`` seeds the random transforms."""
        ex = {k: np.asarray(v) for k, v in self.ds[int(i)].items()}
        if self.transform is None:
            return ex
        if rng is not None:
            ex["_rng"] = rng
        ex = self.transform(ex)
        ex.pop("_rng", None)
        return ex


class ConcatDataset:
    """A mixture of datasets, indexed one after the other."""

    def __init__(self, datasets: list):
        self.datasets = list(datasets)
        self.offsets = np.cumsum([0] + [len(d) for d in self.datasets])

    def __len__(self):
        return int(self.offsets[-1])

    def __getitem__(self, i):
        return self.get(i)

    def get(self, i, rng=None):
        if not 0 <= i < len(self):
            raise IndexError(i)
        d = int(np.searchsorted(self.offsets, i, side="right") - 1)
        return self.datasets[d].get(i - int(self.offsets[d]), rng=rng)


def build_dataset(ds_cfg: dict, *, seed: int = 0, context: dict | None = None):
    """One dataset (or a mixture) from a configs/dataset/*.yaml dict;
    ``context`` carries run-level interpolation values (``num_samples``)."""
    if "dataset_dict" in ds_cfg:
        from ..utils.config import load_config

        return ConcatDataset([
            build_dataset(load_config(f"dataset/{item}", context=context), seed=seed,
                          context=context)
            for item in ds_cfg["dataset_dict"].values()])
    spec = dict(ds_cfg["dataset"])
    transform = build_transforms(ds_cfg.get("transforms", []), rng=np.random.default_rng(seed))
    source = spec.pop("source", "hf")
    if source == "synthetic":
        return SyntheticDataset(num_scenes=spec.get("num_scenes", 512),
                                points_per_scene=spec.get("points_per_scene", 32768),
                                seed=spec.get("seed", 0), transform=transform)
    if source == "hf":
        spec.pop("token", None)
        return HFDataset(transform=transform, **spec)
    raise ValueError(f"unknown dataset source {source!r}")


class FlatMaskDataset:
    """One (cloud, mask) pair per row, through a precomputed flat index
    (the reference's ``FuseDatasetVal`` with its (point, mask) mapping,
    pc_sam/datasets/fuse_data.py:195-240): validation visits every instance
    mask of every scene once, in a fixed order. Row i is scene
    ``mapping[i, 0]`` with only its mask ``mapping[i, 1]`` ([1, N])."""

    def __init__(self, dataset, mapping=None):
        self.dataset = dataset
        if mapping is None:
            from .preprocess import build_val_mapping

            mapping = build_val_mapping(dataset)
        self.mapping = np.asarray(mapping)

    def __len__(self):
        return len(self.mapping)

    def __getitem__(self, i):
        return self.get(i)

    def get(self, i, rng=None):
        scene_idx, mask_idx = self.mapping[i]
        ds = self.dataset
        ex = dict(ds.get(int(scene_idx), rng=rng) if hasattr(ds, "get")
                  else ds[int(scene_idx)])
        ex["gt_masks"] = np.asarray(ex["gt_masks"])[int(mask_idx)][None]
        return ex


class BatchIterator:
    """Shuffling fixed-shape batcher with threaded prefetch.

    Every example is transformed with its own Generator seeded from
    ``SeedSequence([seed, epoch, index])``, so batches are the same for any
    ``num_workers`` (0 included) and the same as the JAX package's.

    Multi-process runs: ``batch_size`` is the GLOBAL batch and must divide
    by ``process_count``; every rank shuffles with the same seed and takes
    its contiguous slice ``[r * B / W, (r + 1) * B / W)`` of each global
    batch, and a short last batch is dropped (it cannot split evenly).
    """

    def __init__(self, dataset, batch_size: int, *, shuffle=True, drop_last=True,
                 seed: int = 0, num_workers: int | None = None, prefetch: int = 2,
                 process_index: int = 0, process_count: int = 1):
        import os

        if batch_size % max(process_count, 1):
            raise ValueError(f"global batch_size {batch_size} not divisible by "
                             f"process_count {process_count}")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.process_index = process_index
        self.process_count = max(process_count, 1)
        self.rng = np.random.default_rng(seed)
        self.num_workers = min(8, os.cpu_count() or 1) if num_workers is None else num_workers
        self.prefetch = prefetch
        self._epoch = 0

    def __len__(self):
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def skip_epoch(self):
        """Pass over one epoch without loading it: every later epoch's order
        and per-example seeds are as if it had been iterated."""
        self._epoch += 1
        if self.shuffle:
            self.rng.shuffle(np.arange(len(self.dataset)))

    def _fetch(self, i: int, epoch: int):
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, epoch, int(i)]))
        return self.dataset.get(int(i), rng=rng)

    @staticmethod
    def _stack(examples):
        return {k: np.stack([e[k] for e in examples]) for k in examples[0]}

    def __iter__(self):
        epoch = self._epoch
        self._epoch += 1
        order = np.arange(len(self.dataset))
        if self.shuffle:
            self.rng.shuffle(order)
        bs = self.batch_size
        end = len(order) - (len(order) % bs if self.drop_last else 0)
        batches = [order[s:s + bs] for s in range(0, end, bs)]
        if self.process_count > 1:
            loc = bs // self.process_count
            lo = self.process_index * loc
            batches = [idx[lo:lo + loc] for idx in batches if len(idx) == bs]
        if self.num_workers == 0:
            for idx in batches:
                yield self._stack([self._fetch(i, epoch) for i in idx])
            return

        from collections import deque
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(self.num_workers) as pool:
            pending: deque = deque()
            it = iter(batches)
            for _ in range(self.prefetch + 1):
                nxt = next(it, None)
                if nxt is None:
                    break
                pending.append([pool.submit(self._fetch, i, epoch) for i in nxt])
            while pending:
                futs = pending.popleft()
                nxt = next(it, None)
                if nxt is not None:
                    pending.append([pool.submit(self._fetch, i, epoch) for i in nxt])
                yield self._stack([f.result() for f in futs])
