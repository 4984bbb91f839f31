#!/usr/bin/env python3
"""Tensor parallelism and the point-sharded evaluator of the PyTorch port,
one process a rank under ``torchrun``.

    torchrun --nproc_per_node=W scripts/tensor_parallel.py encode [--config voronoi_giant]
        [--points 100000] [--ckpt_path FILE]
    torchrun --nproc_per_node=W scripts/tensor_parallel.py train [--config large]
        [--n_data D] [--steps 3] [overrides ...]    # e.g. train_dataset.dataset.source=synthetic
    torchrun --nproc_per_node=W scripts/tensor_parallel.py eval --scene_dir DIR
        [--config large] [--ckpt_path FILE] [--point_buckets 8192,32768,131072,262144]

``encode``: the config's model with its ViT split over the W ranks
(``parallel.tensor_parallel.shard_model``) in a bf16 ``Predictor`` on a
synthetic cloud of ``--points`` points: set_pointcloud and one click.
``train``: the config's recipe on a grid of D data groups x W / D model
ranks (``tp_groups``), each data group loading its slice of every global
batch, ``--steps`` steps of ``train_step``. ``eval``: ``evaluate_directory``
with ``group`` the W ranks: scenes at or above the top bucket run
point-sharded. Rank 0 prints.

Devices: ``--device cuda`` (default) puts rank r on ``cuda:{LOCAL_RANK}``
over NCCL; ``--device cuda:0 --backend gloo`` puts every rank on one card
over gloo (NCCL takes one rank a card); ``--device cpu`` runs gloo ranks on
the CPU (with ``model.vit=tiny`` and small patches for a quick run).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from point_sam_tpu_torch.parallel import distributed as D  # noqa: E402
from point_sam_tpu_torch.parallel import tp_groups, tp_shard_model  # noqa: E402
from point_sam_tpu_torch.utils.config import build_model, load_config  # noqa: E402

DEFAULT_CONFIG = {"encode": "voronoi_giant", "train": "large", "eval": "large"}


def say(*args):
    if D.is_main_process():
        print(*args, flush=True)


def model_of(cfg, dev, ckpt_path=None, dtype=None):
    from point_sam_tpu_torch.utils import checkpoint

    model = build_model(cfg.model, device=dev, dtype=dtype,
                        generator=torch.Generator(dev).manual_seed(cfg.get("seed", 0)))
    if ckpt_path:
        checkpoint.load_weights(ckpt_path, model)
    return model


def encode(args, cfg, dev):
    from point_sam_tpu_torch.datasets.synthetic import generate_scene
    from point_sam_tpu_torch.evalsuite.eval_interactive import normalize_scene
    from point_sam_tpu_torch.serving import Predictor

    model = tp_shard_model(model_of(cfg, dev, args.ckpt_path), tp_groups(1, D.process_count()))
    pred = Predictor(model, device=dev)
    ex = generate_scene(0, num_points=args.points)
    xyz, rgb = normalize_scene(ex["coords"], ex["features"])
    for _ in range(2):  # the second encode is timed
        t0 = time.perf_counter()
        pred.set_pointcloud(xyz, rgb)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
    _, scores, logits = pred.predict_masks(xyz[:1], [1])
    say(f"encode: {type(model).__name__} over {D.process_count()} ranks on {dev}, "
        f"{args.points} points: {ms:.1f} ms; embeddings {tuple(pred._state['emb'].shape)}; "
        f"first click's IoU predictions {np.round(scores, 4).tolist()}")


def train(args, cfg, dev):
    from point_sam_tpu_torch.parallel import train_step
    from point_sam_tpu_torch.train.trainer import (
        load_pretrained,
        recipe_criterion,
        recipe_optimizer,
        to_device,
        train_iterator,
    )

    world = D.process_count()
    groups = tp_groups(args.n_data, world // args.n_data)
    dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
    model = model_of(cfg, dev, dtype=dtype)
    if cfg.get("pretrained_ckpt_path"):
        load_pretrained(cfg.pretrained_ckpt_path, model)
    model = tp_shard_model(model, groups)
    seed = cfg.get("seed", 42)
    _, it = train_iterator(cfg, seed, groups.data_rank, groups.n_data)
    tx, _ = recipe_optimizer(cfg, model.parameters())
    crit = recipe_criterion(cfg)
    clicks = torch.Generator().manual_seed(seed + 2)
    step = 0
    while step < args.steps:
        for batch in it:
            t0 = time.perf_counter()
            loss = float(train_step(model, tx, to_device(batch, dev), clicks, criterion=crit)["loss"])
            step += 1
            say(f"[step {step}] {groups.n_data} x {groups.n_model} ranks: loss {loss:.5f}, "
                f"{(time.perf_counter() - t0) * 1e3:.1f} ms")
            if step == args.steps:
                break


def evaluate(args, cfg, dev):
    from point_sam_tpu_torch.evalsuite.eval_interactive import evaluate_directory

    model = model_of(cfg, dev, args.ckpt_path)
    kw = {}
    if args.point_buckets:
        kw["point_buckets"] = tuple(int(b) for b in args.point_buckets.split(","))
    report = evaluate_directory(model, args.scene_dir, device=dev, group=dist.group.WORLD, **kw)
    say(json.dumps(report, indent=2))


def main(argv=None):
    parser = argparse.ArgumentParser(prog="scripts/tensor_parallel.py")
    parser.add_argument("task", choices=sorted(DEFAULT_CONFIG))
    parser.add_argument("--config", default=None)
    parser.add_argument("--device", default=None, help="cuda (default), cuda:N or cpu")
    parser.add_argument("--backend", default=None, help="nccl on cuda, gloo on the CPU")
    parser.add_argument("--n_data", type=int, default=1, help="data groups (train)")
    parser.add_argument("--points", type=int, default=100_000)
    parser.add_argument("--steps", type=int, default=3)
    parser.add_argument("--scene_dir", default=None)
    parser.add_argument("--ckpt_path", default=None)
    parser.add_argument("--point_buckets", default=None, help="the evaluator's, comma-separated")
    parser.add_argument("overrides", nargs="*", default=[])
    # Options may stand between the task and the overrides (without
    # intermixing, some Python 3.12 releases' argparse then rejects them).
    args = parser.parse_intermixed_args(argv)
    if args.task == "eval" and not args.scene_dir:
        parser.error("eval needs --scene_dir")
    dev = D.initialize(device=args.device, backend=args.backend)
    cfg = load_config(args.config or DEFAULT_CONFIG[args.task], args.overrides)
    {"encode": encode, "train": train, "eval": evaluate}[args.task](args, cfg, dev)
    D.shutdown()


if __name__ == "__main__":
    main()
