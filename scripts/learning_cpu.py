#!/usr/bin/env python3
"""The learning check of ``chip_smoke.py`` (phase 17l) through both trainer
CLIs on the CPU, for the JAX reference and the port side by side.

    python scripts/learning_cpu.py [--steps 640] [--seeds 42 7]
        [--packages jax port] [--threads 2] [--init own|port] [--extra K=V ...]
        [--out FILE]

For each package and seed, runs ``python -m <package>.train.trainer --config
tiny`` with phase 17l's overrides (``chip_smoke.learning_overrides``: the
synthetic set with colours normalised, 8 clouds a step, 4096-point scenes,
one epoch of ``--steps`` steps, validation on 64 scenes at its end) and
``seed=<seed>``, each a process of its own on ``--threads`` CPU threads.
Before that, the same command at ``lr=0.0`` for 4 steps gives the untrained
model's validation (AdamW at rate 0 leaves every weight as initialised).
With ``--init port`` both trainers start from the port's initial weights at
the seed (``port_init``, through ``pretrained_ckpt_path``), so the two
packages differ only in how they train, not in how they initialise.
``--extra`` adds overrides to both (say ``log_freq=1`` to record every
step's loss). Prints each run's validation (IoU by click, best-of-multimask
IoU) and its seconds, and writes them, with the logged losses by step, as
JSON to FILE (default
``build/learning_cpu.json``).
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
MODULES = {"jax": "point_sam_tpu.train.trainer", "port": "point_sam_tpu_torch.train.trainer"}
VAL = re.compile(r"val/(\S+?)=([-0-9.naif]+)")
LOSS = re.compile(r"\[step (\d+)\] .*train/loss=([-0-9.naif]+)")


def port_init(seed) -> Path:
    """The port trainer's initial weights at ``seed`` on the CPU, written
    as a reference-format ``.safetensors`` file (the port's keys are the
    reference's), for either trainer's ``pretrained_ckpt_path``."""
    import torch

    from point_sam_tpu_torch.utils.config import build_model, load_config
    from point_sam_tpu_torch.utils.safetensors_io import save_file

    path = ROOT / "build" / f"learning_init_{seed}.safetensors"
    model = build_model(load_config("tiny").model, generator=torch.Generator().manual_seed(seed))
    save_file({k: v.detach().float() for k, v in model.state_dict().items()}, path)
    return path


def run(package, seed, steps, threads, extra=()) -> dict:
    from chip_smoke import learning_overrides
    from point_sam_tpu_torch.utils.config import load_config

    with tempfile.TemporaryDirectory(dir=ROOT / "build") as run_dir:
        cmd = [sys.executable, "-m", MODULES[package], "--config", "tiny",
               *(["--device", "cpu"] if package == "port" else []),
               *learning_overrides(load_config, Path(run_dir), steps), f"seed={seed}",
               "vis_freq=0", *extra]
        env = dict(os.environ, PSAM_CPU="1", JAX_PLATFORMS="cpu", OMP_NUM_THREADS=str(threads),
                   CUDA_VISIBLE_DEVICES="")
        t0 = time.perf_counter()
        out = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True)
        secs = time.perf_counter() - t0
    if out.returncode:
        raise SystemExit(f"{package} seed {seed}: exit {out.returncode}\n{out.stderr[-4000:]}")
    lines = out.stdout.splitlines()
    val = {k: float(v) for line in lines if "val/" in line for k, v in VAL.findall(line)}
    notes = [line for line in lines if line.startswith(("warning", "initialized"))]
    losses = {int(m[1]): float(m[2]) for m in map(LOSS.match, lines) if m}
    return dict(package=package, seed=seed, steps=steps, val=val, seconds=round(secs, 1),
                notes=notes, losses=losses)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=640)
    ap.add_argument("--seeds", type=int, nargs="+", default=[42, 7])
    ap.add_argument("--packages", nargs="+", default=["jax", "port"], choices=sorted(MODULES))
    ap.add_argument("--threads", type=int, default=2)
    ap.add_argument("--extra", nargs="*", default=[],
                    help="more overrides for both trainers (k=v)")
    ap.add_argument("--init", choices=("own", "port"), default="own",
                    help="own: each trainer initialises from the seed; port: both start "
                         "from the port's initial weights at the seed (port_init)")
    ap.add_argument("--out", type=Path, default=ROOT / "build" / "learning_cpu.json")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    (ROOT / "build").mkdir(exist_ok=True)
    results = []
    for package in args.packages:
        for seed in args.seeds:
            init = ((f"pretrained_ckpt_path={port_init(seed)}",) if args.init == "port"
                    else ())
            for label, steps, extra in (("untrained", 4, ("lr=0.0", *init, *args.extra)),
                                        ("trained", args.steps, (*init, *args.extra))):
                r = dict(run(package, seed, steps, args.threads, extra), run=label,
                         init=args.init)
                results.append(r)
                by_click = " / ".join(f"{r['val'].get(f'iou({i})', float('nan')):.4f}"
                                      for i in range(3))
                print(f"{package} seed {seed} {label} ({steps} steps, {r['seconds']} s): IoU by "
                      f"click {by_click}, best multimask "
                      f"{r['val'].get('best_multimask_iou', float('nan')):.4f}", flush=True)
                args.out.write_text(json.dumps(results, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
