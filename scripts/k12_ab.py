#!/usr/bin/env python3
"""Kernel K12 of two checkouts of the repository on one CUDA card, in turns.

    python scripts/k12_ab.py PARENT_DIR CHANGE_DIR [--out FILE]

Runs each checkout in the order parent, change, change, parent, each run a
process of its own (both packages are named ``point_sam_tpu_torch``), with
that checkout's own kernels and ``chip_smoke.py`` helpers:

- K12 (``knn_case``, through ``check_kernels``: bit for bit against
  ``knn_select_plain``, then CUDA events, median of 5, with and without the
  host's call) at the serve shape ([1, 2048] x [1, 131072], 100k valid keys,
  k=256, exact), hier's ([1, 2048] x [1, 131072], k=32), hier4096's
  ([1, 4096] x [1, 131072], k=32), train's ([2, 1024] x [2, 10000], k=256),
  and in approximate mode at the serve shape over 4096 and 8192 bins
  (recall against the exact mode printed);
- one profiled encode (``profile_encode``, chip_smoke phase 16: device ms by
  stage under torch.profiler) of the ViT-L, the hier and the hier4096
  serving paths, each on its model built anew from a seed.

Prints the card's name and power limit and every run's lines, prefixed
with the run, and writes the K12 rows of every run as JSON to FILE
(default ``build/k12_ab.json``). Either checkout may be the same tree
twice.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

KEYS = (
    dict(B=1, Nq=2048, Nk=131072, k=256, valid=True, bins=None),
    dict(B=1, Nq=2048, Nk=131072, k=32, valid=True, bins=None),
    dict(B=1, Nq=4096, Nk=131072, k=32, valid=True, bins=None),
    dict(B=2, Nq=1024, Nk=10000, k=256, valid=False, bins=None),
    dict(B=1, Nq=2048, Nk=131072, k=256, valid=True, bins=4096, rt=0.9),
    dict(B=1, Nq=2048, Nk=131072, k=256, valid=True, bins=8192, rt=0.95),
)


def one(root: Path) -> None:
    """K12 and the three encodes of the checkout at ``root``; its rows as
    one JSON line (``K12_AB_ROWS``) at the end."""
    import importlib

    import numpy as np
    import torch

    sys.path.insert(0, str(root))
    CS = importlib.import_module("chip_smoke")
    from point_sam_tpu_torch import models as P
    from point_sam_tpu_torch.ops import _cuda
    from point_sam_tpu_torch.utils.config import build_model, load_config

    _cuda.library()
    CS.resource_usage(_cuda.build())
    mods = [importlib.import_module(f"point_sam_tpu_torch.ops.{m}")
            for m in ("fps", "patch_encoder_pallas", "attention", "upscale_pallas",
                      "interp_pallas", "knn")]
    F, PE, A, UP, IW, K = mods
    counters = {"K1": F.fps_interp_cuda, "K2": PE.patch_encoder_cuda, "K3": A.mha_cuda,
                "K4": UP.interp_upscale_cuda, "K5": A.mha_heads_cuda,
                "K8": F.fps_cuda, "K9": F.fps_interp_knn_cuda, "K10": IW.interp_weights_cuda,
                "K11": UP.upscale_hyper_cuda, "K12": K.knn_select_cuda}
    rows = CS.check_kernels(torch, np, mods, {"K12": {tuple(k.items()): 0 for k in KEYS}}, "ab")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    vit_l = P.PointCloudSAM(P.PointSAMConfig(vit="eva02_large"), dtype=torch.bfloat16,
                            device=dev, generator=gen.manual_seed(0))
    CS.profile_encode(torch, np, vit_l, "flagship ViT-L", counters)
    del vit_l
    for label, override in (("hier EVA02-L", {}),
                            ("hier EVA02-L, group_number=4096", {"group_number": 4096})):
        hier = build_model(load_config("model/hier"), device="cuda", generator=gen.manual_seed(0))
        CS.profile_encode(torch, np, hier, label, counters, **override)
        del hier
        torch.cuda.empty_cache()
    print("K12_AB_ROWS " + json.dumps(rows), flush=True)


def main(argv: list[str]) -> int:
    if argv[:1] == ["--one"]:
        one(Path(argv[1]).resolve())
        return 0
    out = Path("build/k12_ab.json")
    if "--out" in argv:
        at = argv.index("--out")
        out = Path(argv[at + 1])
        argv = argv[:at] + argv[at + 2:]
    parent, change = (Path(a).resolve() for a in argv)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    record = {"card": smi, "runs": []}
    for n, (label, root) in enumerate((("parent", parent), ("change", change),
                                       ("change", change), ("parent", parent)), 1):
        tag = f"run {n} ({label})"
        proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--one", str(root)],
                              capture_output=True, text=True, cwd=root, timeout=900)
        rows = None
        for line in proc.stdout.splitlines():
            if line.startswith("K12_AB_ROWS "):
                rows = json.loads(line[len("K12_AB_ROWS "):])
            else:
                print(f"{tag}: {line}", flush=True)
        if proc.returncode != 0:
            print(f"{tag}: exit {proc.returncode}\n{proc.stderr[-4000:]}", flush=True)
            return 1
        record["runs"].append({"run": n, "tree": label, "rows": rows})
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(record, indent=1, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
