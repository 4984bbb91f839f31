"""Tiny configurations and traffic of the harness's CPU tests."""

import copy
import json
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def config(name: str) -> dict:
    """The cell's configuration at tiny widths: a 2-block ViT of 128
    (two heads of 64, the packed attention path), few centres."""
    cfg = copy.deepcopy(json.loads((HERE / "configs" / f"{name}.json").read_text()))
    vit = cfg["model"]["vit"]
    vit.update(embed_dim=128, depth=2, num_heads=2, mlp_hidden_dim=256)
    tok = cfg["model"]["tokenizer"]
    tok["num_patches"] = 32
    if "patch_size" in tok:
        tok["patch_size"] = 16
    return cfg


def traffic(mix: str) -> dict:
    """The mix at a tiny load: 600-point clouds, few sessions of 3 clicks."""
    t = json.loads((HERE / "traffic" / f"{mix}.json").read_text())
    t.update(clouds=2, points=600, plans_per_cloud=2, clicks=3, warmup_sessions=1,
             check_sessions=2, traced_sessions=1)
    return t
