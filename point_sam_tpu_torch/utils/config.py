"""YAML config system with groups, defaults composition and CLI overrides
(the port's own copy of point_sam_tpu/utils/config.py; it reads the repo's
``configs/``).

Keeps the reference's config *surface* — hydra config groups ``model/``,
``dataset/``, ``loss/`` composed by a top-level file, with CLI dotlist
overrides (reference: train.py:65,70-72, configs/*.yaml) — without the
hydra dependency. Features supported:

- ``defaults: {model: large, train_dataset: partnet, ...}``: each entry
  loads ``configs/<group-dir>/<name>.yaml`` under key ``<group>`` (group
  keys may rename the dir via ``group@key`` syntax like hydra's
  ``dataset@train_dataset``).
- ``${var}`` interpolation against top-level config values
  (e.g. ``num_samples``, reference configs/base.yaml:9).
- dotted overrides: ``train.lr=1e-4 model.prompt_iters=3`` parsed as YAML
  scalars.
"""

from __future__ import annotations

import copy
import re
from pathlib import Path
from typing import Any

import yaml

CONFIG_ROOT = Path(__file__).resolve().parents[2] / "configs"

_INTERP_RE = re.compile(r"^\$\{([a-zA-Z0-9_.]+)\}$")
_INTERP_SUB_RE = re.compile(r"\$\{([a-zA-Z0-9_.]+)\}")


class ConfigDict(dict):
    """dict with attribute access, for ergonomic cfg.train.lr style."""

    def __getattr__(self, k):
        try:
            v = self[k]
        except KeyError as e:
            raise AttributeError(k) from e
        return ConfigDict(v) if isinstance(v, dict) else v

    def __setattr__(self, k, v):
        self[k] = v


def _load_yaml(path: Path) -> dict:
    with open(path) as f:
        return yaml.safe_load(f) or {}


def _resolve_interp(node: Any, root: dict) -> Any:
    if isinstance(node, dict):
        return {k: _resolve_interp(v, root) for k, v in node.items()}
    if isinstance(node, list):
        return [_resolve_interp(v, root) for v in node]
    if isinstance(node, str):
        def lookup(key: str) -> Any:
            cur: Any = root
            for part in key.split("."):
                cur = cur[part]
            return cur

        m = _INTERP_RE.match(node)
        if m:  # whole-string interpolation preserves the value's type
            return lookup(m.group(1))
        return _INTERP_SUB_RE.sub(lambda mm: str(lookup(mm.group(1))), node)
    return node


def _set_dotted(cfg: dict, dotted: str, value: Any) -> None:
    parts = dotted.split(".")
    cur = cfg
    for p in parts[:-1]:
        if p not in cur or not isinstance(cur[p], dict):
            cur[p] = {}
        cur = cur[p]
    cur[parts[-1]] = value


def load_config(
    name: str,
    overrides: list[str] | None = None,
    *,
    config_root: Path | str | None = None,
    context: dict | None = None,
) -> ConfigDict:
    """Compose ``configs/<name>.yaml`` with its defaults groups + overrides.

    ``context`` supplies extra root-level values for ``${var}`` interpolation
    when a group file is loaded standalone (e.g. dataset files referencing
    the run config's ``${num_samples}``).
    """
    root_dir = Path(config_root) if config_root else CONFIG_ROOT
    path = root_dir / f"{name}.yaml"
    if not path.exists():
        raise FileNotFoundError(f"no config {path}")
    cfg = _load_yaml(path)
    for k, v in (context or {}).items():
        cfg.setdefault(k, v)

    defaults = cfg.pop("defaults", {})
    if isinstance(defaults, list):  # hydra-style list of single-key dicts
        merged = {}
        for item in defaults:
            merged.update(item)
        defaults = merged
    for group_key, item in defaults.items():
        if "@" in group_key:
            group_dir, key = group_key.split("@", 1)
        else:
            group_dir = key = group_key
        group_cfg = _load_yaml(root_dir / group_dir / f"{item}.yaml")
        # Config-file values under the same key deep-merge over the group.
        existing = cfg.get(key, {})
        cfg[key] = _deep_merge(group_cfg, existing)

    for ov in overrides or []:
        if "=" not in ov:
            raise ValueError(f"override must be key=value, got {ov!r}")
        k, v = ov.split("=", 1)
        val = yaml.safe_load(v)
        # YAML 1.1 won't parse dot-less scientific notation ("1e-5") as a
        # float; CLI users expect it to be numeric.
        if isinstance(val, str) and re.fullmatch(
            r"[+-]?\d+(\.\d*)?[eE][+-]?\d+", val
        ):
            val = float(val)
        _set_dotted(cfg, k.strip(), val)

    cfg = _resolve_interp(cfg, cfg)
    return ConfigDict(cfg)


def _deep_merge(base: dict, extra: dict) -> dict:
    out = copy.deepcopy(base)
    for k, v in (extra or {}).items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = v
    return out


# --------------------------------------------------------------------------
# Model factory: the model group (configs/model/*.yaml) onto PointSAMConfig
# or VoronoiConfig.
# --------------------------------------------------------------------------


def build_model(model_cfg: dict, *, dtype=None, device=None, generator=None):
    """A PointCloudSAM (``variant: knn``), PointCloudSAMNN (``variant:
    voronoi``) or PointCloudSAMHier (``variant: hier``) from a model config
    dict.

    ``dtype`` is the compute dtype (parameters stay fp32): bf16 on a CUDA
    device and fp32 elsewhere unless given.
    """
    import torch

    from ..models import (
        HierConfig,
        HierTokenizerConfig,
        PointCloudSAM,
        PointCloudSAMHier,
        PointCloudSAMNN,
        PointSAMConfig,
        TokenizerConfig,
        VoronoiConfig,
    )

    mc = dict(model_cfg)
    variant = mc.pop("variant", "knn")
    if variant not in ("knn", "voronoi", "hier"):
        raise ValueError(f"unknown model variant {variant!r}")
    if dtype is None:
        dtype = torch.bfloat16 if torch.device(device or "cpu").type == "cuda" else torch.float32
    dec = mc.pop("decoder", {})
    tok = mc.pop("tokenizer", {})
    common = dict(
        vit=mc.pop("vit", "eva02_large"),
        embed_dim=mc.pop("embed_dim", 256),
        patch_embed_channels=mc.pop("patch_embed_channels", 512),
        num_multimask_outputs=mc.pop("num_multimask_outputs", 3),
        decoder_depth=dec.get("depth", 2),
        decoder_num_heads=dec.get("num_heads", 8),
        decoder_mlp_dim=dec.get("mlp_dim", 2048),
        prompt_iters=mc.pop("prompt_iters", 5),
        enable_mask_refinement_iterations=mc.pop("enable_mask_refinement_iterations", True),
    )
    patch_act = mc.pop("patch_act", "erf")
    if variant != "knn" and patch_act != "erf":
        raise ValueError(f"patch_act={patch_act!r} requires variant 'knn'")
    if mc:
        raise ValueError(f"unused model config keys: {sorted(mc)}")
    kw = dict(dtype=dtype, device=device, generator=generator)
    if variant == "voronoi":
        cfg = VoronoiConfig(num_patches=tok.get("num_patches", 1024),
                            hidden_dim=tok.get("hidden_dim", 256), **common)
        return PointCloudSAMNN(cfg, **kw)
    if variant == "hier":
        cfg = HierConfig(
            tokenizer=HierTokenizerConfig(
                num_patches=tuple(tok.get("num_patches", (2048, 512))),
                patch_size=tuple(tok.get("patch_size", (32, 32))),
                radius=tuple(tok["radius"]) if tok.get("radius") else None,
            ),
            **common,
        )
        return PointCloudSAMHier(cfg, **kw)
    cfg = PointSAMConfig(
        tokenizer=TokenizerConfig(
            num_patches=tok.get("num_patches", 512),
            patch_size=tok.get("patch_size", 64),
            radius=tok.get("radius"),
            centralize_features=tok.get("centralize_features", False),
        ),
        patch_act=patch_act,
        **common,
    )
    return PointCloudSAM(cfg, **kw)
