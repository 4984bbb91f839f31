"""Interactive predictor: encode once, decode per click (counterpart of
point_sam_tpu/serving/predictor.py).

- The point count N is padded up to a size bucket and the prompt count P
  to a power of two, as in the JAX predictor, so both packages see the
  same shapes and padding.
- The tokenizer geometry (FPS centres, kNN or the voronoi assignment,
  3-NN interp weights and the click-invariant half of the mask-prompt
  features) is computed once per cloud in ``set_pointcloud`` and reused by
  every decode.
- Default grouping follows the reference eval rule: N > 30000 -> G=2048,
  K=256; otherwise the model's own G (capped by the cloud) and K. A
  voronoi model (``PointCloudSAMNN``) has no K and reads only G. A hier
  model (``PointCloudSAMHier``) takes its own two levels at any N; a
  scalar override sets level 1 and keeps level 2, a 2-tuple sets both.
- The encode's outputs beyond (embeddings, PE), the hier model's level-1
  embeddings, ride along to every decode.

Every tensor stays on the predictor's ``device``; results come back as
numpy arrays, like the JAX predictor's.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.pc_sam import cast_params_for_inference, for_inference
from ..ops._cuda import resolve_device

DEFAULT_POINT_BUCKETS = (2048, 8192, 32768, 131072, 524288)


def _next_bucket(n: int, buckets) -> int:
    for b in buckets:
        if n <= b:
            return b
    return int(-(-n // buckets[-1]) * buckets[-1])


def _next_pow2(n: int, lo: int = 1) -> int:
    p = lo
    while p < n:
        p *= 2
    return p


def _two_level(value, default) -> tuple[int, int]:
    """A hier override: None -> the model's two levels, a scalar -> level 1
    (the cloud-facing level), a 2-tuple -> both."""
    if value is None:
        return tuple(default)
    if isinstance(value, (tuple, list)):
        if len(value) != 2:
            raise ValueError(f"a two-level override has 2 entries, got {value!r}")
        return tuple(int(v) for v in value)
    return int(value), int(default[1])


class Predictor:
    """Interactive single-cloud predictor over a PointCloudSAM,
    PointCloudSAMNN or PointCloudSAMHier model."""

    def __init__(self, model, *, device=None, point_buckets=DEFAULT_POINT_BUCKETS,
                 max_prompts: int = 64):
        """``device``: where the model and every tensor live; ``cuda``
        unless given (pass ``device="cpu"`` to run on the CPU). Raises when
        no device is given and there is no card."""
        self.device = resolve_device(device)
        self.model = for_inference(model).eval()
        self.model.to(self.device)
        if self.model.dtype != torch.float32:
            cast_params_for_inference(self.model)
        self.point_buckets = tuple(point_buckets)
        self.max_prompts = max_prompts
        self._state = None

    def _tensor(self, a, dtype=None):
        return torch.as_tensor(a, dtype=dtype, device=self.device)

    @torch.inference_mode()
    def set_pointcloud(self, xyz: np.ndarray, rgb: np.ndarray, *,
                       group_number: int | None = None, group_size: int | None = None,
                       normalize: bool = False) -> None:
        """Tokenize + encode a point cloud and cache everything per cloud.

        Args:
            xyz: [N, 3] coordinates (unit-sphere normalised unless
                ``normalize=True``). rgb: [N, 3] colours.
            group_number / group_size: tokenizer override; default is the
                reference eval rule (N > 30000 -> 2048 / 256). For a hier
                model a scalar sets level 1, a 2-tuple both levels.
        """
        xyz = np.asarray(xyz, np.float32)
        rgb = np.asarray(rgb, np.float32)
        n = len(xyz)
        self._shift = np.zeros(3, np.float32)
        self._scale = 1.0
        if normalize:
            self._shift = xyz.mean(0)
            xyz = xyz - self._shift
            self._scale = float(np.linalg.norm(xyz, axis=1).max()) or 1.0
            xyz = xyz / self._scale

        default_g, default_k = self.model.default_grouping
        if isinstance(default_g, tuple):  # hier: two levels, no eval rule
            group_number = _two_level(group_number, default_g)
            group = dict(group_number=group_number,
                         group_size=_two_level(group_size, default_k))
        else:
            if group_number is None:
                if n > 30000:
                    group_number, group_size = 2048, 256
                else:
                    group_number = min(default_g, _next_pow2(n, 64))
            group = dict(group_number=group_number)
            if default_k is not None:  # a voronoi model has no K
                group["group_size"] = min(group_size or default_k, n)

        n_pad = _next_bucket(n, self.point_buckets)
        coords = np.zeros((1, n_pad, 3), np.float32)
        coords[0, :n] = xyz
        feats = np.zeros((1, n_pad, rgb.shape[-1]), np.float32)
        feats[0, :n] = rgb
        valid = np.zeros((1, n_pad), bool)
        valid[0, :n] = True
        coords_t, feats_t, valid_t = (self._tensor(coords), self._tensor(feats),
                                      self._tensor(valid))

        geom = self.model.make_geometry(coords_t, point_valid=valid_t, **group)
        geom.update(self.model.prompt_cache(coords_t, geom))
        emb, pc_pe, *extras = self.model.encode(coords_t, feats_t, geom)
        self._state = dict(n=n, n_pad=n_pad, coords=coords_t, emb=emb, pc_pe=pc_pe,
                           extras=tuple(extras), geom=geom,
                           group=(group_number, group.get("group_size")))

    @torch.inference_mode()
    def predict_masks(self, prompt_points: np.ndarray, prompt_labels: np.ndarray,
                      prompt_mask: np.ndarray | None = None, multimask_output: bool = True):
        """One decoder pass against the cached encoding.

        Args:
            prompt_points: [P, 3] click coordinates in the cloud's frame.
            prompt_labels: [P] bool/int, 1 = positive.
            prompt_mask: optional [N] mask logits from the previous call.
            multimask_output: 3 candidate masks (first click) vs 1.

        Returns:
            (masks [1, C, N] bool, iou_scores [1, C], logits [1, C, N]).
        """
        if self._state is None:
            raise RuntimeError("call set_pointcloud first")
        st = self._state
        pts = np.asarray(prompt_points, np.float32).reshape(-1, 3)
        labs = np.asarray(prompt_labels).reshape(-1).astype(bool)
        p = len(pts)
        if p == 0:
            raise ValueError("need at least one prompt point")
        if p > self.max_prompts:
            raise ValueError(f"too many prompts ({p} > {self.max_prompts})")
        p_pad = _next_pow2(p)
        pc = np.zeros((1, p_pad, 3), np.float32)
        pc[0, :p] = (pts - self._shift) / self._scale
        pl = np.zeros((1, p_pad), bool)
        pl[0, :p] = labs
        pv = np.zeros((1, p_pad), bool)
        pv[0, :p] = True
        pm = None
        if prompt_mask is not None:
            pm_np = np.zeros((1, st["n_pad"]), np.float32)
            pm_np[0, :st["n"]] = np.asarray(prompt_mask, np.float32).reshape(-1)[:st["n"]]
            pm = self._tensor(pm_np)
        masks_logits, iou = self.model.decode(
            st["emb"], st["pc_pe"], st["coords"], st["geom"], *st["extras"], self._tensor(pc),
            self._tensor(pl), pm, prompt_valid=self._tensor(pv),
            multimask_output=multimask_output)
        logits = masks_logits.float().cpu().numpy()[:, :, :st["n"]]
        scores = iou.float().cpu().numpy()
        return logits > 0, scores, logits

    def click(self, prompt_points, prompt_labels, prompt_mask=None):
        """Demo-style best-mask step: predict, pick the highest-scoring
        mask; returns (best_mask [N] bool, best_logits [N])."""
        multimask = prompt_mask is None
        masks, scores, logits = self.predict_masks(prompt_points, prompt_labels,
                                                   prompt_mask, multimask)
        best = int(np.argmax(scores[0]))
        return masks[0, best], logits[0, best]
