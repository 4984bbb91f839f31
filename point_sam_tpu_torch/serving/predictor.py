"""Interactive predictor: encode once, decode per click (counterpart of
point_sam_tpu/serving/predictor.py).

- The point count N is padded up to a size bucket and the prompt count P
  to a power of two, as in the JAX predictor, so both packages see the
  same shapes and padding.
- The tokenizer geometry (FPS centres, kNN, 3-NN interp weights and the
  click-invariant mask-prompt rel-coords) is computed once per cloud in
  ``set_pointcloud`` and reused by every decode.
- Default grouping follows the reference eval rule: N > 30000 -> G=2048,
  K=256; otherwise the model's own tokenizer (G capped by the cloud).

Every tensor stays on the predictor's ``device``; results come back as
numpy arrays, like the JAX predictor's.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.pc_sam import cast_params_for_inference, for_inference
from ..models.prompt_encoder import mask_group_rel_xyz
from ..models.tokenizer import TokenizerConfig

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


class Predictor:
    """Interactive single-cloud predictor over a PointCloudSAM model."""

    def __init__(self, model, *, device=None, point_buckets=DEFAULT_POINT_BUCKETS,
                 max_prompts: int = 64):
        """``device``: where the model and every tensor live; ``cuda``
        unless given (pass ``device="cpu"`` to run on the CPU). Raises when
        no device is given and there is no card."""
        self.device = torch.device(device or "cuda")
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError('no CUDA device: pass device="cpu" to run on the CPU')
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
                reference eval rule (N > 30000 -> 2048 / 256).
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

        tok = self.model.cfg.tokenizer
        if group_number is None:
            if n > 30000:
                group_number, group_size = 2048, 256
            else:
                group_number = min(tok.num_patches, _next_pow2(n, 64))
                group_size = group_size or tok.patch_size
        group_size = min(group_size or tok.patch_size, n)

        n_pad = _next_bucket(n, self.point_buckets)
        coords = np.zeros((1, n_pad, 3), np.float32)
        coords[0, :n] = xyz
        feats = np.zeros((1, n_pad, rgb.shape[-1]), np.float32)
        feats[0, :n] = rgb
        valid = np.zeros((1, n_pad), bool)
        valid[0, :n] = True
        coords_t, feats_t, valid_t = (self._tensor(coords), self._tensor(feats),
                                      self._tensor(valid))

        tokenizer = TokenizerConfig(num_patches=group_number, patch_size=group_size,
                                    radius=tok.radius,
                                    centralize_features=tok.centralize_features)
        geom = self.model.make_geometry(coords_t, point_valid=valid_t, tokenizer=tokenizer)
        # The click-invariant half of the mask-prompt grouping, once per
        # cloud (the flagship MaskEncoder has no radius).
        geom["mask_rel_xyz"] = mask_group_rel_xyz(coords_t, geom["centers"], geom["knn_idx"])
        emb, pc_pe = self.model.encode(coords_t, feats_t, geom)
        self._state = dict(n=n, n_pad=n_pad, coords=coords_t, emb=emb, pc_pe=pc_pe,
                           geom=geom, group=(group_number, group_size))

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
            st["emb"], st["pc_pe"], st["coords"], st["geom"], self._tensor(pc),
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
