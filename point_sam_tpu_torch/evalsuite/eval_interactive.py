"""Interactive-segmentation evaluation: mean IoU per click count
(counterpart of point_sam_tpu/evalsuite/eval_interactive.py).

Equivalent of the reference's ``evaluation/eval_kitti.py`` (KITTI-360 crops
from the AGILE3D eval data): per scene, normalize into the unit sphere, take
one sample per GT instance (filtered to ``sum >= min_mask_points`` and
``< max_mask_fraction * N``, eval_kitti.py:249-255), run the click loop
with ``is_eval=True`` semantics (a farthest-from-error-border click every
iteration), and report mean IoU at click k plus per-category means
(eval_kitti.py:374-390).

Scenes are padded into N-size buckets with validity masks, as in the JAX
evaluator, so both packages see the same shapes; the tokenizer rule is
applied per scene (``gk_policy``). Each scene is tokenized and encoded
once; its instances then go through the click loop ``masks_per_batch`` at
a time, eagerly under ``torch.inference_mode``.

With a process group (``group=``, JAX's ``mesh=``) of more than one rank,
a flat-tokenizer scene at or above the top bucket runs point-sharded:
every rank holds the whole scene, FPS (K8 on the card) and the 3-NN
weights (K10) are replicated, the G x K neighbour search runs on each
rank's contiguous shard of the points (``parallel.sharded_geometry.
sharded_knn``, K12, one all-gather), and the decoder's N-point tail on
each rank's shard (``models.for_sharded_eval``). The click sampler stays
replicated. Every rank returns the same IoUs.
"""

from __future__ import annotations

import argparse
import json
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from ..models.loss import compute_iou
from ..models.pc_sam import cast_params_for_inference, for_inference, for_sharded_eval
from ..models.tokenizer import TokenizerConfig
from ..ops import batch_index_select, compute_interp_weights, fps
from ..ops._cuda import resolve_device
from ..ops.sampler import sample_prompts
from ..parallel.sharded_geometry import sharded_knn


def filter_masks(
    gt_masks: np.ndarray,
    min_points: int = 25,
    max_fraction: float = 0.9,
) -> np.ndarray:
    """Instance filter of eval_kitti.py:249-255. Returns kept row indices."""
    n = gt_masks.shape[1]
    sizes = gt_masks.sum(1)
    keep = (sizes >= min_points) & (sizes < max_fraction * n)
    return np.nonzero(keep)[0]


def normalize_scene(xyz: np.ndarray, rgb: np.ndarray | None):
    """Unit-sphere + color normalization (eval_kitti.py:73-88,101-102)."""
    shift = xyz.mean(0)
    xyz = xyz - shift
    scale = np.linalg.norm(xyz, axis=1).max()
    xyz = xyz / max(scale, 1e-12)
    if rgb is None:
        rgb = np.full((len(xyz), 3), 0.5, np.float32)
    else:
        rgb = np.asarray(rgb, np.float32)
        if rgb.max() > 1.5:  # 0..255 -> normalized
            rgb = rgb / 255.0
        rgb = (rgb - 0.5) / 0.5
    return xyz.astype(np.float32), rgb


class InteractiveEvaluator:
    """Bucketed click-simulation evaluator over a PointCloudSAM,
    PointCloudSAMNN or PointCloudSAMHier model."""

    def __init__(self, model, *, device=None, num_clicks: int = 5,
                 point_buckets=(8192, 32768, 131072, 262144),
                 masks_per_batch: int = 4, knn_method: str = "auto",
                 gk_policy: str = "bucket_pow2", fps_candidates: int | None = None,
                 knn_recall_target: float = 0.9, group=None):
        """Args beyond the obvious:

        device: where the model and every tensor live; ``cuda`` unless
            given (pass ``device="cpu"`` to run on the CPU). Raises when no
            device is given and there is no card.
        knn_method: the tokenizer's G x K neighbour search. "auto" and
            "exact" take the exact search (K12 on the card). "approx" takes
            kernel K9's fused geometry (FPS, 3-NN and a binned kNN from one
            pass) where its gate holds, and elsewhere the approximate
            search (K12 over strided bins, the port's ``lax.approx_min_k``).
        knn_recall_target: the approximate search's recall target
            (``TokenizerConfig.knn_recall_target``); above 0.93 K9's gate
            fails.
        fps_candidates: approximate FPS (``ops.fps`` ``candidates``):
            centres are selected from a strided subset of this many points.
            None = exact FPS (reference parity).
        gk_policy: tokenizer reconfiguration rule (flat kNN tokenizer only;
            the voronoi and hier models keep their own).
            - "bucket_pow2" (default): G rounded to the next power of two
              and K scaled down for tiny scenes, as the JAX evaluator does.
            - "reference": the reference's exact per-scene rule
              (eval_kitti.py:350-362): N>30000 -> G=2048/K=256, else
              G=min(N, 2048), K=256 (K=2 when N<256).
        group: a ``torch.distributed`` process group (JAX's ``mesh``);
            scenes padded to ``point_buckets[-1]`` or more then run
            point-sharded over its ranks (the module docstring). Every rank
            calls ``evaluate_scene`` with the same scene.
        """
        if gk_policy not in ("bucket_pow2", "reference"):
            raise ValueError(f"unknown gk_policy {gk_policy!r}")
        self.device = resolve_device(device)
        self.model = for_inference(model).eval().to(self.device)
        if self.model.dtype != torch.float32:
            cast_params_for_inference(self.model)
        self.num_clicks = num_clicks
        self.point_buckets = tuple(point_buckets)
        self.masks_per_batch = masks_per_batch
        self.knn_method = knn_method
        self.gk_policy = gk_policy
        self.fps_candidates = fps_candidates
        self.knn_recall_target = knn_recall_target
        self.group = group

    def _bucket(self, n):
        for b in self.point_buckets:
            if n <= b:
                return b
        return int(-(-n // self.point_buckets[-1]) * self.point_buckets[-1])

    def _tokenizer_for(self, n):
        tok = getattr(self.model.cfg, "tokenizer", None)
        if tok is None or isinstance(tok.num_patches, (tuple, list)):
            # voronoi (no flat tokenizer) / hier (two-level): model default.
            return None
        kw = dict(radius=tok.radius,
                  centralize_features=tok.centralize_features,
                  knn_method=self.knn_method,
                  fps_candidates=self.fps_candidates,
                  knn_recall_target=self.knn_recall_target)
        if self.gk_policy == "reference":
            # eval_kitti.py:350-362 verbatim: per-scene G, fixed K=256.
            if n > 30000:
                return TokenizerConfig(2048, 256, **kw)
            return TokenizerConfig(min(n, 2048), 2 if n < 256 else 256, **kw)
        if n > 30000:
            return TokenizerConfig(2048, 256, **kw)
        g = 64
        while g < min(2048, n):
            g *= 2
        k = min(tok.patch_size, max(2, n // 4))
        return TokenizerConfig(min(g, tok.num_patches * 2), k, **kw)

    def _use_sharded(self, n_pad, tok) -> bool:
        """JAX's rule: more than one rank, a flat tokenizer, the top bucket
        or above, a ``PointCloudSAM``."""
        return (
            self.group is not None
            and dist.get_world_size(self.group) > 1
            and tok is not None
            and n_pad >= self.point_buckets[-1]
            and type(self.model).__name__ == "PointCloudSAM"
        )

    def _sharded_geometry(self, tok, coords, valid) -> dict:
        """The tokenizer geometry with the G x K search split over the
        ranks' contiguous point shards (JAX's ``_sharded_geometry``): FPS
        and the 3-NN weights whole on every rank."""
        world, rank = dist.get_world_size(self.group), dist.get_rank(self.group)
        n_pad = coords.shape[1]
        if n_pad % world:
            raise ValueError(f"{n_pad} points do not split over {world} ranks")
        coords = coords.float()
        fps_idx = fps(coords, tok.num_patches, valid=valid, candidates=tok.fps_candidates)
        centers = batch_index_select(coords, fps_idx, axis=1)
        part = slice(rank * n_pad // world, (rank + 1) * n_pad // world)
        _, knn_idx = sharded_knn(centers, coords[:, part].contiguous(), tok.patch_size,
                                 group=self.group, method=tok.knn_method,
                                 recall_target=tok.knn_recall_target,
                                 key_valid=valid[:, part].contiguous())
        idx, w = compute_interp_weights(coords, centers)
        return dict(fps_idx=fps_idx, centers=centers, knn_idx=knn_idx, interp_index=idx,
                    interp_weight=w)

    def _tensor(self, a):
        return torch.as_tensor(a, device=self.device)

    def _click_loop(self, model, encoded, coords, geom, valid, gt_masks):
        """One chunk of instances through the clicks (JAX ``_build_fn``'s
        loop): [clicks, B*M] IoUs. ``encoded``: ``encode``'s outputs, the
        hier model's level-1 embeddings riding along to every decode."""
        emb, pc_pe, *extras = encoded
        B, M, N = gt_masks.shape
        BM, clicks, dev = B * M, self.num_clicks, self.device
        buf_c = torch.zeros((BM, clicks, 3), dtype=torch.float32, device=dev)
        buf_l = torch.zeros((BM, clicks), dtype=torch.bool, device=dev)
        buf_v = torch.zeros((BM, clicks), dtype=torch.bool, device=dev)
        valid_bm = valid.repeat_interleave(M, dim=0)
        gt_flat = gt_masks.reshape(BM, N)
        prompt_masks = None
        ious = []
        for i in range(clicks):
            pc, pl = sample_prompts(coords, gt_masks, prompt_masks, point_valid=valid)
            buf_c[:, i] = pc[:, 0]
            buf_l[:, i] = pl[:, 0]
            buf_v[:, i] = True
            masks, iou_preds = model.decode(
                emb, pc_pe, coords, geom, *extras, buf_c[:, :i + 1], buf_l[:, :i + 1],
                prompt_masks, prompt_valid=buf_v[:, :i + 1], multimask_output=(i == 0))
            if i == 0:
                best = iou_preds.argmax(1)  # the first index among ties
                prompt_masks = torch.take_along_dim(masks, best[:, None, None], dim=1)[:, 0]
            else:
                prompt_masks = masks[:, 0]
            pm = torch.where(valid_bm, prompt_masks, -1e9)
            ious.append(compute_iou(pm, gt_flat))
        return torch.stack(ious, 0)

    @torch.inference_mode()
    def evaluate_scene(self, xyz, rgb, gt_masks):
        """Run the click loop for every instance of one (normalized) scene.

        Returns per-instance IoU per click [num_instances, clicks] fp32.
        """
        n = len(xyz)
        n_pad = self._bucket(n)
        tok = self._tokenizer_for(n)
        m_all = len(gt_masks)

        coords = np.zeros((1, n_pad, 3), np.float32)
        coords[0, :n] = xyz
        feats = np.zeros((1, n_pad, rgb.shape[-1]), np.float32)
        feats[0, :n] = rgb
        valid = np.zeros((1, n_pad), bool)
        valid[0, :n] = True
        coords, feats, valid = self._tensor(coords), self._tensor(feats), self._tensor(valid)

        # The encode does not depend on the masks: once per scene (JAX's
        # jitted run repeats it per chunk, with the same numbers).
        model = self.model
        if self._use_sharded(n_pad, tok):
            model = for_sharded_eval(model, self.group)
            geom = self._sharded_geometry(tok, coords, valid)
        else:
            geom = model.make_geometry(coords, point_valid=valid,
                                       **({} if tok is None else {"tokenizer": tok}))
        geom.update(model.prompt_cache(coords, geom))  # geometry only: bit-equal
        encoded = model.encode(coords, feats, geom)

        # Instances in chunks of masks_per_batch, the last padded by
        # repeating the chunk's first mask (those rows are dropped).
        out = np.zeros((m_all, self.num_clicks), np.float32)
        mb = self.masks_per_batch
        for s in range(0, m_all, mb):
            chunk = gt_masks[s:s + mb]
            real = len(chunk)
            if real < mb:
                chunk = np.concatenate([chunk, np.repeat(chunk[:1], mb - real, axis=0)])
            gm = np.zeros((1, mb, n_pad), bool)
            gm[0, :, :n] = chunk
            ious = self._click_loop(model, encoded, coords, geom, valid, self._tensor(gm))
            out[s:s + real] = ious.float().cpu().numpy()[:, :real].T
        return out


def evaluate_directory(
    model, scene_dir: str, *, device=None, num_clicks: int = 5,
    max_scenes: int | None = None, category_from_name=None,
    **evaluator_kwargs,
):
    """Evaluate every .ply scene in a directory, KITTI-360 protocol.

    Scene format: binary/ascii PLY with optional per-vertex colors plus a
    sidecar ``<name>.masks.npy`` bool array [M, N] of instance masks (the
    layout evalsuite/prepare_kitti.py and serving/make_assets.py write).

    ``evaluator_kwargs`` pass through to ``InteractiveEvaluator``:
    gk_policy / knn_method / knn_recall_target / fps_candidates /
    masks_per_batch / point_buckets / group (a process group: big scenes
    point-sharded over its ranks; every rank runs this call).
    """
    from ..utils.ply import load_ply

    evaluator = InteractiveEvaluator(model, device=device, num_clicks=num_clicks,
                                     **evaluator_kwargs)
    per_click = defaultdict(list)
    per_cat = defaultdict(lambda: defaultdict(list))

    scenes = sorted(Path(scene_dir).glob("*.ply"))
    if max_scenes:
        scenes = scenes[:max_scenes]
    for scene in scenes:
        xyz, rgb = load_ply(scene)
        mask_file = scene.with_suffix(".masks.npy")
        if not mask_file.exists():
            print(f"skip {scene.name}: no {mask_file.name}")
            continue
        gt = np.load(mask_file)
        keep = filter_masks(gt)
        if len(keep) == 0:
            continue
        gt = gt[keep]
        xyz_n, rgb_n = normalize_scene(xyz, rgb)
        ious = evaluator.evaluate_scene(xyz_n, rgb_n, gt)
        cat = category_from_name(scene.name) if category_from_name else "all"
        for k in range(num_clicks):
            per_click[k].extend(ious[:, k].tolist())
            per_cat[cat][k].extend(ious[:, k].tolist())
        print(f"{scene.name}: {len(gt)} instances, "
              + " ".join(f"IoU@{k+1}={np.mean(ious[:, k]):.3f}"
                         for k in range(num_clicks)))

    return {
        "mean_iou_per_click": {
            k + 1: float(np.mean(v)) for k, v in sorted(per_click.items())
        },
        "per_category": {
            c: {k + 1: float(np.mean(v)) for k, v in sorted(d.items())}
            for c, d in per_cat.items()
        },
        "num_instances": len(per_click[0]) if per_click else 0,
    }


def add_model_args(parser: argparse.ArgumentParser) -> None:
    """The model arguments every entry point shares."""
    parser.add_argument("--config", default="large")
    parser.add_argument(
        "--ckpt_path", default=None,
        help="the weights: a reference .safetensors checkpoint (the released "
        "format; loaded non-strict through the key triage, warning on "
        "unmapped and unfilled keys), a trainer checkpoint directory (its "
        "latest checkpoint) or a torch.save state dict with the reference's "
        "key names (both loaded strictly). Without it the weights are "
        "random, seeded by 0.")
    parser.add_argument("--device", default=None, help="torch device (default: cuda)")
    parser.add_argument("overrides", nargs="*", default=[])


def load_model(args):
    """(model, device, report) from ``add_model_args``' arguments:
    ``build_model`` of the config's model (bf16 compute on the card, fp32
    on the CPU), then the checkpoint if one is named
    (``utils.checkpoint.load_weights``, into the fp32 parameters, before
    any Predictor casts them; ``report`` is its report, else None)."""
    from ..utils import checkpoint
    from ..utils.config import build_model, load_config

    device = resolve_device(args.device)
    cfg = load_config(args.config, args.overrides)
    model = build_model(cfg.model, device=device,
                        generator=torch.Generator(device).manual_seed(0))
    report = checkpoint.load_weights(args.ckpt_path, model) if args.ckpt_path else None
    return model, device, report


def main(argv=None):
    parser = argparse.ArgumentParser(prog="point_sam_tpu_torch.evalsuite.eval_interactive")
    add_model_args(parser)
    parser.add_argument("--scene_dir", required=True)
    parser.add_argument("--num_clicks", type=int, default=5)
    parser.add_argument("--max_scenes", type=int, default=None)
    parser.add_argument(
        "--category_from", default="filename-prefix",
        choices=["filename-prefix", "none"],
        help="how to derive the per-category mIoU table (reference prints "
        "total AND per-object-category means, eval_kitti.py:374-390). "
        "filename-prefix uses name.split('_')[0], the layout produced by "
        "prepare_kitti.py; none reports a single 'all' bucket.")
    parser.add_argument(
        "--gk-policy", default="bucket_pow2",
        choices=["bucket_pow2", "reference"],
        help="tokenizer reconfiguration rule: bucket_pow2 = G rounded up to "
        "a power of two per scene; reference = the per-scene rule of "
        "eval_kitti.py:350-362")
    parser.add_argument(
        "--knn-method", default="auto", choices=["auto", "exact", "approx"],
        help="tokenizer G x K neighbour search: auto / exact = the exact "
        "search; approx = kernel K9's binned search where its gate holds, "
        "else the approximate search at --recall-target")
    parser.add_argument(
        "--recall-target", "--recall_target", dest="recall_target", type=float,
        default=0.9, help="per-neighbour recall target for the approx kNN path")
    parser.add_argument(
        "--fps-candidates", type=int, default=None,
        help="approximate FPS: sample centers from a strided subset of "
        "this many points (default: exact FPS, reference parity)")
    parser.add_argument(
        "--masks-per-batch", type=int, default=4,
        help="instances decoded at once (the last chunk padded)")
    args = parser.parse_args(argv)

    model, device, _ = load_model(args)
    category_from_name = (
        (lambda n: n.split("_")[0])
        if args.category_from == "filename-prefix" else None
    )
    report = evaluate_directory(
        model, args.scene_dir, device=device,
        num_clicks=args.num_clicks, max_scenes=args.max_scenes,
        category_from_name=category_from_name,
        gk_policy=args.gk_policy, knn_method=args.knn_method,
        knn_recall_target=args.recall_target, fps_candidates=args.fps_candidates,
        masks_per_batch=args.masks_per_batch,
    )
    print(json.dumps(report, indent=2))
    return report


if __name__ == "__main__":
    main()
