"""A/B harness: what do the approximations cost on the end metric?
(counterpart of point_sam_tpu/evalsuite/ab_approx.py)

The evaluator can depart from the reference's exact per-scene policies in
three switchable ways:

  1. the tokenizer's kNN by strided bins at a recall target
     (``knn_method="approx"``: kernel K9 where its gate holds, else K12 in
     approximate mode, the port's ``lax.approx_min_k``) instead of the
     exact top-k;
  2. per-bucket power-of-two G / K instead of the reference's per-scene
     ``G=min(N,2048), K=256, K=2 if N<256`` (gk_policy="bucket_pow2");
  3. approximate FPS over a strided candidate subset (``fps_candidates``).

On a deterministic corpus of synthetic scenes (datasets/synthetic.py) it
measures:

  A. model-free geometry surrogates: the approximate kNN's neighbour recall
     against the exact kNN, and FPS coverage (the largest distance of a
     point to its nearest centre, approximate over exact);
  B. the end metric: mean IoU per click through InteractiveEvaluator, one
     run per variant with everything else held fixed, paired per instance
     against the base variant (bootstrap 95% CIs), on a model that was
     trained on the scenes so that mask quality responds to geometry.

The base variant is what the JAX evaluator runs on the TPU by default:
``knn_method="approx"`` at ``knn_recall_target=0.9``, gk bucket_pow2,
exact FPS. The port's own default ("auto") is the exact kNN, the "knn
exact" variant here.

Run:  python -m point_sam_tpu_torch.evalsuite.ab_approx \\
          [--scenes 32] [--points 32768] [--clicks 3] [--ckpt state.pt] \\
          [--config tiny] [--device cpu]
      With no --ckpt it first overfits the config's model on the eval
      scenes for --train-steps steps (fp32; a briefly trained model reads
      IoU ~0 in every variant).

Output: one JSON report and a markdown table of it.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

BASE = "base (knn approx rt=0.9, gk bucket_pow2, fps exact)"
BASE_KW = dict(knn_method="approx", knn_recall_target=0.9)


@torch.no_grad()
def geometry_surrogates(scenes, *, num_patches, patch_size, candidates, recall_target=0.9,
                        device="cpu"):
    """Model-free deltas, means over the scenes: the approximate kNN's
    recall of the exact kNN's neighbours (G exact FPS centres x K) at
    ``recall_target``, and the FPS coverage ratio of ``candidates``-point
    approximate FPS over exact FPS."""
    from ..ops import batch_index_select, fps, knn

    out = {"knn_recall": [], "fps_coverage_ratio": []}
    for xyz in scenes:
        c = torch.as_tensor(xyz[None], device=device)
        cent_exact = batch_index_select(c, fps(c, num_patches), axis=1)
        cent_apx = batch_index_select(c, fps(c, num_patches, candidates=candidates), axis=1)

        def cover_radius(centers):
            d2, _ = knn(c, centers, 1, method="exact")
            return float(torch.sqrt(d2.max()))

        out["fps_coverage_ratio"].append(
            cover_radius(cent_apx) / max(cover_radius(cent_exact), 1e-12))
        _, nn_exact = knn(cent_exact, c, patch_size, method="exact")
        _, nn_apx = knn(cent_exact, c, patch_size, method="approx", recall_target=recall_target)
        a, b = nn_exact[0].cpu().numpy(), nn_apx[0].cpu().numpy()
        rec = np.mean([len(np.intersect1d(a[g], b[g])) / a.shape[-1] for g in range(len(a))])
        out["knn_recall"].append(float(rec))
    return {k: float(np.mean(v)) for k, v in out.items()}


def make_scenes(num_scenes, num_points, seed=100):
    """(xyz, rgb, gt_masks) of each synthetic scene with a kept instance,
    normalised as the evaluator does."""
    from ..datasets.synthetic import generate_scene
    from .eval_interactive import filter_masks, normalize_scene

    scenes = []
    for i in range(num_scenes):
        ex = generate_scene(seed + i, num_points=num_points)
        xyz, rgb = normalize_scene(ex["coords"], ex["features"])
        gt = ex["gt_masks"][filter_masks(ex["gt_masks"])]
        if len(gt):
            scenes.append((xyz, rgb, gt))
    return scenes


def miou_run(model, scenes, *, clicks, device, **evaluator_kw):
    """[instances, clicks] IoUs, per instance so that variants compare
    paired: the instance order is the same in every variant (same scenes,
    same mask order), and the scene-to-scene variance cancels."""
    from .eval_interactive import InteractiveEvaluator

    ev = InteractiveEvaluator(model, device=device, num_clicks=clicks, masks_per_batch=2,
                              **evaluator_kw)
    rows = [np.asarray(ev.evaluate_scene(xyz, rgb, gt))[:, :clicks] for xyz, rgb, gt in scenes]
    return np.concatenate(rows, axis=0)


def paired_delta_ci(variant, base, *, n_boot=10_000, seed=0):
    """Mean paired delta per click + bootstrap 95% CI over instances."""
    d = np.asarray(variant) - np.asarray(base)  # [instances, clicks]
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, len(d), size=(n_boot, len(d)))
    boots = d[idx].mean(axis=1)  # [n_boot, clicks]
    lo, hi = np.percentile(boots, [2.5, 97.5], axis=0)
    return {
        "mean": [round(float(v), 4) for v in d.mean(0)],
        "ci95": [[round(float(a), 4), round(float(b), 4)] for a, b in zip(lo, hi)],
    }


def get_model_and_weights(args, scenes):
    """The config's model in fp32 (the tight overfit loop diverges in bf16
    at this rate), seeded by 0; then a torch state dict from ``--ckpt``
    (reference key names, loaded strictly), or the overfit on ``scenes``."""
    from ..utils.config import build_model, load_config

    cfg = load_config(args.config, [])
    model = build_model(cfg.model, dtype=torch.float32, device=args.device,
                        generator=torch.Generator(args.device).manual_seed(0))
    if args.ckpt:
        state = torch.load(args.ckpt, map_location=args.device, weights_only=True)
        model.load_state_dict(state, strict=True)
        return model
    # No checkpoint: overfit on the eval scenes themselves. The A/B measures
    # the geometry variants' effect on the end metric, not generalisation;
    # a model that segments its own training scenes well is the most
    # sensitive instrument.
    return _overfit_on_scenes(args, model, scenes)


def _overfit_on_scenes(args, model, scenes, *, points=4096):
    """``args.train_steps`` steps of the port's train step (the criterion,
    clip-by-value and AdamW at 3e-4 with a 10-step warm-up, weight decay
    0.1) over one fixed batch a scene: ``points`` points sampled from it
    and its first 2 masks that keep more than 8 of them."""
    from ..parallel.train_step import make_optimizer, train_step
    from ..train.schedule import warmup_multistep

    tx = make_optimizer(model.parameters(),
                        warmup_multistep(3e-4, [10 * args.train_steps], warmup_iters=10),
                        weight_decay=0.1, max_grad_value=1.0)
    rng = np.random.default_rng(0)
    batches = []
    for xyz, rgb, gt in scenes:
        sel = rng.choice(len(xyz), size=points, replace=len(xyz) < points)
        gt_sub = gt[:, sel]
        gt_sub = gt_sub[gt_sub.sum(-1) > 8][:2]
        if len(gt_sub) == 0:
            continue
        if len(gt_sub) < 2:
            gt_sub = np.concatenate([gt_sub, gt_sub], 0)[:2]
        batches.append({k: torch.as_tensor(v, device=args.device) for k, v in (
            ("coords", xyz[None, sel]), ("features", rgb[None, sel]),
            ("gt_masks", gt_sub[None]))})
    if not batches:
        raise ValueError(
            "every eval scene was filtered out of the overfit corpus "
            f"(masks cover <= 8 of the {points} subsampled points); "
            "raise --points or use scenes with larger instances")
    clicks = torch.Generator().manual_seed(1)
    for i in range(args.train_steps):
        metrics = train_step(model, tx, batches[i % len(batches)], clicks)
        if i % 100 == 0 or i == args.train_steps - 1:
            print(f"[overfit step {i}] loss={float(metrics['loss']):.4f} "
                  f"last-iter IoU={float(metrics['last/iou']):.3f}", flush=True)
    return model


def main(argv=None):
    parser = argparse.ArgumentParser(prog="point_sam_tpu_torch.evalsuite.ab_approx")
    parser.add_argument("--config", default="tiny")
    parser.add_argument("--ckpt", default=None,
                        help="a torch state dict (torch.save) with the reference's key names")
    parser.add_argument("--device", default=None, help="torch device (default: cuda)")
    parser.add_argument("--scenes", type=int, default=32)
    parser.add_argument("--points", type=int, default=32768)
    parser.add_argument("--clicks", type=int, default=3)
    parser.add_argument("--train-steps", type=int, default=400)
    parser.add_argument("--fps-candidates", type=int, default=16384)
    parser.add_argument("--geom-patches", type=int, default=2048,
                        help="G for the model-free surrogates")
    parser.add_argument("--geom-patch-size", type=int, default=256)
    args = parser.parse_args(argv)

    from ..ops._cuda import resolve_device

    args.device = resolve_device(args.device)
    print(f"device: {args.device}", flush=True)
    scenes = make_scenes(args.scenes, args.points)
    print(f"{len(scenes)} scenes x {args.points} points", flush=True)

    # A. model-free surrogates at the big-scene tokenizer configuration.
    fps_cand = min(args.fps_candidates, args.points)
    surro = geometry_surrogates([s[0] for s in scenes],
                                num_patches=min(args.geom_patches, args.points // 4),
                                patch_size=args.geom_patch_size, candidates=fps_cand,
                                recall_target=BASE_KW["knn_recall_target"], device=args.device)

    # B. end-metric mIoU per click, one variant at a time, the others' knobs
    # held at the base's.
    model = get_model_and_weights(args, scenes)
    variants = {
        BASE: {},
        "knn exact": dict(knn_method="exact"),
        "knn rt=0.95": dict(knn_recall_target=0.95),
        "gk reference": dict(gk_policy="reference"),
        f"fps candidates={fps_cand}": dict(fps_candidates=fps_cand),
    }
    per_instance = {name: miou_run(model, scenes, clicks=args.clicks, device=args.device,
                                   **{**BASE_KW, **kw})
                    for name, kw in variants.items()}
    base = per_instance[BASE]
    miou = {name: [round(float(v), 4) for v in vals.mean(0)]
            for name, vals in per_instance.items()}
    report = {
        "device": str(args.device),
        "corpus": {"scenes": len(scenes), "instances": int(len(base)), "points": args.points,
                   "clicks": args.clicks,
                   "model": args.ckpt or f"{args.config} overfit {args.train_steps} steps on "
                   "the eval scenes"},
        "geometry_surrogates": surro,
        "miou_per_click": miou,
        # The decision rule: the CI holds 0 or |mean| < 0.01, click by click.
        "paired_delta_vs_base": {name: paired_delta_ci(vals, base)
                                 for name, vals in per_instance.items() if name != BASE},
    }
    print(json.dumps(report, indent=2))

    print("\n| variant | " + " | ".join(f"mIoU@{k + 1}" for k in range(args.clicks))
          + " | paired delta@last [95% CI] |")
    print("|---|" + "---|" * (args.clicks + 1))
    for name, vals in miou.items():
        if name == BASE:
            delta = "—"
        else:
            d = report["paired_delta_vs_base"][name]
            delta = f"{d['mean'][-1]:+.4f} [{d['ci95'][-1][0]:+.4f}, {d['ci95'][-1][1]:+.4f}]"
        print(f"| {name} | " + " | ".join(f"{v:.4f}" for v in vals) + f" | {delta} |")
    return report


if __name__ == "__main__":
    main()
