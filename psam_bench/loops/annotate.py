"""The annotate loop: one annotator in a closed loop, as the demo server
serves one.

A session opens the next cloud of a seeded pool
(``Predictor.set_pointcloud``, timed on the host to a synchronise:
``encode_p95_ms``), then clicks: the first with three candidate masks, the
others with the previous best logits as the mask prompt
(``Predictor.predict_masks``, whose logits come back to the host: each
click's host time feeds ``click_p95_ms``). ``session_ms`` is the window
over the sessions completed in it.

The mix's parameters: ``clouds`` scenes of ``points`` points
(``num_parts`` objects each) in the pool, ``plans_per_cloud`` click plans
a cloud of ``clicks`` clicks, ``warmup_sessions`` in set-up,
``check_sessions`` drawn from the window for the comparison,
``traced_sessions`` in the traced part.

The comparison, per checked session: the tokenizer's FPS centres, its
groups (the kind's: each centre's K nearest points, or each point's
nearest centre) and each point's three interpolation centres, as the share
of entries that differ (the worst session), and the cloud embeddings as the
norm of the difference over the reference's norm (the worst session). The
mask logits and IoU predictions of the first clicks (three masks each)
make one pool, those of the refining clicks another: each pool's
root-mean-square gap over the root-mean-square of the reference's logits
(or IoU predictions) of every checked click. A refining click's logits are
smaller than a first click's, so pooled together the first clicks would
drown the refining ones; and some refining clicks' logits all but cancel,
so a pool's gap over its own reference norm swings from seed to seed with
that norm, while the gap over every click's scale holds steady. Each click
is judged on the request it was: its clicks and the mask prompt the
annotator sent (the program's previous best logits).

Faults a test can plant underneath (``ctx.faults``): ``stale_state`` (a
cloud's encode kept for every later cloud), ``altered_answer`` (each
decode's first mask negated where the decoder makes it), ``mask_prompt_ignored``
(refining clicks decoded without their mask prompt).
"""

from __future__ import annotations

import os
import time

import numpy as np

from psam_bench import check, drive, scenes, trace, work
from psam_bench.reference import model as ref

FAULTS = ("stale_state", "altered_answer", "mask_prompt_ignored")


def serve_grouping(cfg: dict, n: int) -> tuple:
    """(G, K) of the reference eval rule: N > 30000 -> the serve grouping,
    else the model's own G capped at the cloud's power of two and K capped
    at N (K is None for a model without one)."""
    s, tok = cfg["serve"], cfg["model"]["tokenizer"]
    k_default = tok.get("patch_size")
    if n > 30000:
        g, k = s["group_number"], s["group_size"]
    else:
        g = 64
        while g < n:
            g *= 2
        g, k = min(tok["num_patches"], g), k_default
    return g, (None if k_default is None else min(k, n))


def make_clouds(tr: dict, seed: int) -> list:
    """The pool: ``clouds`` seeded scenes of ``points`` points in the unit
    sphere (rgb in [0, 1]), each with ``plans_per_cloud`` click plans. A
    plan picks an instance; its first click is a point inside it
    (positive), the next ones alternate outside (negative) and inside."""
    out = []
    for s in drive.seeds(seed, tr["clouds"]):
        sc = scenes.generate_scene(s, tr["points"], tuple(tr["num_parts"]))
        rng = np.random.default_rng([s, 1])
        xyz = scenes.unit_sphere(sc["coords"]).astype(np.float32)
        gt = sc["gt_masks"]
        plans = []
        for _ in range(tr["plans_per_cloud"]):
            inst = gt[int(rng.integers(len(gt)))]
            inside, outside = np.flatnonzero(inst), np.flatnonzero(~inst)
            labels = np.array([i % 2 == 0 for i in range(tr["clicks"])])
            idx = [int(rng.choice(inside if lab else outside)) for lab in labels]
            plans.append((xyz[idx], labels))
        out.append(dict(xyz=xyz, rgb=(sc["features"] / 255.0).astype(np.float32), plans=plans))
    return out


def plant(ctx: drive.Ctx, model, pred) -> None:
    """The faults of ``ctx.faults``, planted in the program's objects."""
    unknown = set(ctx.faults) - set(FAULTS)
    if unknown:
        raise ValueError(f"no such fault of the annotate loop: {sorted(unknown)}")
    if "altered_answer" in ctx.faults:
        decode = model.decode

        def altered(*a, **k):
            masks, iou = decode(*a, **k)
            return ctx.torch.cat([-masks[:, :1], masks[:, 1:]], 1), iou

        model.decode = altered
    if "stale_state" in ctx.faults:
        encode_once = pred.set_pointcloud

        def stale(*a, **k):
            if pred._state is None:
                encode_once(*a, **k)

        pred.set_pointcloud = stale
    if "mask_prompt_ignored" in ctx.faults:
        predict = pred.predict_masks

        def without_prompt(pts, labels, prompt_mask=None, **k):
            return predict(pts, labels, None, **k)

        pred.predict_masks = without_prompt


def run(ctx: drive.Ctx) -> dict:
    torch, cfg, tr = ctx.torch, ctx.config, ctx.traffic
    from point_sam_tpu_torch.serving.predictor import Predictor

    w_seed, pool_seed, res_seed = drive.seeds(ctx.seed, 3)
    model, shapes = drive.build_model(ctx, w_seed)
    pred = Predictor(model, device=ctx.device, point_buckets=cfg["serve"]["point_buckets"])
    clouds = make_clouds(tr, pool_seed)
    G, K = serve_grouping(cfg, tr["points"])
    plant(ctx, model, pred)

    encode_ms, click_ms = [], []

    def session(s: int, keep: bool):
        c = clouds[s % len(clouds)]
        pts, labels = c["plans"][(s // len(clouds)) % len(c["plans"])]
        t0 = time.perf_counter()
        pred.set_pointcloud(c["xyz"], c["rgb"])
        drive.synchronize(ctx)
        encode_ms.append((time.perf_counter() - t0) * 1e3)
        prev, answers, prompts = None, [], []
        for k in range(len(labels)):
            t1 = time.perf_counter()
            _, scores, logits = pred.predict_masks(pts[:k + 1], labels[:k + 1], prev,
                                                   multimask_output=k == 0)
            click_ms.append((time.perf_counter() - t1) * 1e3)
            if keep:
                prompts.append(prev)
                answers.append((logits[0], scores[0]))
            prev = logits[0, int(np.argmax(scores[0]))]
        if keep:
            return dict(cloud=s % len(clouds), pts=pts, labels=labels, prompts=prompts,
                        answers=answers, state=pred._state)
        return None

    for s in range(tr["warmup_sessions"]):
        session(s, False)
    encode_ms.clear()
    click_ms.clear()
    result = drive.window(ctx, session, tr["check_sessions"], res_seed)
    n = result["done"]
    drive.log(f"set-up {result['setup_s']:.1f} s; window {result['window_s']:.1f} s, "
              f"{n} sessions")
    metrics = dict(encode_p95_ms=drive.p95(encode_ms), session_ms=result["window_s"] * 1e3 / n,
                   setup_s=result["setup_s"])
    records = None
    if ctx.traced:
        records = traced(ctx, model, pred, clouds)
        records.update(host=dict(click_ms=list(click_ms), encode_ms=list(encode_ms)),
                       encode_flops=work.encode_flops(drive.ref_config(cfg), ctx.kind, 1,
                                                      tr["points"], G, K))
    peak = result["peak"]

    # The program's outputs of the checked sessions, then the program freed.
    kept = result["kept"]
    program_side = [program_session(ctx, k, tr["points"]) for k in kept]
    del pred, model, result
    drive.free(ctx)

    drive.log("program freed; the reference follows")
    state = dict(P=drive.reference_params(ctx, shapes, w_seed), clouds=clouds, kept=kept,
                 G=G, K=K)
    state["reference"] = reference(ctx, state, ref.FP32)
    detail = []
    got = numbers(program_side, state["reference"], detail)
    drive.log("reference done; per click (logits err, reference norm): "
              + ", ".join(f"({e:.4g}, {nrm:.4g})" for e, nrm in detail))
    return dict(metrics=metrics, numbers=got, records=records, peak=peak, done=n, state=state)


def traced(ctx: drive.Ctx, model, pred, clouds: list) -> dict:
    """A profiler session over ``traced_sessions`` sessions after the
    window, the model's methods in ranges; what the readers take of it."""
    torch, tr = ctx.torch, ctx.traffic
    names = {"make_geometry": "psam.geometry", "prompt_cache": "psam.prompt_cache",
             "encode": "psam.encode", "decode": "psam.decode"}
    trace.instrument(torch, model, names)
    launches = {"encode": {}}
    counters = drive.counters()

    def one(i):
        c = clouds[i % len(clouds)]
        pts, labels = c["plans"][0]
        before = drive.snapshot(counters)
        with torch.profiler.record_function("psam.set_pointcloud"):
            pred.set_pointcloud(c["xyz"], c["rgb"])
            drive.synchronize(ctx)
        if i >= 1:  # the profiler's warm-up iteration records nothing
            drive.add(launches["encode"], drive.diff(drive.snapshot(counters), before))
        prev = None
        for k in range(len(labels)):
            with torch.profiler.record_function("psam.predict_masks"):
                _, scores, logits = pred.predict_masks(pts[:k + 1], labels[:k + 1], prev,
                                                       multimask_output=k == 0)
            prev = logits[0, int(np.argmax(scores[0]))]

    path = os.path.join(ctx.tmpdir, f"psam_trace_{os.getpid()}.json")
    trace.profile(torch, one, 1, tr["traced_sessions"], path, ctx.device.type == "cuda")
    trace.uninstrument(model, names)
    records = trace.read(path, ("psam.set_pointcloud",))
    drive.log("traced part read")
    records.update(loop="annotate", launches=launches, n_real=tr["points"])
    return records


def program_session(ctx: drive.Ctx, k: dict, n: int) -> dict:
    """What the comparison reads of a checked session of the program: its
    cached geometry and embeddings, every click's logits and IoU scores."""
    st = k["state"]
    geom = st["geom"]
    dev = geom["fps_idx"].device
    return dict(fps_idx=geom["fps_idx"][0], groups=ctx.kind.program_groups(geom, n),
                interp_idx=geom["interp_index"][0, :n], emb=st["emb"][0],
                logits=[ctx.torch.as_tensor(lg).to(dev) for lg, _ in k["answers"]],
                iou=[ctx.torch.as_tensor(sc).to(dev) for _, sc in k["answers"]])


def reference(ctx: drive.Ctx, state: dict, prec) -> list:
    """The reference's outputs for each checked session: its own geometry
    and encode of the session's cloud, and every click of the session
    decoded from the same request (clicks and the mask prompt sent)."""
    torch, kind = ctx.torch, ctx.kind
    ref.fp32_matmuls()
    rc = drive.ref_config(ctx.config)
    P, dev = state["P"], ctx.device
    cache, out = {}, []
    with torch.no_grad():
        for k in state["kept"]:
            if k["cloud"] not in cache:
                c = state["clouds"][k["cloud"]]
                xyz = torch.as_tensor(c["xyz"], device=dev)[None]
                rgb = torch.as_tensor(c["rgb"], device=dev)[None]
                geom = ref.geometry(kind, xyz, state["G"], state["K"], prec)
                cache[k["cloud"]] = (xyz, geom, *ref.encode(P, kind, rc["vit"], xyz, rgb, geom,
                                                            prec))
            xyz, geom, emb, pe = cache[k["cloud"]]
            logits, ious = [], []
            for i, prompt in enumerate(k["prompts"]):
                pts = torch.as_tensor(k["pts"][:i + 1], device=dev)[None]
                labels = torch.as_tensor(k["labels"][:i + 1], device=dev)[None]
                pm = None if prompt is None else torch.as_tensor(prompt, device=dev)[None]
                m, io = ref.decode(P, kind, rc["decoder"], emb, pe, xyz, geom, pts, labels, pm,
                                   i == 0, prec)
                logits.append(m[0])
                ious.append(io[0])
            out.append(dict(fps_idx=geom["fps_idx"][0], groups=geom[kind.GROUPS][0],
                            interp_idx=geom["interp_idx"][0], emb=emb[0], logits=logits,
                            iou=ious))
    return out


POOLS = ("first_logits_gap", "first_iou_gap", "refine_logits_gap", "refine_iou_gap")


def numbers(program: list, reference: list, detail: list | None = None) -> dict:
    """program / reference: per checked session a dict with fps_idx [G],
    groups, interp_idx [N, 3], emb [G, 256], logits (per click [C, N]) and
    iou (per click [C]). ``detail`` gets each click's (logits error, the
    reference logits' norm)."""
    out = dict(centres_mismatch=0.0, groups_mismatch=0.0, interp_mismatch=0.0, embed_err=0.0)
    gaps = {name: [0.0, 0] for name in POOLS}  # the pool's squared gaps, its entries
    scale = {"logits": [0.0, 0], "iou": [0.0, 0]}  # every click's reference: squares, entries
    for p, r in zip(program, reference):
        out["centres_mismatch"] = max(out["centres_mismatch"],
                                      check.share_differ(p["fps_idx"], r["fps_idx"]))
        out["groups_mismatch"] = max(out["groups_mismatch"],
                                     check.share_differ(p["groups"], r["groups"]))
        out["interp_mismatch"] = max(out["interp_mismatch"],
                                     check.share_differ(p["interp_idx"], r["interp_idx"]))
        out["embed_err"] = max(out["embed_err"], check.rel(p["emb"].float(), r["emb"]))
        for what in ("logits", "iou"):
            for i, (a, b) in enumerate(zip(p[what], r[what])):
                a, b = a.double(), b.double()
                pool = gaps[f"{'first' if i == 0 else 'refine'}_{what}_gap"]
                pool[0] += float((a - b).square().sum())
                pool[1] += b.numel()
                scale[what][0] += float(b.square().sum())
                scale[what][1] += b.numel()
                if detail is not None and what == "logits":
                    detail.append((check.rel(a, b), float(b.norm())))
    for name in POOLS:
        sq, n = gaps[name]
        ref_sq, ref_n = scale[name.split("_")[1]]
        out[name] = (sq / max(n, 1)) ** 0.5 / max((ref_sq / max(ref_n, 1)) ** 0.5, 1e-30)
    return out


def control(ctx: drive.Ctx, state: dict, prec) -> tuple:
    """(numbers, the worst click's (error, norm)) of the reference at
    ``prec`` in the program's place, against the fp32 reference."""
    detail = []
    got = numbers(reference(ctx, state, prec), state["reference"], detail)
    return got, max(detail)
