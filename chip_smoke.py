#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (point_sam_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each fatal on failure (the script then exits non-zero before its
last line):

1. header: the card's name and power limit (nvidia-smi), torch, CUDA, nvcc;
2. build: compile the kernels from point_sam_tpu_torch/csrc (one nvcc per
   source, all started together), then print the attention, K2 and K7
   kernels' registers and stack (spill) bytes from ``cuobjdump
   --dump-resource-usage`` of the built library (reported, not gated; K7's
   four: the pass-C mma kernel, the pass-D mma kernel at both of its dw1a
   register tilings, and the one-launch kernel);
3. end to end, tiny config, fp32 (a ViT of 2 heads of 64, so K3 runs; G=128
   so the decoder tail takes K4): the Predictor on the CPU (plain versions)
   and on the card (kernels), same weights, cloud and 3 clicks;
4. the serving path: ViT-L (eva02_large) in bf16 with seeded random
   weights, a seeded 100k-point cloud (bucket 131072, G=2048, K=256),
   set_pointcloud and 3 clicks, with every kernel's launches read around
   that run, by shape (each wrapper tallies its launches by the sizes and
   dtypes it was called with);
5. each kernel of the serving path against its plain torch version at
   every shape and dtype that path launched it with, on seeded inputs, both
   timed with CUDA events (median after a warm-up), with the one PyTorch
   call of the same function as a yardstick where there is one (SDPA for
   K3 and K5; the port never calls it);
5b. K3 and K5 at their edges against their plain versions, fp32 and bf16:
   ragged S (77, 200, 2049) at every padded head size (dh 32, 64, 88,
   128), grids wider than one wave, large logits at the serve and voronoi
   shapes;
5c. K2 at the edges of its bf16 tensor-core kernel against its plain
   version, fp32 and bf16, both activations: the hier widths at K = 32
   (C_in = 131 among them), K = 256 at both output widths, K = 77, a grid
   wider than one wave, duplicated input rows (max-pool ties); two calls at
   the serve shape bit-equal;
6. end to end, tiny voronoi model in fp32 (a giant-shaped ViT: fused qkv,
   GELU MLP, D=176, 2 heads of 88, 2 blocks, so K5 runs; G=32, so the
   decoder tail takes the gather and K11): as 3, the card with K8, K10, K5
   and K11;
7. the voronoi EVA-giant serving path: ``build_model`` of
   configs/model/voronoi_giant.yaml (EVA-giant, 40 blocks, D=1408, 16
   heads, MLP 6144; hidden 256, patch channels 512, decoder depth 2) on
   the card in bf16 with seeded random weights, the Predictor over the
   same 100k-point cloud (G=2048 by the eval rule), set_pointcloud and 3
   clicks, launches read by shape;
8. as 5, for every kernel of the voronoi path (K4, K5, K8, K10);
9. end to end, tiny hier model in fp32 (the ViT of 3; G=(128, 32),
   K=(16, 8)): as 3, at the default grouping (K8, K10, K2, K3, K4) and at
   the override group_number=64 (the tail takes the gather and K11);
10. the hier serving path: ``build_model`` of configs/model/hier.yaml
   (EVA02-L ViT, G=(2048, 512), K=(32, 32), radii (0.05, 0.1)) in bf16,
   the Predictor over the same cloud, set_pointcloud and 3 clicks at the
   model's grouping (K8, K10 twice, K2 at four shapes, K3, K4), then again
   with the Predictor's level-1 override group_number=4096 (the tail's
   K4 gate fails: the gather and K11), launches read by shape around each;
11. as 5, for every kernel of both hier runs, and the decoder tail at the
   override's shape by both routes on the same inputs (the cloud's level-1
   geometry, C=3 and C=1): K4 against the gather and K11 the path takes;
12. the fused-geometry serving path: the ViT-L Predictor of 4 built with
   ``knn_method="approx"``: K9 once per encode (FPS, 3-NN
   and the binned kNN in one pass, then a top-k over 4096 bins) and
   neither K1 nor the exact kNN; then as 5 for its kernels, K9 held to
   equal outputs and to a recall >= 0.9 against the exact kNN;
13. tiny train step in fp32 (the ViT of 3, so K3 and K6 run; G=32, so the
   forward's tail is K11): the CPU with the plain versions against the
   card with the kernels, same weights, batch and clicks; then the card's
   step again, every grad bit-equal, and (printed) how many grads differ
   with the gathers' backward as autograd's own, plainly and under
   ``torch.use_deterministic_algorithms(True)``;
14. the training path: ViT-L through ``trainer.main`` with the reference
   recipe (configs/large.yaml on synthetic data: B=2, N=10,000, M=2,
   G=1024, K=256, 5 click iterations, bf16 compute, fp32 AdamW), 5 steps,
   with the launches read around that run, by shape;
15. as 5, for every kernel of the training path (K1-K4 forward, K6 and K7
   backward; SDPA's backward is K6's yardstick). K2 runs there with its
   argmax outputs (the max-pools' first rows the backward reads): they are
   checked against the plain forward's a2 / a4, on inputs with repeated
   rows (the first copy must win), and timed with and without them; K7 is given K2's saved max-pools from a launch outside its timed
   calls, and its plain version the same ones; on its bf16 mma route its
   pass C alone and passes C and D are timed too (pass D and the reduction
   by difference), with pass D's own bound (``pe_bwd_d_work``). Then K2 ->
   K7 twice at the train shape must return the same bits;
15c. K7 at the edges of its bf16 mma route against its plain version, both
   activations, grids of 160-320 patches: the train widths at K = 256, K =
   77, the hier level-2 (C_in = 131) and level-1 widths at K = 32, h0 =
   96, duplicated rows; fp32 on the one-launch route; each launch's route
   checked; in bf16 pass D alone, given the da2 the kernel wrote, against
   ``patch_encoder_bwd_stage1_plain`` with dx and without; two calls at the
   train shape -> 512 bit-equal;
15b. K6 at its edges against its plain version, fp32 and bf16: ragged S
   (77, 200, 2049) at every padded head size (dh 32, 64, 88, 128), dh = 36
   (not a multiple of 8: the bf16 kernels' element-wise loads and stores), a
   grid wider than one wave, large logits at the train shape; two calls at the
   train shape bit-equal; the kernel's and the plain version's error against
   an fp32 reference on the same bf16 inputs, printed;
16. profiles under torch.profiler (device time by stage; K7 by kernel:
   pass C, pass D, the reduction): one ViT-L train step, timed on one batch before and after that profiler session, then
   one encode of each serving path (ViT-L, voronoi EVA-giant, hier at
   both groupings, fused-geometry ViT-L) on its model built anew, then 20
   calls of K6 and 20 of SDPA's backward at the train shape. They come last, after
   every timed phase, because a profiler session slows the host's
   launches for the rest of the process.

Every kernel's bound (bound_ms) is computed here from this run's shapes:
the larger of bytes / 3.35 TB/s and the operations over the card's peak
for their type (989 TFLOP/s bf16 tensor, 67 TFLOP/s fp32), H100 SXM data
sheet figures at 700 W. K7's counts only the work the function needs
(``pe_bwd_work``): the forward's last Dense is K2's, which gives K7 its
argmaxes, and the backward's rows are only those the max-pool grads reach,
counted from this run's argmaxes.

The kernels' JSON record has one row per kernel, path and launch shape.
The second-to-last lines are that record and the nvidia-smi
line; the last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import copy
import json
import math
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
N_FLAGSHIP = 100_000
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "fp32": 67e12}


def bound(nbytes: float, ops: dict) -> tuple[float, str]:
    """(least ms for the work, what bounds it): bytes over the memory rate
    against the operations over the peak rate of their type."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = sum(n / PEAK_FLOPS[kind] for kind, n in ops.items()) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def pe_work(rows, groups, cin, h0, h1, cout, elem, argmax=False):
    """(bytes, FLOPs) of one K2 forward over ``rows`` grouped points; with
    ``argmax`` it also writes pool, arg2 and arg4."""
    w = cin * h0 + h0 * h0 + 2 * h0 * h1 + h1 * cout
    flops = 2 * rows * (cin * h0 + h0 * h0 + h0 * h1 + h1 * cout) + 2 * groups * h0 * h1
    saved = argmax * groups * (h0 * elem + 4 * (h0 + cout))
    return rows * cin * elem + w * elem + groups * cout * elem + saved, flops


def pe_bwd_work(groups, cin, h0, h1, cout, elem, need_dx, rows, rows4, rows_any):
    """(bytes, FLOPs) of one K7 launch, counting only what the function
    needs. The max-pool grads reach ``rows4`` rows (the distinct arg4 rows
    of each patch, summed) and ``rows_any`` (arg2 and arg4 together); LN
    and GELU act row by row, so da3 is zero off the first and da2 off the
    second. At ``rows_any``: stage 1's first Dense, LN and GELU, and da2
    w1b^T, g1^T da2, x^T da1 (and da1 w1a^T for dx). At ``rows4``: stage
    1's second Dense, stage 2 up to its GELU, da3 w2x^T and a2^T da3. Per
    patch: up_pool, and the sparse products at the argmax entries and the
    pooled branch (dg3, dw2b, d3c w2p^T, pool^T d3c). Bytes: x, dout, the
    weights, K2's saved pool / arg2 / arg4 read once; the fp32 grads (and dx
    over all ``rows``) written once."""
    w = cin * h0 + h0 * h0 + 2 * h0 * h1 + h1 * cout
    nparam = w + 4 * h0 + 3 * h1 + cout
    fwd = 2 * rows_any * cin * h0 + 2 * rows4 * (h0 * h0 + h0 * h1) + 2 * groups * h0 * h1
    bwd = 2 * rows4 * 2 * h0 * h1 + 2 * rows_any * (2 * h0 * h0 + (1 + need_dx) * cin * h0)
    sparse = 2 * groups * (2 * cout * h1 + 2 * h0 * h1)
    nbytes = (rows * cin * elem + w * elem + groups * cout * elem
              + groups * (h0 * elem + 4 * (h0 + cout)) + nparam * 4 + need_dx * rows * cin * elem)
    return nbytes, fwd + bwd + sparse


def pe_bwd_d_work(rows, cin, h0, elem, need_dx):
    """(bytes, FLOPs) of K7's pass D alone over ``rows`` grouped points, at
    every row it runs: the fp32 da2 read and x read once (dx written once
    when asked for); the first Dense, da2c w1b^T and g1^T da2c, x^T da1
    (and da1 w1a^T for dx)."""
    nbytes = rows * h0 * 4 + rows * cin * elem * (1 + need_dx)
    return nbytes, 2 * rows * (2 * h0 * h0 + (2 + need_dx) * cin * h0)


def pe_distinct_rows(torch, K, *args) -> int:
    """The distinct rows that the argmax tensors [B, G, C] name in each
    patch of K rows, summed over the patches."""
    hit = torch.zeros((*args[0].shape[:2], K), dtype=torch.bool, device=args[0].device)
    for a in args:
        hit.scatter_(2, a.long(), True)
    return int(hit.sum())


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def nvcc_version() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    out = subprocess.run([nvcc, "--version"], capture_output=True, text=True, timeout=60,
                         check=True)
    return out.stdout.strip().splitlines()[-1]


def time_ms(torch, fn, reps: int = 5) -> float:
    """Median device time of ``fn`` over ``reps`` runs after one warm-up."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def synthetic_cloud(rng, n: int):
    """A seeded clustered scene in the unit sphere: a ground plane, boxes
    and blobs, colours by object (the kind of cloud the slice segments)."""
    import numpy as np

    parts, cols = [], []
    k = n // 4
    plane = np.c_[rng.uniform(-1, 1, (k, 2)), rng.normal(-0.5, 0.005, k)]
    parts.append(plane)
    cols.append(np.tile([0.4, 0.4, 0.4], (k, 1)))
    rest = n - k
    n_obj = 12
    for j in range(n_obj):
        m = rest // n_obj + (1 if j < rest % n_obj else 0)
        c = rng.uniform(-0.7, 0.7, 3) * [1, 1, 0.5] + [0, 0, 0.1]
        if j % 2:
            pts = c + rng.uniform(-1, 1, (m, 3)) * rng.uniform(0.05, 0.2, 3)
        else:
            pts = c + rng.normal(0, rng.uniform(0.03, 0.1), (m, 3))
        parts.append(pts)
        cols.append(np.tile(rng.random(3), (m, 1)))
    xyz = np.concatenate(parts).astype(np.float32)
    xyz -= xyz.mean(0)
    xyz /= np.linalg.norm(xyz, axis=1).max()
    rgb = np.concatenate(cols).astype(np.float32)
    perm = rng.permutation(n)
    return xyz[perm], rgb[perm]


def reset(counters) -> None:
    """Set every kernel wrapper's launch counts to 0."""
    for fn in counters.values():
        fn.launches = 0
        fn.shapes = {}


def within(label: str, rel: float):
    """Compare by the largest error against the largest plain entry."""
    def compare(got, want):
        err = (got.float() - want.float()).abs().max().item()
        scale = want.float().abs().max().item()
        check(err <= rel * scale, f"{label}: max err {err:.3g} > {rel} of {scale:.3g}")
        return err
    return compare


def pe_params(randn, cin, h0, h1, cout):
    """The 12 patch-encoder parameters (matrices [in, out]) from ``randn``."""
    def mat(i, o):
        return randn(i, o, scale=i ** -0.5)

    def vec(d, mean=0.0):
        return mean + randn(d, scale=0.1)

    return (mat(cin, h0), vec(h0), vec(h0, 1.0), vec(h0), mat(h0, h0), vec(h0),
            mat(2 * h0, h1), vec(h1), vec(h1, 1.0), vec(h1), mat(h1, cout), vec(cout))


def kernel_case(torch, np, mods, name: str, key: dict, g):
    """Kernel ``name`` at one launch key of its wrapper (the sizes and dtypes
    its ``count_launch`` recorded): seeded inputs on the card, the kernel
    and plain calls, how to compare them, the work for the bound, and the
    one PyTorch call of the same function where there is one."""
    F, PE, A, UP, IW, K = mods
    dev = torch.device("cuda")
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def randn(*shape, scale=1.0):
        return torch.randn(shape, device=dev, generator=g) * scale

    def dtype(field):
        dt = getattr(torch, key[field].rsplit(".", 1)[-1])
        return dt, dt.itemsize, "bf16" if dt == torch.bfloat16 else "fp32"

    def cloud(B, N, with_valid):
        """B seeded scenes padded to N (100k real points at the serve
        bucket), the padding at 0 as the Predictor pads; valid or None."""
        n_real = min(N, N_FLAGSHIP) if with_valid else N
        pts = torch.zeros((B, N, 3), device=dev)
        for b in range(B):
            xyz, _ = synthetic_cloud(np.random.default_rng(b), n_real)
            pts[b, :n_real] = torch.from_numpy(xyz).to(dev)
        valid = None
        if with_valid:
            valid = torch.zeros((B, N), dtype=torch.bool, device=dev)
            valid[:, :n_real] = True
        return pts, valid, n_real

    def exact(label, fields):
        def compare(got, want):
            got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
            for field, a, b_ in zip(fields, got, want):
                check(torch.equal(a, b_), f"{label} {field} differs from its plain version")
            return 0.0
        return compare

    if name == "K1":
        B, N, G = key["B"], key["N"], key["G"]
        pts, valid, n_real = cloud(B, N, key["valid"])

        # ~10 fp32 operations per real point per selection step (distance,
        # min, the running argmax and best-3); the G sequential steps each
        # end in a grid-wide sync, a latency floor the roofline does not see.
        nbytes = B * (N * (3 * 4 + (valid is not None)) + G * 16 + N * 3 * 8)
        return dict(run=lambda: F.fps_interp_cuda(pts, G, valid=valid),
                    plain=lambda: F.fps_interp_plain(pts, G, valid=valid),
                    compare=exact("K1", ("idx", "centers", "interp_idx", "interp_d2")),
                    work=(nbytes, {"fp32": 10.0 * B * n_real * G}))

    if name == "K9":
        B, N, G, k = key["B"], key["N"], key["G"], key["k"]
        pts, valid, n_real = cloud(B, N, key["valid"])

        # Equal outputs, and the binned kNN's recall against the exact kNN
        # of the same centres (the mean share of each centre's k nearest
        # valid points that K9 returns) at least 0.9.
        def equal_and_recall(got, want):
            exact("K9", ("idx", "centers", "interp_idx", "interp_d2", "knn_idx"))(got, want)
            _, truth = K.knn(got[1], pts, k, key_valid=valid, method="exact")
            hit = (got[4][..., :, None] == truth[..., None, :]).any(-1).float().mean().item()
            check(hit >= 0.9, f"K9 kNN recall {hit:.4f} < 0.9")
            print(f"K9 kNN recall against the exact kNN: {hit:.4f} (B={B}, N={N}, G={G}, "
                  f"k={k})", flush=True)
            return 0.0

        # K1's ~10 fp32 operations per real point per step plus the bin
        # fold's ~3 (mask, compare, select); the cd / ci bins [G, 4096]
        # written once and the [G, k] ids.
        nbins = 4096
        nbytes = B * (N * (3 * 4 + (valid is not None)) + G * 16 + N * 3 * 8 + G * nbins * 8
                      + G * k * 4)
        return dict(run=lambda: F.fps_interp_knn_cuda(pts, G, k, valid=valid),
                    plain=lambda: F.fps_interp_knn_plain(pts, G, k, valid=valid),
                    compare=equal_and_recall, work=(nbytes, {"fp32": 13.0 * B * n_real * G}))

    if name == "K8":
        B, N, G = key["B"], key["N"], key["G"]
        pts, valid, n_real = cloud(B, N, key["valid"])
        # ~10 fp32 operations per real point per step (distance, min, the
        # running argmax), below the same sync floor as K1.
        nbytes = B * (N * (3 * 4 + (valid is not None)) + G * 4)
        return dict(run=lambda: F.fps_cuda(pts, G, valid=valid),
                    plain=lambda: F.fps_plain(pts, G, valid=valid), compare=exact("K8", ("idx",)),
                    work=(nbytes, {"fp32": 10.0 * B * n_real * G}))

    if name == "K10":
        B, N, G = key["B"], key["N"], key["G"]
        query, _, _ = cloud(B, N, N > N_FLAGSHIP)
        keys = query[:, torch.randperm(min(N, N_FLAGSHIP), generator=g, device=dev)[:G]]

        # Indices equal; weights within 1e-6 (only the division may round
        # differently).
        def same_neighbours(got, want):
            check(torch.equal(got[0], want[0]), "K10 indices differ from its plain version")
            err = (got[1] - want[1]).abs().max().item()
            check(err <= 1e-6, f"K10 weights differ by {err:.3g} > 1e-6")
            return err

        # ~14 fp32 operations per (query, key) pair: 3 differences, 3
        # multiply-adds and the best-3 compares; every query is computed.
        return dict(run=lambda: IW.interp_weights_cuda(query, keys),
                    plain=lambda: IW.interp_weights_plain(query, keys), compare=same_neighbours,
                    work=(B * (N * 12 + G * 12 + N * 24), {"fp32": 14.0 * B * N * G}))

    if name == "K5":
        B, H, S, dh = key["B"], key["heads"], key["S"], key["dh"]
        dt, elem, kind = dtype("dtype")
        q, k, v = (randn(B, H, S, dh).to(dt) for _ in range(3))
        return dict(run=lambda: A.mha_heads_cuda(q, k, v),
                    plain=lambda: A.mha_heads_plain(q, k, v), compare=within("K5", 2e-2),
                    work=(4 * B * H * S * dh * elem, {kind: 4.0 * B * H * S * S * dh}),
                    library=lambda: sdpa(q, k, v))

    if name in ("K2", "K7"):
        B, G, K, cin, h0, h1, cout = (key[f] for f in ("B", "G", "K", "cin", "h0", "h1", "cout"))
        cdt, elem, kind = dtype("cdt")
        params = pe_params(randn, cin, h0, h1, cout)
        x = randn(B, G * K, cin).to(cdt)
        kw = dict(num_groups=G, group_size=K, cdt=cdt, act=key["act"])
        rows = B * G * K
        if name == "K2":
            argmax = key["argmax"]
            nbytes, flops = pe_work(rows, B * G, cin, h0, h1, cout, elem, argmax)
            case = dict(run=lambda: PE.patch_encoder_cuda(x, params, return_argmax=argmax, **kw),
                        plain=lambda: PE.patch_encoder_plain(x, params, return_argmax=argmax, **kw),
                        compare=within("K2", 2e-2), work=(nbytes, {kind: flops}))
            if argmax:  # the output as without them, and the rows checked
                case["compare"] = lambda got, want: pe_argmax_check(
                    torch, PE, x, params, kw, got, want, PE.patch_encoder_cuda(x, params, **kw))
                case["without"] = lambda: PE.patch_encoder_cuda(x, params, **kw)
            return case
        need_dx = key["need_dx"]
        dout = randn(B, G, cout).to(cdt)
        # K2's saved max-pools, made outside the timed calls; the plain
        # version gets the same ones.
        _, saved = PE.patch_encoder_cuda(x, params, return_argmax=True, **kw)

        # Both sides route the max-pool grads to K2's rows, but recompute
        # the activations in another summation order, so the grads are held
        # in norm: ||diff|| <= 5e-2 ||plain||.
        def in_norm(got, want):
            pairs = list(zip(got[1], want[1])) + ([(got[0], want[0])] if need_dx else [])
            err = 0.0
            for i, (a, w) in enumerate(pairs):
                diff = (a - w).float()
                rel = (diff.norm() / w.float().norm().clamp_min(1e-30)).item()
                check(rel <= 5e-2, f"K7 grad {i}: norm err {rel:.3g} > 5e-2")
                err = max(err, diff.abs().max().item())
            return err

        rows4, rows_any = (pe_distinct_rows(torch, K, *a) for a in (saved[2:], saved[1:]))
        print(f"K7 [{B}, {G}*{K}, {cin}] -> {cout}: the max-pool grads reach {rows4} rows "
              f"through arg4 and {rows_any} through arg2 or arg4, of {rows}", flush=True)
        nbytes, flops = pe_bwd_work(B * G, cin, h0, h1, cout, elem, need_dx, rows, rows4, rows_any)
        case = dict(
            run=lambda: PE.patch_encoder_bwd_cuda(x, params, dout, need_dx=need_dx, saved=saved,
                                                  **kw),
            plain=lambda: PE.patch_encoder_bwd_plain(x, params, dout, saved=saved, **kw),
            compare=in_norm, work=(nbytes, {kind: flops}))
        if key["route"] == "mma":  # pass C alone, then C and D, timed apart
            nbytes, flops = pe_bwd_d_work(rows, cin, h0, elem, need_dx)
            case["pass_d_work"] = (nbytes, {kind: flops})
            launch = dict(saved=saved, need_dx=need_dx, **kw)
            case["passes"] = [
                lambda: PE._bwd_launch(x, params, dout, passes=PE.BWD_PASS_C, **launch),
                lambda: PE._bwd_launch(x, params, dout, passes=PE.BWD_PASS_C | PE.BWD_PASS_D,
                                       **launch)]
        return case

    if name in ("K3", "K6"):
        B, S, D, H = key["B"], key["S"], key["D"], key["heads"]
        dt, elem, kind = dtype("dtype")
        q, k, v, do = (randn(B, S, D).to(dt) for _ in range(4))
        heads = [t.view(B, S, H, D // H).transpose(1, 2).contiguous() for t in (q, k, v, do)]
        product = 2.0 * B * S * S * D  # one S x S x dh product over every head
        if name == "K3":
            return dict(run=lambda: A.mha_cuda(q, k, v, H), plain=lambda: A.mha_plain(q, k, v, H),
                        compare=within("K3", 2e-2),
                        work=(4 * B * S * D * elem, {kind: 2 * product}),
                        library=lambda: sdpa(*heads[:3]))

        def each_grad(got, want):
            return max(within(f"K6 d{f}", 2e-2)(a, b) for f, a, b in zip("qkv", got, want))

        sq, sk, sv = (t.requires_grad_() for t in heads[:3])
        with torch.enable_grad():
            sout = sdpa(sq, sk, sv)
        # The five products the function needs (q k^T, do v^T, p^T do, ds k,
        # ds^T q), at the type the kernel runs them in: bf16 on the tensor
        # cores, or fp32 FMA.
        return dict(run=lambda: A.mha_packed_bwd_cuda(q, k, v, do, H),
                    plain=lambda: A.mha_packed_bwd_plain(q, k, v, do, H), compare=each_grad,
                    work=(7 * B * S * D * elem, {kind: 5 * product}),
                    library=lambda: torch.autograd.grad(sout, (sq, sk, sv), heads[3],
                                                        retain_graph=True))

    if name == "K4":
        B, M, G, N, D, C = (key[f] for f in ("B", "M", "G", "N", "D", "C"))
        cdt, elem, kind = dtype("cdt")
        h1 = randn(B * M, G, D).to(cdt)
        idx = torch.randint(0, G, (B, N, 3), device=dev, generator=g, dtype=torch.int32)
        w = torch.rand((B, N, 3), device=dev, generator=g)
        w = w / w.sum(-1, keepdim=True)
        params = (1.0 + randn(D, scale=0.1), randn(D, scale=0.1), randn(D, D, scale=D ** -0.5),
                  randn(D, scale=0.1))
        hyper = randn(B * M, C, D).to(cdt)
        nbytes = (B * M * G * D * elem + B * N * 3 * 8 + D * D * elem + B * M * C * D * elem
                  + B * M * C * N * 4)
        return dict(
            run=lambda: UP.interp_upscale_cuda(h1, idx, w, params, hyper, cdt=cdt),
            plain=lambda: UP.interp_upscale_plain(h1, idx, w, params, hyper, cdt=cdt),
            compare=within("K4", 2e-2),
            work=(nbytes, {kind: 2.0 * B * M * N * D * D + 2.0 * B * M * C * N * D}))

    if name == "K11":
        BM, N, D, C = (key[f] for f in ("BM", "N", "D", "C"))
        cdt, elem, kind = dtype("cdt")
        x = randn(BM, N, D).to(cdt)
        params = (1.0 + randn(D, scale=0.1), randn(D, scale=0.1), randn(D, D, scale=D ** -0.5),
                  randn(D, scale=0.1))
        hyper = randn(BM, C, D).to(cdt)
        nbytes = BM * N * D * elem + D * D * elem + BM * C * D * elem + BM * C * N * 4
        return dict(
            run=lambda: UP.upscale_hyper_cuda(x, params, hyper, cdt=cdt),
            plain=lambda: UP.upscale_hyper_reference(x, params, hyper, cdt=cdt),
            compare=within("K11", 2e-2),
            work=(nbytes, {kind: 2.0 * BM * N * D * D + 2.0 * BM * C * N * D}))
    raise ValueError(name)


def pe_stages(torch, PE, x, params, G, K, cdt, act):
    """The plain K2 forward's a2 [B, G, K, h0] and a4 [B, G, K, C_out], each
    with its product rounded to cdt before the bias is added (p2, p4)."""
    w1a, b1a, s1, t1, w1b, b1b, w2a, b2a, s2, t2, w2b, b2b = params
    x = x.reshape(x.shape[0], G, K, -1)
    p2 = PE._mm(PE.ln_gelu(PE._dense(x, w1a, b1a, cdt), s1, t1, cdt, act), w1b, cdt).to(cdt)
    a2 = p2 + b1b.to(cdt)
    h0 = a2.shape[-1]
    up = (torch.matmul(a2.float(), w2a[h0:].to(cdt).float())
          + torch.matmul(PE.first_max(a2, 2).float(), w2a[:h0].to(cdt).float())[:, :, None])
    a3 = up.to(cdt) + b2a.to(cdt)
    p4 = PE._mm(PE.ln_gelu(a3, s2, t2, cdt, act), w2b, cdt).to(cdt)
    return a2, p2, p4 + b2b.to(cdt), p4


def pe_ties(x):
    """Duplicate rows of x [B, G, K, C_in] in place, across each level of
    K2's reduction: 1 = 0 (one fragment), 40 = 3 (another row group), 70 =
    10 (another 64-row chunk), 200 = 130 (another chunk and m-tile). The
    copies 1, 40, 70, 200 are never a first maximum; the sources are
    returned for the count of columns whose maximum is a duplicated row."""
    pairs = ((0, 1), (3, 40), (10, 70), (130, 200))
    for src, dst in pairs:
        x[:, :, dst] = x[:, :, src]
    return [src for src, _ in pairs], [dst for _, dst in pairs]


def pe_argmax_check(torch, PE, x, params, kw, got, want, without):
    """K2 with its argmax outputs: the output bit-equal to the call without
    them and within 2e-2 of plain (the K2 tolerance). K2 and plain may round
    each row's product and its sum with the bias one ulp apart, so at most
    2 ulps of the column's scale (its largest product or output magnitude
    over K) per row: at each column's arg2 / arg4 row the plain a2 / a4
    lies at most 4 such ulps below that column's plain max, and pool within
    2 of it (worst of each printed). Then, on inputs whose rows repeat at
    each level of the reduction (``pe_ties``), no copy is ever the row
    chosen: a kernel that kept the last of tied maxima fails here."""
    out, (pool, arg2, arg4) = got
    check(torch.equal(out, without), "K2: the output differs with the argmax outputs")
    err = within("K2", 2e-2)(out, want[0])
    G, K = kw["num_groups"], kw["group_size"]
    a2, p2, a4, p4 = (a.float() for a in pe_stages(torch, PE, x, params, G, K, kw["cdt"],
                                                   kw["act"]))
    bits = 7 if kw["cdt"] == torch.bfloat16 else 23
    worst = []
    for label, a, p, arg, limit in (("arg2", a2, p2, arg2, 4), ("arg4", a4, p4, arg4, 4),
                                    ("pool", a2, p2, None, 2)):
        top = a.amax(2)
        scale = torch.maximum(a.abs(), p.abs()).amax(2)
        ulp = torch.exp2(torch.floor(torch.log2(scale.clamp_min(1e-30))) - bits)
        if arg is None:
            off = (pool.float() - top).abs()
        else:
            off = top - torch.take_along_dim(a, arg.long()[:, :, None], 2).squeeze(2)
        ulps = (off / ulp).max().item()
        check(ulps <= limit, f"K2 {label}: {ulps:.3g} ulps of its column's scale off its "
              f"column's max (limit {limit})")
        worst.append(f"{label} {ulps:.3g} ulp ({int((off > ulp).sum())} columns above 1)")
    x4 = x.clone().reshape(x.shape[0], G, K, -1)
    sources, copies = pe_ties(x4)
    _, (_, targ2, targ4) = PE.patch_encoder_cuda(x4.reshape(x.shape), params,
                                                 return_argmax=True, **kw)
    for label, arg in (("arg2", targ2), ("arg4", targ4)):
        check(not any(bool((arg == r).any()) for r in copies),
              f"K2 {label}: a later copy of a tied row chosen over the first")
    tied = sum(int((t == r).sum()) for t in (targ2, targ4) for r in sources)
    print(f"K2 argmax outputs [{x.shape[0]}, {x.shape[1]}, {x.shape[2]}] -> {out.shape[-1]}: "
          f"worst distance from the plain column max, in ulps of the column's scale: "
          + "; ".join(worst) + f"; with rows {copies} copying {sources}, {tied} columns' "
          f"maxima at a duplicated row, no copy chosen", flush=True)
    return err


def pe_train_repeats(torch, PE) -> None:
    """K2 with its argmax outputs, then K7 on them, twice at the train
    shape [4, 1024 * 256, 4] h(128, 512) -> 256, bf16: every output and
    grad bit-equal."""
    g = torch.Generator(device="cuda").manual_seed(8)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, device="cuda", generator=g) * scale

    params = pe_params(randn, 4, 128, 512, 256)
    x = randn(4, 1024 * 256, 4).to(torch.bfloat16)
    dout = randn(4, 1024, 256).to(torch.bfloat16)
    kw = dict(num_groups=1024, group_size=256, cdt=torch.bfloat16)
    runs = []
    for _ in range(2):
        out, saved = PE.patch_encoder_cuda(x, params, return_argmax=True, **kw)
        _, grads = PE.patch_encoder_bwd_cuda(x, params, dout, need_dx=False, saved=saved, **kw)
        runs.append((out, *saved, *grads))
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(*runs)), "K2 -> K7 at the train shape: two runs "
          "differ")
    print("K2 -> K7 [4, 1024*256, 4] h(128, 512) -> 256 bf16: output, pool, arg2, arg4 and the "
          "12 grads bit-equal over two runs", flush=True)


def patch_encoder_bwd_edges(torch, PE) -> None:
    """Phase 15c: K7 (``patch_encoder_bwd_cuda``) at the edges of its bf16
    mma route against ``patch_encoder_bwd_plain`` given the same K2 rows,
    both activations, on grids of 160-320 patches (above one wave of 132
    blocks, so blocks walk two or three patches): the train widths at K = 256
    (-> 256, -> 512), K = 77 (a ragged last 64-row chunk), the hier level-2
    (C_in = 131, -> 256 and -> 512) and level-1 (C_in = 4 and 6) widths at
    K = 32, h0 = 96 at K = 64, duplicated input rows (ties in both
    max-pools). bf16 takes the mma route (the launch counter's route is
    checked) and is held in norm within 5e-2; fp32 takes the one-launch
    route, each grad within 1e-4 of its largest plain entry. In bf16, pass
    D alone: the kernel's six stage-1 grads and dx, with dx and without,
    against ``patch_encoder_bwd_stage1_plain`` given the da2 that pass C
    wrote and pass D read, each within 1e-2 in norm (each output's worst
    share of that bound printed). Then two K7 calls at the train shape [2,
    1024 * 256, 6] -> 512 in bf16 must return the same bits."""
    g = torch.Generator(device="cuda").manual_seed(9)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, device="cuda", generator=g) * scale

    # (B, G, K, C_in, h0, h1, C_out, ties)
    cases = [(2, 80, 256, 4, 128, 512, 256, False), (2, 80, 256, 6, 128, 512, 512, False),
             (2, 80, 77, 4, 128, 512, 256, False), (2, 96, 32, 131, 128, 256, 256, False),
             (2, 96, 32, 131, 128, 256, 512, False), (2, 160, 32, 4, 64, 128, 128, False),
             (2, 160, 32, 6, 64, 128, 128, False), (2, 80, 32, 6, 128, 512, 512, True),
             (2, 96, 64, 6, 96, 256, 128, False)]
    worst = {}
    names_d = ("dw1a", "db1a", "ds1", "dt1", "dw1b", "db1b", "dx")
    worst_d = dict.fromkeys(names_d, 0.0)
    for B, G, K, cin, h0, h1, cout, ties in cases:
        prm = pe_params(randn, cin, h0, h1, cout)
        x = randn(B, G, K, cin)
        if ties:
            x[:, :, 1] = x[:, :, 0]
            x[:, :, 5] = x[:, :, 3]
        x = x.reshape(B, G * K, cin)
        dout = randn(B, G, cout)
        for dt, route in ((torch.float32, "single"), (torch.bfloat16, "mma")):
            for act in ("erf", "tanh"):
                kw = dict(num_groups=G, group_size=K, cdt=dt, act=act)
                label = (f"edge K7 [B={B}, G={G}, K={K}, C_in={cin}] h({h0}, {h1}) -> {cout}"
                         f"{' ties' if ties else ''} {act} {dt}")
                xd, dd = x.to(dt), dout.to(dt)
                _, saved = PE.patch_encoder_cuda(xd, prm, return_argmax=True, **kw)
                PE.patch_encoder_bwd_cuda.shapes = {}
                got = PE.patch_encoder_bwd_cuda(xd, prm, dd, saved=saved, **kw)
                (launch,) = PE.patch_encoder_bwd_cuda.shapes
                check(dict(launch)["route"] == route, f"{label}: route {dict(launch)['route']}")
                want = PE.patch_encoder_bwd_plain(xd, prm, dd, saved=saved, **kw)
                for i, (a, w) in enumerate(zip((got[0], *got[1]), (want[0], *want[1]))):
                    check(a.shape == w.shape and bool(torch.isfinite(a).all()),
                          f"{label} grad {i}: {a.shape}, or not finite")
                    diff = (a - w).float()
                    if dt == torch.bfloat16:
                        share = (diff.norm() / w.float().norm().clamp_min(1e-30)).item() / 5e-2
                    else:
                        share = diff.abs().max().item() / (1e-4 * w.float().abs().max().item()
                                                           + 1e-30)
                    check(share <= 1.0, f"{label} grad {i}: {share:.3g} of its tolerance")
                    key = f"{route} {str(dt).rsplit('.', 1)[-1]}"
                    worst[key] = max(worst.get(key, 0.0), share)
                if dt != torch.bfloat16:
                    continue
                for need_dx in (True, False):  # pass D alone, given the kernel's da2
                    dx, grads, _, da2 = PE._bwd_launch(xd, prm, dd, saved=saved, need_dx=need_dx,
                                                       return_da2=True, **kw)
                    wdx, wgrads = PE.patch_encoder_bwd_stage1_plain(
                        xd.reshape(-1, cin), prm, da2, cdt=dt, act=act, need_dx=need_dx)
                    pairs = list(zip(grads[:6], wgrads))
                    pairs += [(dx.reshape(-1, cin), wdx)] if need_dx else []
                    for name, (a, w) in zip(names_d, pairs):
                        diff = (a - w).float()
                        share = (diff.norm() / w.float().norm().clamp_min(1e-30)).item() / 1e-2
                        check(bool(torch.isfinite(a).all()) and share <= 1.0,
                              f"{label} pass D {name} (need_dx={need_dx}): {share:.3g} of its "
                              f"1e-2 norm bound, or not finite")
                        worst_d[name] = max(worst_d[name], share)
    torch.cuda.synchronize()
    print(f"K7 edges: {len(cases)} shapes x 2 dtypes x 2 activations against plain, worst error "
          f"as a share of its tolerance: " + ", ".join(f"{k} {w:.3g}" for k, w in worst.items()),
          flush=True)
    print("K7 pass D alone (bf16, given the kernel's da2) against patch_encoder_bwd_stage1_plain, "
          "worst norm error as a share of its 1e-2 bound: "
          + ", ".join(f"{k} {w:.3g}" for k, w in worst_d.items()), flush=True)

    prm = pe_params(randn, 6, 128, 512, 512)
    x = randn(2, 1024 * 256, 6).to(torch.bfloat16)
    dout = randn(2, 1024, 512).to(torch.bfloat16)
    kw = dict(num_groups=1024, group_size=256, cdt=torch.bfloat16)
    _, saved = PE.patch_encoder_cuda(x, prm, return_argmax=True, **kw)
    runs = [PE.patch_encoder_bwd_cuda(x, prm, dout, saved=saved, need_dx=False, **kw)[1]
            for _ in range(2)]
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(*runs)),
          "K7 [2, 1024*256, 6] -> 512 bf16: two calls differ")
    print("K7 [2, 1024*256, 6] h(128, 512) -> 512 bf16 (mma route): 12 grads bit-equal over two "
          "calls", flush=True)


def check_kernels(torch, np, mods, shapes_by_kernel: dict, path: str) -> list:
    """Each kernel a path launched, against its plain version at every
    shape and dtype the path gave it: one row per launch key, with the
    path's launches at that key, the error, the kernel's, plain and library
    times (CUDA events, median) and the bound. K2 with its argmax outputs
    is also timed without them (``ms_without_argmax``)."""
    g = torch.Generator(device="cuda").manual_seed(1)
    rows = []
    for name, shapes in shapes_by_kernel.items():
        keys = [dict(k) for k in shapes]
        varying = [f for f in keys[0] if len({str(k[f]) for k in keys}) > 1] if keys else []
        for key_t, key in zip(shapes, keys):
            case = kernel_case(torch, np, mods, name, key, g)
            err = case["compare"](case["run"](), case["plain"]())
            torch.cuda.empty_cache()
            row = dict(kernel=name, path=path, shape=key, launches=shapes[key_t],
                       variant=",".join(f"{f}={key[f]}" for f in varying), max_abs_err=err,
                       ms=time_ms(torch, case["run"]),
                       plain_ms=time_ms(torch, case["plain"], reps=3),
                       library_ms=time_ms(torch, case["library"]) if "library" in case else None)
            if "without" in case:
                row["ms_without_argmax"] = time_ms(torch, case["without"])
            if "passes" in case:  # K7's mma route: C, then D and the reduction by difference
                c_ms, cd_ms = (time_ms(torch, fn) for fn in case["passes"])
                row.update(ms_pass_c=c_ms, ms_pass_d=cd_ms - c_ms, ms_reduce=row["ms"] - cd_ms)
                row["bound_ms_pass_d"] = bound(*case["pass_d_work"])[0]
            row["bound_ms"], row["bound_by"] = bound(*case["work"])
            del case
            torch.cuda.empty_cache()
            lib = "" if row["library_ms"] is None else f"  library {row['library_ms']:.4f} ms"
            if "ms_without_argmax" in row:
                lib += f"  without the argmax outputs {row['ms_without_argmax']:.4f} ms"
            if "ms_pass_c" in row:
                lib += (f"  pass C {row['ms_pass_c']:.4f} ms, pass D {row['ms_pass_d']:.4f} ms "
                        f"(its bound {row['bound_ms_pass_d']:.4f} ms), "
                        f"reduction and set-up {row['ms_reduce']:.4f} ms")
            print(f"kernel {name} {path} {key}: {row['launches']} launches, max_abs_err "
                  f"{err:.6g}  kernel {row['ms']:.4f} ms  plain {row['plain_ms']:.4f} ms{lib}  "
                  f"bound {row['bound_ms']:.4f} ms ({row['bound_by']})", flush=True)
            rows.append(row)
    return rows


def attention_edges(torch, A) -> None:
    """Phase 5b: K3 (``mha_cuda``) and K5 (``mha_heads_cuda``) at their
    edges against ``mha_plain`` / ``mha_heads_plain`` on seeded inputs, in
    fp32 (within 1e-5 of the largest plain output) and bf16 (2e-2): ragged
    S = 77, 200, 2049 at every padded head size (dh = 32, 64, 88, 128);
    grids wider than one wave of 132 SMs (B * H > 132); and large logits at
    the serve and voronoi shapes (q * 20, keys growing along S, so that the
    running max moves in late key tiles and the rescaling by alpha runs)."""
    g = torch.Generator(device="cuda").manual_seed(3)
    # (kernel, B, H, S, dh, q scale)
    cases = [(name, 1, 2, S, dh, 1.0) for name in ("K3", "K5") for S in (77, 200, 2049)
             for dh in (32, 64, 88, 128)]
    cases += [("K3", 3, 48, 200, 32, 1.0), ("K5", 2, 80, 130, 64, 1.0),
              ("K3", 1, 16, 2048, 64, 20.0), ("K5", 1, 16, 2048, 88, 20.0)]
    worst = {}
    for name, B, H, S, dh, qs in cases:
        ramp = torch.linspace(0.5, 1.5, S, device="cuda")[:, None] if qs != 1.0 else 1.0
        q, k, v = (torch.randn((B, H, S, dh), device="cuda", generator=g) * f
                   for f in (qs, ramp, 1.0))
        for dt, rel in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
            x = [t.to(dt) for t in (q, k, v)]
            label = f"edge {name} [B={B}, H={H}, S={S}, dh={dh}] q*{qs:g} {dt}"
            if name == "K3":
                x = [t.transpose(1, 2).reshape(B, S, H * dh) for t in x]
                got, want = A.mha_cuda(*x, H), A.mha_plain(*x, H)
            else:
                got, want = A.mha_heads_cuda(*x), A.mha_heads_plain(*x)
            check(got.dtype == dt and got.shape == x[0].shape, f"{label}: {got.dtype} {got.shape}")
            err = within(label, rel)(got, want)
            scale = want.float().abs().max().item()
            key = (name, str(dt))
            worst[key] = max(worst.get(key, 0.0), err / (rel * scale))
    torch.cuda.synchronize()
    print(f"attention edges: {len(cases)} shapes x 2 dtypes of K3 / K5 against plain, worst "
          f"error as a share of its tolerance: "
          + ", ".join(f"{n} {dt.rsplit('.', 1)[-1]} {w:.3g}" for (n, dt), w in worst.items()),
          flush=True)


def patch_encoder_edges(torch, PE) -> None:
    """Phase 5c: K2 (``patch_encoder_cuda``) at the bf16 tensor-core
    kernel's edges against ``patch_encoder_plain`` on seeded inputs, in fp32
    (within 1e-4 of the largest plain output) and bf16 (2e-2), both
    activations: the hier level-1 and level-2 widths at K = 32 (C_in = 131),
    K = 256 at both output widths, K = 77 (a ragged last row chunk), a grid of
    320 blocks (above one wave), duplicated input rows (exact ties in both
    max-pools). Then two calls at the serve shape must return the same bits.
    The worst error is printed as a share of its tolerance."""
    g = torch.Generator(device="cuda").manual_seed(5)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, device="cuda", generator=g) * scale

    # (B, G, K, C_in, h0, h1, C_out, ties)
    cases = [(2, 16, 32, 6, 64, 128, 128, False), (2, 8, 32, 131, 128, 256, 512, False),
             (2, 8, 32, 131, 128, 256, 256, False), (2, 4, 256, 6, 128, 512, 512, False),
             (2, 4, 256, 4, 128, 512, 256, False), (2, 6, 77, 4, 128, 512, 256, False),
             (2, 160, 32, 4, 64, 128, 128, False), (2, 8, 32, 6, 128, 512, 512, True)]
    worst = {}
    for B, G, K, cin, h0, h1, cout, ties in cases:
        prm = pe_params(randn, cin, h0, h1, cout)
        x = randn(B, G, K, cin)
        if ties:
            x[:, :, 1] = x[:, :, 0]
            x[:, :, 5] = x[:, :, 3]
        x = x.reshape(B, G * K, cin)
        for dt, rel in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
            for act in ("erf", "tanh"):
                kw = dict(num_groups=G, group_size=K, cdt=dt, act=act)
                label = (f"edge K2 [B={B}, G={G}, K={K}, C_in={cin}] h({h0}, {h1}) -> {cout}"
                         f"{' ties' if ties else ''} {act} {dt}")
                got, want = PE.patch_encoder_cuda(x, prm, **kw), PE.patch_encoder_plain(x, prm, **kw)
                check(got.dtype == dt and got.shape == (B, G, cout), f"{label}: {got.dtype} {got.shape}")
                err = within(label, rel)(got, want)
                key = str(dt).rsplit(".", 1)[-1]
                worst[key] = max(worst.get(key, 0.0), err / (rel * want.float().abs().max().item()))
    torch.cuda.synchronize()
    print(f"K2 edges: {len(cases)} shapes x 2 dtypes x 2 activations against plain, worst error "
          f"as a share of its tolerance: " + ", ".join(f"{k} {w:.3g}" for k, w in worst.items()),
          flush=True)

    prm = pe_params(randn, 6, 128, 512, 512)
    x = randn(1, 2048 * 256, 6)
    for dt in (torch.float32, torch.bfloat16):
        kw = dict(num_groups=2048, group_size=256, cdt=dt)
        check(torch.equal(PE.patch_encoder_cuda(x, prm, **kw), PE.patch_encoder_cuda(x, prm, **kw)),
              f"K2 [1, 2048*256, 6] -> 512 {dt}: two calls differ")
    print("K2 [1, 2048*256, 6] h(128, 512) -> 512: fp32 and bf16 repeats bit-equal", flush=True)


def attention_bwd_edges(torch, A) -> None:
    """Phase 15b: K6 (``mha_packed_bwd_cuda``) at its edges against
    ``mha_packed_bwd_plain`` on seeded inputs, each grad in fp32 (within 1e-5
    of its largest plain entry) and bf16 (2e-2): ragged S = 77, 200, 2049 at
    every padded head size (dh = 32, 64, 88, 128); dh = 36, not a multiple
    of 8, so the bf16 kernels load and store element by element; a grid wider than one wave (B * H > 132); large logits at the train shape (q * 20, keys growing
    along S, so that the running max moves in late key tiles). Then, at the
    train shape, two calls must return the same bits, and the bf16 kernel's
    and plain version's errors against the fp32 plain version on the same
    bf16 inputs are printed as shares of the bf16 tolerance (not gated)."""
    g = torch.Generator(device="cuda").manual_seed(6)

    def inputs(B, H, S, dh, qs):
        ramp = torch.linspace(0.5, 1.5, S, device="cuda")[:, None] if qs != 1.0 else 1.0
        return [torch.randn((B, S, H * dh), device="cuda", generator=g) * f
                for f in (qs, ramp, 1.0, 1.0)]

    # (B, heads, S, dh, q scale)
    cases = [(1, 2, S, dh, 1.0) for S in (77, 200, 2049) for dh in (32, 64, 88, 128)]
    cases += [(1, 2, 200, 36, 1.0), (3, 48, 200, 32, 1.0), (2, 16, 1024, 64, 20.0)]
    worst = {}
    for B, H, S, dh, qs in cases:
        x32 = inputs(B, H, S, dh, qs)
        for dt, rel in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
            x = [t.to(dt) for t in x32]
            label = f"edge K6 [B={B}, H={H}, S={S}, dh={dh}] q*{qs:g} {dt}"
            got, want = A.mha_packed_bwd_cuda(*x, H), A.mha_packed_bwd_plain(*x, H)
            for f, a, w in zip("qkv", got, want):
                check(a.dtype == dt and a.shape == x[0].shape, f"{label} d{f}: {a.dtype} {a.shape}")
                err = within(f"{label} d{f}", rel)(a, w)
                key = str(dt).rsplit(".", 1)[-1]
                worst[key] = max(worst.get(key, 0.0), err / (rel * w.float().abs().max().item()))
    torch.cuda.synchronize()
    print(f"K6 edges: {len(cases)} shapes x 2 dtypes against plain, worst error as a share of "
          f"its tolerance: " + ", ".join(f"{k} {w:.3g}" for k, w in worst.items()), flush=True)

    for qs in (1.0, 20.0):
        x32 = inputs(2, 16, 1024, 64, qs)
        for dt in (torch.float32, torch.bfloat16):
            x = [t.to(dt) for t in x32]
            first, second = A.mha_packed_bwd_cuda(*x, 16), A.mha_packed_bwd_cuda(*x, 16)
            check(all(torch.equal(a, b) for a, b in zip(first, second)),
                  f"K6 [2, 1024, 1024] q*{qs:g} {dt}: two calls differ")
        # The fp32 reference: the plain arithmetic on the bf16 values, not
        # rounded at the end.
        ref = A.mha_packed_bwd_plain(*(t.float() for t in x), 16)
        shares = {}
        for name, got in (("kernel", first), ("plain", A.mha_packed_bwd_plain(*x, 16))):
            shares[name] = [((a.float() - r).abs().max() / (2e-2 * r.abs().max())).item()
                            for a, r in zip(got, ref)]
        print(f"K6 [2, 1024, 1024] 16 heads q*{qs:g}: fp32 and bf16 repeats bit-equal; bf16 "
              f"error against the fp32 reference as a share of the 2e-2 tolerance (dq, dk, dv): "
              + "; ".join(f"{n} " + ", ".join(f"{v:.4g}" for v in s) for n, s in shares.items()),
              flush=True)


def resource_usage(lib) -> None:
    """Registers, stack and local bytes (spills) of each attention kernel and
    each K2 and K7 kernel in the built library, from ``cuobjdump
    --dump-resource-usage``. Reported only: a missing tool or an unknown
    format prints a note and gates nothing."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    try:
        out = subprocess.run([tool, "--dump-resource-usage", str(lib)], capture_output=True,
                             text=True, timeout=120).stdout
    except (OSError, subprocess.SubprocessError) as e:
        print(f"resources (cuobjdump): not read ({e})", flush=True)
        return
    found = re.findall(r"Function (\S+?):\s*REG:(\d+) STACK:(\d+) SHARED:\d+ LOCAL:(\d+)", out)
    rows = []
    for mangled, reg, stack, local in found:
        m = re.search(r"\d+((?:attn_bwd|mha_kernel)\w*?)I(f|13__nv_bfloat16)?Li(\d+)E", mangled)
        k2 = re.search(r"\d+(patch_encoder(?:_mma|_bwd(?:_c_mma|_d_mma)?)?_kernel)"
                       r"(?:I(f|13__nv_bfloat16|Li\d+E)E)?", mangled)
        if m:
            dtype = {"f": "float, ", "13__nv_bfloat16": "bf16, "}.get(m[2] or "", "")
            rows.append(f"{m[1]}<{dtype}{m[3]}> {reg} reg, stack {stack} B, local {local} B")
        elif k2:
            tiles = re.fullmatch(r"Li(\d+)E", k2[2] or "")
            dtype = (f"<{tiles[1]}>" if tiles else
                     {"f": "<float>", "13__nv_bfloat16": "<bf16>"}.get(k2[2] or "", ""))
            rows.append(f"{k2[1]}{dtype} {reg} reg, stack {stack} B, local {local} B")
    print("resources (cuobjdump): "
          + ("; ".join(sorted(rows)) or "no attention, K2 or K7 kernel listed"), flush=True)


def clicks(pred, xyz):
    """3 clicks: one positive point without a mask prompt, then adding a
    negative and a positive point with the previous best logits as mask."""
    out = [pred.predict_masks(xyz[10:11], [1])]
    prev = out[-1][2][0, int(out[-1][1][0].argmax())]
    for pts, labels in ((xyz[[10, 700]], [1, 0]), (xyz[[10, 700, 500]], [1, 0, 1])):
        out.append(pred.predict_masks(pts, labels, prev, False))
        prev = out[-1][2][0, 0]
    return out


# The tiny kNN model of phases 3 and 9: D=128 in 2 heads of 64, the head
# size the packed kernels K3 / K6 take (the "tiny" preset's 4 heads of 32
# go head-split, to K5).
TINY_VIT = dict(embed_dim=128, depth=2, num_heads=2, mlp_hidden_dim=256)


def end_to_end_tiny(torch, np, cpu_model, label, counters, expect, device="cuda", **group):
    """Phases 3, 6 and 9: a tiny model in fp32 on the CPU (plain versions)
    and on the card (kernels), same weights, cloud, grouping (``group``:
    set_pointcloud's override) and 3 clicks; every kernel named in
    ``expect`` must launch in the card's run."""
    from point_sam_tpu_torch.serving import Predictor

    gpu_model = copy.deepcopy(cpu_model).to(device)
    rng = np.random.default_rng(0)
    xyz = rng.standard_normal((1200, 3)).astype(np.float32)
    xyz /= np.abs(xyz).max() + 1e-3
    rgb = rng.random((1200, 3)).astype(np.float32)
    results = []
    for model, dev in ((cpu_model, "cpu"), (gpu_model, device)):
        pred = Predictor(model, device=dev, point_buckets=(2048,))
        reset(counters)
        pred.set_pointcloud(xyz, rgb, **group)
        results.append(clicks(pred, xyz))
    torch.cuda.synchronize()
    missing = [name for name in expect if counters[name].launches == 0]
    check(not missing, f"{label}: kernels {missing} did not launch on the card")
    worst = 0.0
    for (wm, ws, wl), (gm, gs, gl) in zip(*results):
        check(gl.shape == wl.shape and np.isfinite(gl).all(), f"{label}: bad logits")
        dl = float(np.abs(gl - wl).max())
        worst = max(worst, dl)
        check(dl <= 1e-3, f"{label}: logits differ by {dl:.3g} > 1e-3")
        check(float(np.abs(gs - ws).max()) <= 1e-4, f"{label}: scores differ > 1e-4")
        sure = np.abs(wl) >= 1e-3
        check(np.array_equal(gm[sure], wm[sure]), f"{label}: masks differ")
    print(f"{label} fp32 (group {pred._state['group']}): card kernels {list(expect)} vs CPU "
          f"plain, 3 clicks, max |dlogit| {worst:.3g}", flush=True)


def serve(torch, np, pred, counters, label, minimum, *, group=(2048, 256), tokens=2048,
          absent=(), **override):
    """Phases 4, 7, 10 and 12: a bf16 Predictor over the seeded 100k-point
    cloud (bucket 131072; G=2048 by the eval rule, or the hier model's
    grouping), set_pointcloud (with ``override``) and 3 clicks counted (each
    kernel of ``minimum`` at least that many launches, each of ``absent``
    none), then the encode and the two kinds of click timed. Returns each
    kernel's launches by shape in the counted run. The caller holds the
    Predictor, so that no model outlives its phase (peak memory counts every
    live tensor)."""
    xyz, rgb = synthetic_cloud(np.random.default_rng(0), N_FLAGSHIP)

    pred.set_pointcloud(xyz, rgb, **override)  # warm-up: cuBLAS handles, allocator
    clicks(pred, xyz)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    reset(counters)
    pred.set_pointcloud(xyz, rgb, **override)
    out = clicks(pred, xyz)
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in counters.items()}
    shapes = {name: dict(fn.shapes) for name, fn in counters.items() if fn.shapes}
    peak = torch.cuda.max_memory_allocated()

    check(pred._state["group"] == group, f"{label}: grouping {pred._state['group']}")
    check(pred._state["n_pad"] == 131072, f"{label}: bucket is not 131072")
    check(pred._state["emb"].shape == (1, tokens, 256), f"{label}: {pred._state['emb'].shape}")
    check(bool(torch.isfinite(pred._state["emb"]).all()), f"{label}: non-finite encoding")
    for i, (m, s, lg) in enumerate(out):
        c = 3 if i == 0 else 1
        check(m.shape == (1, c, N_FLAGSHIP) and lg.shape == (1, c, N_FLAGSHIP),
              f"{label} click {i}: shape {lg.shape}")
        check(s.shape == (1, c) and np.isfinite(s).all(), f"{label} click {i}: bad scores")
        check(np.isfinite(lg).all(), f"{label} click {i}: non-finite logits")
    for name, lo in minimum.items():
        check(launches[name] >= lo, f"{label}: {name} launched {launches[name]} < {lo} times")
    for name in absent:
        check(launches[name] == 0, f"{label}: {name} launched {launches[name]} times")

    enc_ms = time_ms(torch, lambda: pred.set_pointcloud(xyz, rgb, **override))
    first = lambda: pred.predict_masks(xyz[10:11], [1])  # noqa: E731
    prev = out[0][2][0, 0]
    masked = lambda: pred.predict_masks(xyz[[10, 700]], [1, 0], prev, False)  # noqa: E731
    dec_ms = time_ms(torch, first)
    dec_mask_ms = time_ms(torch, masked)
    print(f"{label} bf16, N={N_FLAGSHIP} (bucket 131072), group {pred._state['group']}: "
          f"encode {enc_ms:.3f} ms, decode {dec_ms:.3f} ms/click (no mask prompt), "
          f"{dec_mask_ms:.3f} ms/click (mask prompt), peak memory "
          f"{peak / 2**30:.3f} GiB, launches {launches}", flush=True)
    return shapes


def tail_routes(torch, UP, pred, counters) -> None:
    """Phase 11: the decoder tail at the hier override's shape (G1=4096, so
    JAX's K4 gate fails), by both routes on the same inputs: the cloud's
    level-1 geometry from ``pred``, seeded tokens [1, 4096, 128] and tail
    parameters in bf16. K4 on the tokens, against ``decoder_tail`` (the
    gather, then K11) and the gather alone; CUDA events, median."""
    from point_sam_tpu_torch.ops.interp import interpolate_features_repeated

    geom = pred._state["geom"]
    idx, w = geom["interp_index"], geom["interp_weight"]
    g = torch.Generator(device="cuda").manual_seed(2)
    D, cdt = 128, torch.bfloat16

    def randn(*shape, scale=1.0):
        return torch.randn(shape, device="cuda", generator=g) * scale

    h1 = randn(1, 4096, D).to(cdt)
    params = (1.0 + randn(D, scale=0.1), randn(D, scale=0.1), randn(D, D, scale=D ** -0.5),
              randn(D, scale=0.1))
    check(not UP.interp_upscale_dispatch_ok(idx.shape[1], 4096, D, 3, cdt),
          "decoder tail at G1=4096: the K4 gate holds")
    for C in (3, 1):
        hyper = randn(1, C, D).to(cdt)
        k4 = lambda: UP.interp_upscale_cuda(h1, idx, w, params, hyper, cdt=cdt)  # noqa: E731
        route = lambda: UP.decoder_tail(h1, idx, w, params, hyper, cdt=cdt)  # noqa: E731
        before = counters["K11"].launches
        with torch.inference_mode():
            err = within("decoder tail K4 vs gather + K11", 2e-2)(route(), k4())
        check(counters["K11"].launches == before + 1, "decoder_tail at G1=4096 took no K11")
        with torch.inference_mode():
            k4_ms, route_ms = time_ms(torch, k4), time_ms(torch, route)
            gather_ms = time_ms(torch, lambda: interpolate_features_repeated(h1, idx, w))
        print(f"decoder tail hier4096 [BM=1, N={idx.shape[1]}, G1=4096, D={D}], C={C}: "
              f"K4 {k4_ms:.4f} ms, gather + K11 {route_ms:.4f} ms (gather alone "
              f"{gather_ms:.4f} ms), max_abs_err {err:.6g}", flush=True)


def profile_encode(torch, np, model, label, **override):
    """Phase 16: one encode of a serving path (with ``override`` of its
    grouping) under torch.profiler, on a model built anew (the timed phases
    keep none alive)."""
    from point_sam_tpu_torch.serving import Predictor

    pred = Predictor(model)
    xyz, rgb = synthetic_cloud(np.random.default_rng(0), N_FLAGSHIP)
    pred.set_pointcloud(xyz, rgb, **override)  # warm-up
    profile(torch, f"{label} encode", lambda: pred.set_pointcloud(xyz, rgb, **override),
            ENCODE_STAGES)
    del pred
    torch.cuda.empty_cache()


def train_step_tiny(torch, np, P, PS, criterion, counters):
    """Phase 13: one tiny fp32 train step, the CPU's plain versions against
    the card's kernels (K1-K3, K6, K7 and K11 must each launch), same weights,
    batch and clicks. Tolerances: loss 1e-4 relative; each grad 1e-4 of its
    largest entry + 1e-6, the two PointNets' 5e-3 (the card sums in another
    order, and a max-pool near-tie within that fp32 noise moves a column's
    grad to another row). Then the card's step runs again on a fresh copy
    of the model: every grad must be bit-equal. Last, what broke that before
    is printed (not gated): how many grads differ between two such steps with
    the gathers' backward as autograd's own (``index_select``'s:
    ``index_add_``, atomic adds on the card), plainly and under
    ``torch.use_deterministic_algorithms(True)`` (or the op that raises)."""
    import importlib
    import os

    cfg = P.PointSAMConfig(vit=P.ViTConfig(**TINY_VIT), tokenizer=P.TokenizerConfig(32, 16),
                           prompt_iters=3, enable_mask_refinement_iterations=False)
    cpu_model = P.PointCloudSAM(cfg, generator=torch.Generator().manual_seed(0))
    rng = np.random.default_rng(4)
    B, N, M = 2, 600, 2
    coords = rng.standard_normal((B, N, 3)).astype(np.float32)
    coords /= np.abs(coords).max() + 1e-3
    gt = np.zeros((B, M, N), bool)
    for b in range(B):
        for m in range(M):
            d = ((coords[b] - coords[b, rng.integers(N)]) ** 2).sum(-1)
            gt[b, m] = d < np.quantile(d, 0.3)
    batch = dict(coords=coords, features=rng.random((B, N, 3)).astype(np.float32), gt_masks=gt)

    def step(dev):
        """The step on a fresh copy of the model: (outputs, loss, grads)."""
        model = copy.deepcopy(cpu_model).to(dev)
        tb = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
        with torch.no_grad():
            outs = model(tb["coords"], tb["features"], tb["gt_masks"])
        opt = PS.make_optimizer(model.parameters(), lambda step: 0.0, weight_decay=0.0,
                                max_grad_value=float("inf"))
        metrics = PS.train_step(model, opt, tb, torch.Generator().manual_seed(0),
                                criterion=criterion)
        grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()
                 if p.grad is not None}
        return outs, float(metrics["loss"]), grads

    def differ(a, b):
        return [n for n in a if not torch.equal(a[n], b[n])]

    results = []
    for dev in ("cpu", "cuda"):
        reset(counters)
        results.append(step(dev))
    torch.cuda.synchronize()
    missing = [k for k in ("K1", "K2", "K3", "K6", "K7", "K11") if counters[k].launches == 0]
    check(not missing, f"tiny train step: kernels {missing} did not launch on the card")
    (co, cl, cg), (go, gl, gg) = results
    for c_, g_ in zip(co, go):
        check(torch.equal(c_["prompt_coords"], g_["prompt_coords"].cpu()),
              "tiny train step: the clicks differ")
    check(abs(gl - cl) <= 1e-4 * abs(cl), f"tiny train step: loss {gl} vs {cl}")
    check(set(cg) == set(gg), "tiny train step: grads of different parameters")
    worst = 0.0
    for n in cg:
        rel = 5e-3 if ".patch_encoder." in n else 1e-4
        err = (gg[n].cpu() - cg[n]).abs().max().item()
        scale = cg[n].abs().max().item()
        check(err <= rel * scale + 1e-6, f"tiny train step: grad {n} err {err:.3g} of {scale:.3g}")
        worst = max(worst, err / (rel * scale + 1e-6))
    print(f"train step tiny fp32: card kernels vs CPU plain, loss {gl:.6f} vs {cl:.6f}, "
          f"{len(cg)} grads, worst error {worst:.3g} of its tolerance", flush=True)

    again = differ(gg, step("cuda")[2])
    check(not again, f"tiny train step: two runs on the card differ in {len(again)} grads, the "
          f"first {again[0] if again else ''}")
    group = importlib.import_module("point_sam_tpu_torch.ops.group")
    port = group._SelectRows.apply
    group._SelectRows.apply = lambda flat, idx: flat.index_select(0, idx)
    config = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    try:
        found = [differ(*(step("cuda")[2] for _ in range(2)))]
        os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
        torch.use_deterministic_algorithms(True)
        try:
            found.append(differ(*(step("cuda")[2] for _ in range(2))))
        except RuntimeError as e:
            found.append(f"raised: {str(e).splitlines()[0][:200]}")
    finally:
        torch.use_deterministic_algorithms(False)
        if config is None:
            os.environ.pop("CUBLAS_WORKSPACE_CONFIG", None)
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = config
        group._SelectRows.apply = port
    plain, strict = (f if isinstance(f, str) else f"{len(f)} grads differ"
                     + (f", the first {f[0]}" if f else "") for f in found)
    print(f"train step tiny fp32 repeats: {len(gg)} grads bit-equal over two runs on the card; "
          f"with the gathers' backward as autograd's own (index_add_): {plain}; the same under "
          f"torch.use_deterministic_algorithms(True): {strict}", flush=True)


# Parameters whose gradient may be zero on a step for reasons of the data:
# the multimask hypernetworks the min-loss rule did not pick, and the
# negative-click embedding when no negative click was sampled.
MAY_BE_ZERO = ("mask_decoder.output_hypernetworks_mlps.1.", "mask_decoder.output_hypernetworks_mlps.2.",
               "mask_decoder.output_hypernetworks_mlps.3.", "point_encoder.point_embeddings.0.")


MATMULS = ("matmuls (cuBLAS)", ("gemm", "sm90_", "cutlass", "xmma", "nvjet"))
# Kernel name fragments -> stage, for the profiles (first match wins).
K6_STAGES = (("K6 attention bwd, query pass", ("attn_bwd_query",)),
             ("K6 attention bwd, key pass", ("attn_bwd_key",)))
# K7 by kernel: pass C on the bf16 mma route, pass D apart, the slices'
# reduction, and the one-launch kernel of the other shapes.
TRAIN_STAGES = (("K7 pass C (mma)", ("patch_encoder_bwd_c_mma",)),
                ("K7 pass D (mma)", ("patch_encoder_bwd_d_mma",)),
                ("K7 reduce_slices", ("reduce_slices",)),
                ("K7 one launch", ("patch_encoder_bwd_kernel",)),
                ("K2 patch encoder", ("patch_encoder",)), *K6_STAGES,
                ("K3 attention", ("mha_kernel",)), ("K4 / K11 decode tail", ("interp_upscale",)),
                ("K1 FPS + 3-NN", ("fps_interp",)), MATMULS)
# fps_interp_kernel<0> is K8, <1> K1, <2> K9 (the template mode of
# csrc/fps_interp.cu).
ENCODE_STAGES = (("K1 FPS + 3-NN", ("fps_interp_kernel<1>",)),
                 ("K8 FPS", ("fps_interp_kernel<0>",)),
                 ("K9 FPS + 3-NN + kNN bins", ("fps_interp_kernel<2>",)),
                 ("K10 3-NN weights", ("interp_kernel",)), ("K2 patch encoder", ("patch_encoder",)),
                 ("K3 / K5 attention", ("mha_kernel",)),
                 ("torch top-k / sort (exact kNN, K9's bins)", ("topk", "TopK", "sort", "Sort")),
                 ("torch scatter / gather (scatter max, gathers)", ("scatter",)), MATMULS)


def profile(torch, label, fn, stages):
    """``fn`` once under torch.profiler: device time by stage (kernel
    names), the largest other kernels, and the device's busy share of the
    wall time."""
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    by_stage = {name: 0.0 for name, _ in stages}
    by_stage["other kernels"] = 0.0
    others = []
    total = 0.0
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total", 0) or 0
        if getattr(ev, "device_type", None) != torch.autograd.DeviceType.CUDA or dev_us <= 0:
            continue
        total += dev_us / 1e3
        stage = next((n for n, keys in stages if any(k in ev.key for k in keys)), "other kernels")
        by_stage[stage] += dev_us / 1e3
        if stage == "other kernels":
            others.append((dev_us / 1e3, ev.count, ev.key[:60]))
    split = ", ".join(f"{k} {v:.3f}" for k, v in by_stage.items())
    top = "; ".join(f"{ms:.3f} ms x{n} {name}" for ms, n, name in sorted(others, reverse=True)[:6])
    print(f"{label} profile (ms of device time): {split}; total {total:.3f} ms over "
          f"{wall:.3f} ms wall under the profiler (device busy {100 * total / wall:.1f}%); "
          f"largest other kernels: {top}", flush=True)


def profile_attention_bwd(torch, A, calls=20):
    """K6 against SDPA's backward (the library's fused kernels) by device
    time: ``calls`` calls of each at the ViT-L train shape [2, 1024, 1024],
    16 heads of 64, bf16, each under its own profiler session."""
    g = torch.Generator(device="cuda").manual_seed(7)
    q, k, v, do = (torch.randn((2, 1024, 1024), device="cuda", generator=g).to(torch.bfloat16)
                   for _ in range(4))
    heads = [t.view(2, 1024, 16, 64).transpose(1, 2).contiguous() for t in (q, k, v, do)]
    sq, sk, sv = (t.requires_grad_() for t in heads[:3])
    with torch.enable_grad():
        sout = torch.nn.functional.scaled_dot_product_attention(sq, sk, sv)
    runs = {"K6": lambda: A.mha_packed_bwd_cuda(q, k, v, do, 16),
            "SDPA backward": lambda: torch.autograd.grad(sout, (sq, sk, sv), heads[3],
                                                         retain_graph=True)}
    for name, fn in runs.items():
        fn()  # warm
        profile(torch, f"{name} x{calls} [2, 1024, 1024] 16 heads bf16",
                lambda f=fn: [f() for _ in range(calls)], K6_STAGES)


def profile_step(torch, result, cfg, seed):
    """One more ViT-L train step under torch.profiler (``profile``), with
    the step on that batch timed (host clock to the loss's sync, median of
    4) before and after the profiler session."""
    from point_sam_tpu_torch.datasets.build import BatchIterator, build_dataset
    from point_sam_tpu_torch.parallel.train_step import train_step
    from point_sam_tpu_torch.train.trainer import to_device

    ds = build_dataset(cfg.train_dataset, seed=seed, context={"num_samples": cfg.num_samples})
    batch = to_device(next(iter(BatchIterator(ds, 2, seed=seed))), "cuda")
    gen = torch.Generator().manual_seed(0)

    def step():
        return float(train_step(result["model"], result["optimizer"], batch, gen)["loss"])

    def step_ms():
        times = []
        for _ in range(4):
            t0 = time.perf_counter()
            step()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    step()  # warm
    before = step_ms()
    profile(torch, "train step", step, TRAIN_STAGES)
    print(f"train step on one batch: {before:.3f} ms before the profiler session, "
          f"{step_ms():.3f} ms after it (median of 4)", flush=True)


def train_vit_l(torch, trainer, build_model, load_config, counters, steps=5):
    """Phase 14: the training path, the ViT-L recipe through trainer.main on
    synthetic data. Returns each kernel's launches by shape over the run,
    and the step to profile."""
    run_dir = ROOT / "build" / "chip_smoke_train"
    shutil.rmtree(run_dir, ignore_errors=True)
    overrides = ["train_dataset.dataset.source=synthetic", "val_freq=0", f"max_steps={steps}",
                 "train_dataset.dataset.num_scenes=16", f"project_dir={run_dir}", "log_freq=1"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset(counters)
    result = trainer.main(["--config", "large", *overrides])
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in counters.items()}
    shapes = {name: dict(fn.shapes) for name, fn in counters.items() if fn.shapes}
    peak = torch.cuda.max_memory_allocated()
    shutil.rmtree(run_dir, ignore_errors=True)

    hist = result["history"]
    check(result["step"] == steps and len(hist) == steps, f"trained {result['step']} steps")
    check(all(math.isfinite(h["loss"]) for h in hist), f"non-finite loss: {hist}")
    bad = [n for n in result["first_step_zero_grads"] if not n.startswith(MAY_BE_ZERO)]
    check(not bad, f"zero gradient on the first step: {bad}")
    model = result["model"]
    cfg = load_config("large", overrides)
    seed = cfg.get("seed", 42)
    init = build_model(cfg.model, device="cuda",
                       generator=torch.Generator("cuda").manual_seed(seed)).state_dict()
    frozen = [n for n, p in model.named_parameters() if torch.equal(p.detach(), init[n])]
    check(not frozen, f"parameters did not move: {frozen[:5]}")
    per_step = {k: v / steps for k, v in launches.items()}
    minimum = {"K1": 1, "K2": 5, "K3": 24, "K4": 5, "K6": 24, "K7": 5}
    for name, lo in minimum.items():
        check(per_step[name] >= lo, f"training: {name} launched {per_step[name]} < {lo} per step")
    step_ms = statistics.median(h["ms"] for h in hist[1:])
    print(f"train ViT-L (configs/large.yaml, synthetic): B=2, N=10000, M=2, G=1024, K=256, "
          f"5 click iterations, bf16 compute: {steps} steps, losses "
          f"{[round(h['loss'], 4) for h in hist]}, step {step_ms:.3f} ms (median of steps "
          f"2-{steps}; first {hist[0]['ms']:.1f} ms), peak memory {peak / 2**30:.3f} GiB, "
          f"launches per step {per_step}", flush=True)
    return shapes, lambda: profile_step(torch, result, cfg, seed)


def main() -> int:
    import importlib

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "point_sam_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: point_sam_tpu_torch is not beside this script", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))

    smi = nvidia_smi()
    print(f"header: {smi} | torch {torch.__version__} | CUDA {torch.version.cuda} | "
          f"nvcc {nvcc_version()}", flush=True)

    from point_sam_tpu_torch import models as P
    from point_sam_tpu_torch import parallel as PS
    from point_sam_tpu_torch.models.loss import criterion
    from point_sam_tpu_torch.ops import _cuda
    from point_sam_tpu_torch.serving import Predictor
    from point_sam_tpu_torch.train import trainer
    from point_sam_tpu_torch.utils.config import build_model, load_config

    t0 = time.perf_counter()
    _cuda.library()
    print(f"build: {time.perf_counter() - t0:.1f} s to a loaded library (nvcc + load)",
          flush=True)
    resource_usage(_cuda.build())

    mods = [importlib.import_module(f"point_sam_tpu_torch.ops.{m}")
            for m in ("fps", "patch_encoder_pallas", "attention", "upscale_pallas",
                      "interp_pallas", "knn")]
    F, PE, A, UP, IW, K = mods
    counters = {"K1": F.fps_interp_cuda, "K2": PE.patch_encoder_cuda, "K3": A.mha_cuda,
                "K4": UP.interp_upscale_cuda, "K5": A.mha_heads_cuda,
                "K6": A.mha_packed_bwd_cuda, "K7": PE.patch_encoder_bwd_cuda,
                "K8": F.fps_cuda, "K9": F.fps_interp_knn_cuda, "K10": IW.interp_weights_cuda,
                "K11": UP.upscale_hyper_cuda}
    dev = torch.device("cuda")

    tiny = P.PointCloudSAM(P.PointSAMConfig(vit=P.ViTConfig(**TINY_VIT),
                                            tokenizer=P.TokenizerConfig(128, 16)),
                           generator=torch.Generator().manual_seed(0)).eval()
    end_to_end_tiny(torch, np, tiny, "e2e tiny", counters, ("K1", "K2", "K3", "K4"))

    def vit_l(knn_method="auto"):
        tok = P.TokenizerConfig(knn_method=knn_method)
        return P.PointCloudSAM(P.PointSAMConfig(vit="eva02_large", tokenizer=tok),
                               dtype=torch.bfloat16, device=dev,
                               generator=torch.Generator(device=dev).manual_seed(0))

    def giant():
        return build_model(load_config("voronoi_giant").model, device="cuda",
                           generator=torch.Generator(device=dev).manual_seed(0))

    def hier():
        return build_model(load_config("model/hier"), device="cuda",
                           generator=torch.Generator(device=dev).manual_seed(0))

    serve_shapes = serve(torch, np, Predictor(vit_l()), counters, "flagship ViT-L",
                         {"K1": 1, "K2": 2, "K3": 24, "K4": 3}, absent=("K9",))
    rows = check_kernels(torch, np, mods, serve_shapes, "serve")
    torch.cuda.empty_cache()
    attention_edges(torch, A)
    patch_encoder_edges(torch, PE)

    giant_vit = P.ViTConfig(176, 2, 2, 352, swiglu=False, qkv_fused=True)
    tiny_nn = P.PointCloudSAMNN(P.VoronoiConfig(vit=giant_vit, num_patches=32),
                                generator=torch.Generator().manual_seed(0)).eval()
    end_to_end_tiny(torch, np, tiny_nn, "e2e tiny voronoi", counters, ("K5", "K8", "K10", "K11"))
    voronoi = serve(torch, np, Predictor(giant()), counters, "voronoi EVA-giant",
                    {"K4": 3, "K5": 40, "K8": 1, "K10": 1}, group=(2048, None))
    k5 = sum(voronoi["K5"].values())
    check(k5 == 40, f"voronoi EVA-giant: K5 launched {k5} times, not once per block (40)")
    torch.cuda.empty_cache()
    rows += check_kernels(torch, np, mods, voronoi, "voronoi")

    # The hier path: the tiny model at both routes of the tail, then
    # EVA02-L at the model's grouping (K4) and at the level-1 override
    # group_number=4096 (the gather and K11).
    tiny_hier = P.PointCloudSAMHier(
        P.HierConfig(vit=P.ViTConfig(**TINY_VIT),
                     tokenizer=P.HierTokenizerConfig((128, 32), (16, 8), (0.05, 0.1))),
        generator=torch.Generator().manual_seed(0)).eval()
    end_to_end_tiny(torch, np, tiny_hier, "e2e tiny hier", counters,
                    ("K2", "K3", "K4", "K8", "K10"))
    end_to_end_tiny(torch, np, tiny_hier, "e2e tiny hier, group_number=64", counters,
                    ("K2", "K3", "K8", "K10", "K11"), group_number=64)
    pred = Predictor(hier())
    hier_shapes = serve(torch, np, pred, counters, "hier EVA02-L",
                        {"K2": 2, "K3": 24, "K4": 3, "K8": 1, "K10": 2},
                        group=((2048, 512), (32, 32)), tokens=512, absent=("K11",))
    hier_big = serve(torch, np, pred, counters, "hier EVA02-L, group_number=4096",
                     {"K2": 2, "K3": 24, "K8": 1, "K10": 2, "K11": 3},
                     group=((4096, 512), (32, 32)), tokens=512, absent=("K4",),
                     group_number=4096)
    tail_routes(torch, UP, pred, counters)
    del pred
    torch.cuda.empty_cache()
    rows += check_kernels(torch, np, mods, hier_shapes, "hier")
    rows += check_kernels(torch, np, mods, hier_big, "hier4096")

    # The fused-geometry path: the ViT-L of phase 4 with knn_method="approx".
    # The exact kNN is plain torch (no launch counter), so its calls from the
    # tokenizer are counted here.
    T = importlib.import_module("point_sam_tpu_torch.models.tokenizer")
    exact_knn = T.knn
    knn_calls = []
    T.knn = lambda *a, **kw: (knn_calls.append(1), exact_knn(*a, **kw))[1]
    try:
        fused = serve(torch, np, Predictor(vit_l("approx")), counters, "fused-geometry ViT-L",
                      {"K2": 2, "K3": 24, "K4": 3, "K9": 1}, absent=("K1",))
        k9 = sum(fused["K9"].values())
        check(k9 == 1, f"fused-geometry ViT-L: K9 launched {k9} times in one encode")
        check(not knn_calls, f"fused-geometry ViT-L: the exact kNN ran {len(knn_calls)} times")
    finally:
        T.knn = exact_knn
    torch.cuda.empty_cache()
    rows += check_kernels(torch, np, mods, fused, "fusedgeom")

    train_step_tiny(torch, np, P, PS, criterion, counters)
    train, train_profile = train_vit_l(torch, trainer, build_model, load_config, counters)
    torch.cuda.empty_cache()
    rows += check_kernels(torch, np, mods, train, "train")
    check({r["kernel"] for r in rows} == set(counters), "a kernel was checked on no path")
    pe_train_repeats(torch, PE)
    patch_encoder_bwd_edges(torch, PE)
    attention_bwd_edges(torch, A)

    train_profile()
    profile_encode(torch, np, vit_l(), "flagship ViT-L")
    profile_encode(torch, np, giant(), "voronoi EVA-giant")
    profile_encode(torch, np, hier(), "hier EVA02-L")
    profile_encode(torch, np, hier(), "hier EVA02-L, group_number=4096", group_number=4096)
    profile_encode(torch, np, vit_l("approx"), "fused-geometry ViT-L")
    profile_attention_bwd(torch, A)

    meta = {
        "K1": ("fps_interp", "fps_interp.cu", "point_sam_tpu/ops/fps_pallas.py:138"),
        "K2": ("patch_encoder", "patch_encoder.cu",
               "point_sam_tpu/ops/patch_encoder_pallas.py:135"),
        "K3": ("attention", "attention.cu", "point_sam_tpu/ops/attention.py:178"),
        "K4": ("interp_upscale", "upscale.cu", "point_sam_tpu/ops/upscale_pallas.py:177"),
        "K5": ("attention_heads", "attention.cu", "point_sam_tpu/ops/attention.py:41"),
        "K6": ("attention_bwd", "attention_bwd.cu", "point_sam_tpu/ops/attention.py:327"),
        "K7": ("patch_encoder_bwd", "patch_encoder_bwd.cu",
               "point_sam_tpu/ops/patch_encoder_pallas.py:484"),
        "K8": ("fps", "fps_interp.cu", "point_sam_tpu/ops/fps_pallas.py:65"),
        "K9": ("fps_interp_knn", "fps_interp.cu", "point_sam_tpu/ops/fps_pallas.py:284"),
        "K10": ("interp_weights", "interp.cu", "point_sam_tpu/ops/interp_pallas.py:33"),
        "K11": ("upscale_hyper", "upscale.cu", "point_sam_tpu/ops/upscale_pallas.py:54"),
    }
    # One row per kernel, path and launch shape: its launches, error, times
    # and bound all belong to that shape on that path.
    kernels = []
    for r in rows:
        name, src, replaces = meta[r["kernel"]]
        label = f"{name}@{r['path']}" + (f"[{r['variant']}]" if r["variant"] else "")
        kernels.append(dict(name=label, route="cuda", source=f"point_sam_tpu_torch/csrc/{src}",
                            replaces=replaces, launches=r["launches"],
                            max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
                            bound_ms=r["bound_ms"], bound_by=r["bound_by"],
                            library_ms=r["library_ms"], path=r["path"], shape=r["shape"]))
        for extra in ("ms_without_argmax", "ms_pass_c", "ms_pass_d", "bound_ms_pass_d",
                      "ms_reduce"):
            if extra in r:
                kernels[-1][extra] = r[extra]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
