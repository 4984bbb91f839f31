#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (point_sam_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each fatal on failure (the script then exits non-zero before its
last line):

1. header: the card's name and power limit (nvidia-smi), torch, CUDA, nvcc;
2. build: compile the kernels from point_sam_tpu_torch/csrc (one nvcc per
   source, all started together), then print the attention, K2, K7, FPS
   and decoder-tail kernels' registers and stack (spill) bytes from
   ``cuobjdump --dump-resource-usage`` of the built library (reported, not
   gated; K7's four: the pass-C mma kernel, the pass-D mma kernel at both of
   its dw1a register tilings, and the one-launch kernel; FPS: the cluster
   route's selection kernel for K8 and K1, the grid route's cooperative
   kernel in its two modes, K9's bins kernel, the 3-NN scan that K1 /
   K9 (<false>) and K10 (<true>) share, and K12's kNN selection
   (csrc/knn.cu); K4 / K11: the mma route's kernel at D 128 and 256 and
   the fma route's, <true> K4, <false> K11);
3. end to end, tiny config, fp32 (a ViT of 2 heads of 64, so K3 runs; G=128
   so the decoder tail takes K4): the Predictor on the CPU (plain versions)
   and on the card (kernels, K12 among them), same weights, cloud and 3
   clicks;
4. the serving path: ViT-L (eva02_large) in bf16 with seeded random
   weights, a seeded 100k-point cloud (bucket 131072, G=2048, K=256),
   set_pointcloud and 3 clicks (the tokenizer's kNN is K12, exact), with
   every kernel's launches read around that run, by shape (each wrapper tallies its launches by the sizes and
   dtypes it was called with);
5. each kernel of the serving path against its plain torch version at
   every shape and dtype that path launched it with, on seeded inputs, both
   timed with CUDA events (median after a warm-up; the kernel also as its
   device time alone, the card spinning while the host prepares the call),
   with the one PyTorch
   call of the same function as a yardstick where there is one (SDPA for
   K3 and K5; the port never calls it); K1 and K8 (everywhere they run)
   also on the grid route where the path took the cluster route
   (``fps_route``), held to the same plain outputs, timed, and both
   printed as microseconds a selection step; K4 and K11 likewise on the
   route (``upscale_route``) the path did not take, "fma" beside "mma";
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
   model's grouping (K8, K10 twice, K12 twice, K2 at four shapes, K3, K4),
   then again
   with the Predictor's level-1 override group_number=4096 (the tail's
   K4 gate fails: the gather and K11), launches read by shape around each;
11. as 5, for every kernel of both hier runs, and the decoder tail at the
   override's shape by both routes on the same inputs (the cloud's level-1
   geometry, C=3 and C=1): K4 against the gather and K11 the path takes;
   then the sha256 of K4's and K11's fp32 outputs on seeded inputs
   (``tail_digest``);
12. the fused-geometry serving path: the ViT-L Predictor of 4 built with
   ``knn_method="approx"``: K9 once per encode (K1's launch on the padded
   cloud, on the route ``fps_route`` gives, then the bins kernel over its
   centres and a top-k over 4096 bins) and neither K1's wrapper nor the
   exact kNN (K12); then as 5 for its kernels: K9's five outputs and its bins
   (cd / ci, given K1's centres) held bit for bit to their plain versions,
   its kNN to a recall >= 0.9 against the exact kNN; its route and time a
   selection step printed, and the bins kernel and the top-k also timed
   alone (the bins with their own bound);
12k. K12 against ``knn_select_plain`` bit for bit (indices and d^2) at
   the shapes its paths launch it with (serve [1, 2048] x [1, 131072] at
   k = 256 with 100k valid keys; train [2, 1024] x [2, 10000] at k = 256;
   hier [1, 2048] x [1, 131072] and [1, 512] x [1, 2048] at k = 32), in
   approximate mode at the serve shape at recall targets 0.9 and 0.95
   (4096 and 8192 bins; the recall against its exact mode printed and at
   least the target), with every key four times (ties) and with only k
   valid keys; each timed as 5, beside its bound and, in exact mode, the
   exact search as one cuBLAS product and torch.topk (``K12_CASES``);
12e. the interactive evaluator, tiny: ``evaluate_scene`` with the fp32
   model of 3 on the CPU (plain versions) and on the card, one synthetic
   scene of 1500 points padded to 2048, 7 instances in chunks of 2 (the
   last partial), 3 clicks, exact (K1-K4, K12) and with
   ``fps_candidates=1024`` (K8 on the subset, K10, K12): IoUs per instance
   and click within 1e-5;
12f. the flagship evaluation: 2 synthetic scenes of 100,000 points written
   by ``serving/make_assets.py``, the bf16 ViT-L (G=2048, K=256, bucket
   131072), 5 clicks, 4 masks a batch, in four arms: ``evaluate_directory``
   (exact: K1, K12), then ``evaluate_scene`` with ``fps_candidates=32768``
   (K8 on the subset, K10, K12), with ``knn_method="approx"`` (K9, no K12)
   and with ``knn_method="approx", knn_recall_target=0.95`` (K9's gate
   fails: K1, then K12 over 8192 bins); per arm the mIoU
   per click (finite, in [0, 1]; seeded weights), each scene's ms and the
   click sampler's share of it (CUDA events), peak memory and exact launch
   counts; then as 5 for every kernel of each arm (paths ``eval``,
   ``eval-fpscand``, ``eval-fusedgeom``, ``eval-approx95``: K2 and K4 at
   BM=4, K8 on the 32768-point subset among them);
12s. the demo server: ``build_server`` over a bf16 ViT-L Predictor on
   127.0.0.1 in a thread, over HTTP: GET /pointcloud of a 12f asset, three
   POST /segment, /next, /save; each seg bit-equal to ``Predictor.click``
   on the same cloud and clicks, the launches of each request exact, its
   wall ms printed;
13. tiny train step in fp32 (the ViT of 3, so K3 and K6 run; G=32, so the
   forward's tail is K11): the CPU with the plain versions against the
   card with the kernels, same weights, batch and clicks; then the card's
   step again, every grad bit-equal, and (printed) how many grads differ
   with the gathers' backward as autograd's own, plainly and under
   ``torch.use_deterministic_algorithms(True)``;
13v. as 13, the tiny voronoi model (``PointCloudSAMNN.forward``, its ViT
   recomputed in the backward) twice: the giant-shaped ViT of 6 at G=32 (K5
   and its plain backward, K8, K10, K11) and the ViT of 3 at G=128 with
   refinement iterations (K3, K6, K4, K8, K10); each card step again, and
   once with the ViT's remat off: every grad bit-equal;
13h. as 13, the tiny hier model (``PointCloudSAMHier.forward``, the ViT of
   3 over G=(128, 32), K=(16, 8), refinement iterations; K2, K3, K4, K6,
   K7 with dx at level 2, K8, K10), both sides with the fixed sampler in
   the random one's place so their clicks agree; the card's step again and
   with remat off, then twice with the random sampler under one seed:
   clicks and every grad bit-equal;
14. the training path: ViT-L through ``trainer.main`` with the reference
   recipe (configs/large.yaml on synthetic data: B=2, N=10,000, M=2,
   G=1024, K=256 (K12), 5 click iterations, bf16 compute, fp32 AdamW), 5 steps,
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
14v. the voronoi training paths: configs/voronoi_large.yaml (EVA02-L,
   B=32, 5 click iterations) and configs/voronoi_giant.yaml (EVA-giant, 1B
   parameters, B=16, 10 click iterations) through ``trainer.main``, 5
   steps each on the synthetic set (the recipes' ``mixture`` replaced by
   configs/dataset/synthetic.yaml as a whole ``train_dataset`` value;
   N=10,000, M=2, G=1024, bf16 compute, fp32 AdamW, per-block ViT remat),
   checked as 14 (step count, finite losses, no zero grad on the first step
   outside MAY_BE_ZERO, every parameter moved but those of MAY_BE_ZERO's
   that took no gradient in any step, launches a step: K3 >= 48,
   K6 >= 24 / K5 >= 80, K4 once a decode, K8 and K10; none of the kNN
   path's), with their losses, step time and peak memory printed, then the
   click sampler alone at each recipe's batch (CUDA events);
15v. as 5, for every kernel of both voronoi training runs (paths
   ``voronoi-train`` and ``giant-train``: K3 / K6 at [32, 1024, 1024], K5
   at [16, 16, 1024, 88], K4 at BM = 64 / 32, K8 at [32 / 16, 10000], K10);
14h. the hier training path: configs/large.yaml's recipe (B=2, N=10,000,
   M=2) with configs/model/hier.yaml as its whole ``model`` value (EVA02-L,
   G=(2048, 512), K=(32, 32), 8 click iterations with the random sampler,
   per-block remat) through ``trainer.main``, 5 steps on the synthetic set,
   checked as 14, launches a step: K3 >= 48, K6 >= 24, K2 and K7 >= 16, K4
   >= 8, K8 >= 1, K10 >= 2, K12 >= 2, none of K1, K5, K9, K11; K7 with dx exactly
   at the two level-2 shapes (C_in = 131);
15h. as 5, for every kernel of the hier training run (path
   ``hier-train``): K2 with its argmax outputs and K7 (with dx at level 2,
   its passes C / D timed) at the four PointNet shapes, K3 / K6 at [2, 512,
   1024], K4 at BM = 4, D = 128, K8, K10 at both levels;
16. profiles under torch.profiler (device time by stage; K7 by kernel:
   pass C, pass D, the reduction): one ViT-L train step, timed on one batch
   before and after that profiler session, one train step of each voronoi
   recipe and of the hier recipe (the same stages; its model and optimizer
   built anew), then
   one encode of each serving path (ViT-L, voronoi EVA-giant, hier at
   both groupings, fused-geometry ViT-L) on its model built anew, the
   ViT-L's first and refining click by stage (the decoder tail's kernels
   held to K4's and K11's launches), then 20 calls of K6 and 20 of SDPA's
   backward at the train shape. They come last, after every timed phase,
   because a profiler session slows the host's launches for the rest of
   the process. Each session opens with the profiled call once as a traced
   warm-up whose records are dropped, and its device total leaves out
   ranges (the profiler's and the optimizer's steps) and may not exceed its
   wall time. Every launch that K1-K5, K8-K12
   count in a profiled step, encode or click must show in its trace (a
   session that lost one is retaken, at most 3 in all), and each profiled
   encode's geometry must equal its warm-up's bit for bit.

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


def time_ms(torch, fn, reps: int = 5, ahead: bool = False) -> float:
    """Median time between CUDA events around ``fn`` over ``reps`` runs
    after one warm-up. The host's work for ``fn`` (a wrapper's casts and
    checks, the launch) counts where the card waits for it. With ``ahead``
    the card first spins for about a millisecond (``torch.cuda._sleep``),
    so the host is done before the card reaches ``fn``: the device time of
    its kernels alone."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if ahead:
            torch.cuda._sleep(2_000_000)
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

    if name in ("K1", "K8"):
        B, N, G = key["B"], key["N"], key["G"]
        pts, valid, n_real = cloud(B, N, key["valid"])
        interp = name == "K1"
        # The route the path took (fps_route) and, where the row fits a
        # cluster, the grid route on the same inputs: both checked, both
        # timed (``other``).
        other = ({"other": lambda: F._launch(pts, G, valid, "grid", interp),
                  "other_route": "grid"} if F.fps_route(N) == "cluster" else {})
        # ~10 fp32 operations per real point per selection step (distance,
        # min, the running argmax; K1 also the best-3); the G sequential
        # steps each end in a barrier across the row's blocks, a latency
        # floor the roofline does not see.
        if interp:
            nbytes = B * (N * (3 * 4 + (valid is not None)) + G * 16 + N * 3 * 8)
            return dict(run=lambda: F.fps_interp_cuda(pts, G, valid=valid),
                        plain=lambda: F.fps_interp_plain(pts, G, valid=valid),
                        compare=exact("K1", ("idx", "centers", "interp_idx", "interp_d2")),
                        work=(nbytes, {"fp32": 10.0 * B * n_real * G}), steps=G - 1, **other)
        nbytes = B * (N * (3 * 4 + (valid is not None)) + G * 4)
        return dict(run=lambda: F.fps_cuda(pts, G, valid=valid),
                    plain=lambda: F.fps_plain(pts, G, valid=valid), compare=exact("K8", ("idx",)),
                    work=(nbytes, {"fp32": 10.0 * B * n_real * G}), steps=G - 1, **other)

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

        # K9's parts on the padded cloud: the bins kernel given K1's
        # centres (held to ``knn_bins_plain`` bit for bit), and the top-k
        # given the bins; each timed alone.
        l_lanes = 512
        pts_p, v = F._knn_cells(pts, valid, l_lanes)
        n_pad = pts_p.shape[1]
        centers = F._launch(pts_p, G, v, F.fps_route(n_pad), interp=True)[1]
        bins = lambda: F.knn_bins_cuda(pts_p, v, centers, l_lanes)  # noqa: E731
        cd, ci = bins()

        def all_equal(got, want):
            equal_and_recall(got, want)
            want_d, want_i = F.knn_bins_plain(pts_p, v, centers, l_lanes)
            got_d, got_i = bins()
            check(torch.equal(got_d.view(torch.int32), want_d.view(torch.int32))
                  and torch.equal(got_i, want_i), "K9 bins cd / ci differ from knn_bins_plain")
            return 0.0

        # K1's ~10 fp32 operations per real point per step plus the bin
        # fold's ~3 (mask, compare, select); the cd / ci bins [G, 4096]
        # written once and the [G, k] ids. The bins alone: each (real
        # point, centre) pair's distance (6) and fold (3); the padded cloud
        # and its validity read once, cd / ci written once.
        nbins = 8 * l_lanes
        nbytes = B * (N * (3 * 4 + (valid is not None)) + G * 16 + N * 3 * 8 + G * nbins * 8
                      + G * k * 4)
        bins_bytes = B * (n_pad * 13 + G * 12 + G * nbins * 8)
        return dict(run=lambda: F.fps_interp_knn_cuda(pts, G, k, valid=valid),
                    plain=lambda: F.fps_interp_knn_plain(pts, G, k, valid=valid),
                    compare=all_equal, work=(nbytes, {"fp32": 13.0 * B * n_real * G}),
                    steps=G - 1,
                    parts={"bins": (bins, (bins_bytes, {"fp32": 9.0 * B * n_real * G})),
                           "top_k": (lambda: F.bins_top_k(cd, ci, k, N), None)})

    if name == "K12":
        return knn_case(torch, K, key, g, cloud)

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
            work=(nbytes, {kind: 2.0 * B * M * N * D * D + 2.0 * B * M * C * N * D}),
            **tail_routes_of(UP, key, D, C, cdt, lambda r: UP._launch_interp_upscale(
                h1, idx, w, params, hyper, cdt, r)))

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
            work=(nbytes, {kind: 2.0 * BM * N * D * D + 2.0 * BM * C * N * D}),
            **tail_routes_of(UP, key, D, C, cdt, lambda r: UP._launch_upscale_hyper(
                x, params, hyper, cdt, r)))
    raise ValueError(name)


# Phase 12k: K12 at the shapes its paths launch it with (the serve cloud:
# 100,000 valid keys in the 131072 bucket; the train batch; hier's two
# levels), its approximate mode at the serve shape at recall targets 0.9
# and 0.95 (``approx_bins``: 4096 and 8192 bins), every key four times
# (ties) and a row of only k valid keys.
SERVE_KNN = dict(B=1, Nq=2048, Nk=131072)
K12_CASES = (
    dict(SERVE_KNN, k=256, valid=True, bins=None),
    dict(B=2, Nq=1024, Nk=10000, k=256, valid=False, bins=None),
    dict(SERVE_KNN, k=32, valid=True, bins=None),
    dict(B=1, Nq=512, Nk=2048, k=32, valid=False, bins=None),
    dict(SERVE_KNN, k=256, valid=True, bins=4096, rt=0.9),
    dict(SERVE_KNN, k=256, valid=True, bins=8192, rt=0.95),
    dict(SERVE_KNN, k=256, valid=False, bins=None, case="ties"),
    dict(B=1, Nq=256, Nk=131072, k=256, valid=True, bins=None, case="few_valid"),
)


def knn_case(torch, K, key: dict, g, cloud) -> dict:
    """Kernel K12 at one launch key (or a K12_CASES entry): the keys a
    seeded cloud (``cloud``), the queries a seeded subset of its real
    points; held to ``knn_select_plain`` bit for bit. The approximate mode
    also against K12's exact mode: its recall (the mean share of each
    query's k nearest keys it returns) printed, at least the bins'
    expected recall exp(-(k - 1) / L) less 0.02 and at least the key's
    recall target where it names one. Work: ~8 fp32 operations a (query,
    key) pair (the 3 FMAs of the cross term, its combination with the
    norms, the compare); the points read once, the outputs written once.
    Library: the exact search as one cuBLAS product and torch.topk (the
    port's exact path before K12), for the exact mode."""
    dev = torch.device("cuda")
    B, nq, nk, k, bins = (key[f] for f in ("B", "Nq", "Nk", "k", "bins"))
    keys, valid, real = cloud(B, nk, key["valid"])
    if key.get("case") == "ties":
        real = nk // 4
        keys = keys[:, :real].repeat(1, 4, 1).contiguous()
    elif key.get("case") == "few_valid":
        valid = torch.zeros((B, nk), dtype=torch.bool, device=dev)
        valid[:, torch.randperm(nk, generator=g, device=dev)[:k]] = True
    query = keys[:, torch.randperm(real, generator=g, device=dev)[:nq]].contiguous()
    stats = {}

    def equal(got, want):
        check(torch.equal(got[1], want[1])
              and torch.equal(got[0].view(torch.int32), want[0].view(torch.int32)),
              f"K12 {key}: differs from knn_select_plain")
        if bins is not None:
            _, truth = K.knn_select_cuda(query, keys, k, key_valid=valid)
            hit = (got[1][..., :, None] == truth[..., None, :]).any(-1).float().mean().item()
            want_hit = max(math.exp(-(k - 1) / bins) - 0.02, key.get("rt", 0.0))
            if "rt" in key:
                check(K.approx_bins(nk, k, key["rt"])[0] == bins, f"K12 {key}: not XLA's bins")
            check(hit >= want_hit, f"K12 {key}: recall {hit:.4f} < {want_hit:.4f}")
            stats["recall"] = hit
            print(f"K12 approximate recall against its exact mode: {hit:.4f} ({key})",
                  flush=True)
        return 0.0

    def library():
        from point_sam_tpu_torch.ops.distance import sq_dist

        d2 = sq_dist(query, keys)
        if valid is not None:
            d2 = d2.masked_fill(~valid[:, None, :], float("inf"))
        return torch.topk(d2, k, dim=-1, largest=False)

    nbytes = B * (nq * 12 + nk * (12 + (valid is not None)) + nq * k * 8)
    case = dict(run=lambda: K.knn_select_cuda(query, keys, k, key_valid=valid, bins=bins),
                plain=lambda: K.knn_select_plain(query, keys, k, key_valid=valid, bins=bins),
                compare=equal, work=(nbytes, {"fp32": 8.0 * B * nq * nk}), stats=stats)
    if bins is None:
        case["library"] = library
    return case


def tail_routes_of(UP, key: dict, D: int, C: int, cdt, launch) -> dict:
    """The route a K4 / K11 launch key recorded, which must be
    ``upscale_route``'s for the key's shapes; where that is "mma", also the
    "fma" route (``launch(route)``), which takes every shape, as the other.
    The mma route takes no shape that upscale_route gives to fma."""
    route = UP.upscale_route(D, C, cdt)
    check(key["route"] == route, f"decoder tail {key}: route is not {route}")
    other = {"other": lambda: launch("fma"), "other_route": "fma"} if route == "mma" else {}
    return dict(route=route, **other)


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
    K2's reduction that K rows reach: 1 = 0 (one fragment), 21 = 5 and 40 =
    3 (other row groups), 70 = 10 (another 64-row chunk), 200 = 130
    (another chunk and m-tile). The copies are never a first maximum; the
    sources are returned for the count of columns whose maximum is a
    duplicated row."""
    pairs = [(src, dst) for src, dst in ((0, 1), (5, 21), (3, 40), (10, 70), (130, 200))
             if dst < x.shape[2]]
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
    times (CUDA events, median; the kernel also as device time alone,
    ``time_ms(ahead=True)``) and the bound. K2 with its argmax outputs
    is also timed without them (``ms_without_argmax``)."""
    g = torch.Generator(device="cuda").manual_seed(1)
    rows = []
    for name, shapes in shapes_by_kernel.items():
        keys = [dict(k) for k in shapes]
        fields = dict.fromkeys(f for k in keys for f in k)
        varying = [f for f in fields if len({str(k.get(f)) for k in keys}) > 1]
        for key_t, key in zip(shapes, keys):
            case = kernel_case(torch, np, mods, name, key, g)
            want = case["plain"]()
            err = case["compare"](case["run"](), want)
            if "other" in case:  # K1 / K8, K4 / K11 on the route the path did not take
                case["compare"](case["other"](), want)
            del want
            torch.cuda.empty_cache()
            row = dict(kernel=name, path=path, shape=key, launches=shapes[key_t],
                       variant=",".join(f"{f}={key.get(f)}" for f in varying), max_abs_err=err,
                       **case.get("stats", {}),
                       ms=time_ms(torch, case["run"]),
                       device_ms=time_ms(torch, case["run"], ahead=True),
                       plain_ms=time_ms(torch, case["plain"], reps=3),
                       library_ms=time_ms(torch, case["library"]) if "library" in case else None)
            if "without" in case:
                row["ms_without_argmax"] = time_ms(torch, case["without"])
            if "other" in case:  # K1 / K8, K4 / K11: the route the path did not take
                row.update(other_route=case["other_route"],
                           ms_other_route=time_ms(torch, case["other"]),
                           device_ms_other_route=time_ms(torch, case["other"], ahead=True))
            if "route" in case:  # K4 / K11
                row["tail_route"] = case["route"]
            parts = case.get("parts", {})
            for part, (fn, work) in parts.items():  # K9's bins and top-k alone
                row[f"ms_{part}"] = time_ms(torch, fn)
                row[f"device_ms_{part}"] = time_ms(torch, fn, ahead=True)
                if work is not None:
                    row[f"bound_ms_{part}"] = bound(*work)[0]
            if "steps" in case:  # K1 / K8 / K9: per selection step, on both routes
                steps = max(1, case["steps"])
                row.update(fps_route=key["route"], us_per_step=row["ms"] * 1e3 / steps)
                if "other" in case:
                    row["us_per_step_other_route"] = row["ms_other_route"] * 1e3 / steps
            if "passes" in case:  # K7's mma route: C, then D and the reduction by difference
                c_ms, cd_ms = (time_ms(torch, fn) for fn in case["passes"])
                row.update(ms_pass_c=c_ms, ms_pass_d=cd_ms - c_ms, ms_reduce=row["ms"] - cd_ms)
                row["bound_ms_pass_d"] = bound(*case["pass_d_work"])[0]
            row["bound_ms"], row["bound_by"] = bound(*case["work"])
            parts = list(parts)  # the names: the tensors go with the case
            del case
            torch.cuda.empty_cache()
            lib = "" if row["library_ms"] is None else f"  library {row['library_ms']:.4f} ms"
            if "ms_without_argmax" in row:
                lib += f"  without the argmax outputs {row['ms_without_argmax']:.4f} ms"
            if "fps_route" in row:
                lib += f"  route {row['fps_route']}, {row['us_per_step']:.4f} us a selection step"
                if "ms_other_route" in row:
                    lib += (f"; {row['other_route']} route {row['ms_other_route']:.4f} ms, "
                            f"{row['us_per_step_other_route']:.4f} us a step")
            if "tail_route" in row:
                lib += f"  route {row['tail_route']}"
                if "ms_other_route" in row:
                    lib += (f"; {row['other_route']} route {row['ms_other_route']:.4f} ms, "
                            f"device {row['device_ms_other_route']:.4f} ms")
            for part in parts:
                lib += (f"  {part} alone {row[f'ms_{part}']:.4f} ms (device "
                        f"{row[f'device_ms_{part}']:.4f} ms"
                        + (f", bound {row[f'bound_ms_{part}']:.4f} ms)"
                           if f"bound_ms_{part}" in row else ")"))
            if "ms_pass_c" in row:
                lib += (f"  pass C {row['ms_pass_c']:.4f} ms, pass D {row['ms_pass_d']:.4f} ms "
                        f"(its bound {row['bound_ms_pass_d']:.4f} ms), "
                        f"reduction and set-up {row['ms_reduce']:.4f} ms")
            print(f"kernel {name} {path} {key}: {row['launches']} launches, max_abs_err "
                  f"{err:.6g}  kernel {row['ms']:.4f} ms (device {row['device_ms']:.4f} ms)  "
                  f"plain {row['plain_ms']:.4f} ms{lib}  "
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
    """Registers, stack and local bytes (spills) of each attention kernel,
    each K2 and K7 kernel, each FPS kernel (both routes of K1 / K8, K9's
    bins, the 3-NN scan of K1 / K9 and K10) and each decoder-tail kernel
    (K4 / K11 on both routes: <true> is K4, <false> K11) in the built
    library, from ``cuobjdump
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
        fk = re.search(r"\d+((?:fps_interp|fps_cluster|nn3|knn_bins|knn_select)_kernel)"
                       r"(?:I((?:L[bi]\d+E)+)E)?", mangled)
        up = re.search(r"\d+(interp_upscale(?:_mma)?_kernel)I((?:f|13__nv_bfloat16|L[bi]\d+E)+)E",
                       mangled)
        if up:
            args = ", ".join({"f": "float", "13__nv_bfloat16": "bf16", "Lb0": "false",
                              "Lb1": "true"}.get(a + v, v)
                             for a, v in re.findall(r"(f|13__nv_bfloat16|L[bi])(\d*)E?", up[2]))
            rows.append(f"{up[1]}<{args}> {reg} reg, stack {stack} B, local {local} B")
        elif fk:
            args = ", ".join({"b0": "false", "b1": "true"}.get(k + v, v)
                             for k, v in re.findall(r"L([bi])(\d+)E", fk[2] or ""))
            rows.append(f"{fk[1]}{f'<{args}>' if args else ''} {reg} reg, stack {stack} B, "
                        f"local {local} B")
        elif m:
            dtype = {"f": "float, ", "13__nv_bfloat16": "bf16, "}.get(m[2] or "", "")
            rows.append(f"{m[1]}<{dtype}{m[3]}> {reg} reg, stack {stack} B, local {local} B")
        elif k2:
            tiles = re.fullmatch(r"Li(\d+)E", k2[2] or "")
            dtype = (f"<{tiles[1]}>" if tiles else
                     {"f": "<float>", "13__nv_bfloat16": "<bf16>"}.get(k2[2] or "", ""))
            rows.append(f"{k2[1]}{dtype} {reg} reg, stack {stack} B, local {local} B")
    print("resources (cuobjdump): "
          + ("; ".join(sorted(rows)) or "no attention, K2, K7, FPS or tail kernel listed"),
          flush=True)


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
# The tiny voronoi model's ViT of phases 6 and 13v: EVA-giant's block (fused
# qkv, GELU MLP) at D=176 in 2 heads of 88, so K5 runs.
TINY_GIANT_VIT = dict(embed_dim=176, depth=2, num_heads=2, mlp_hidden_dim=352, swiglu=False,
                      qkv_fused=True)


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


def tensors(tree) -> list:
    """The tensors of nested dicts, lists and tuples, in order."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in tensors(v)]
    return [tree] if hasattr(tree, "is_cuda") else []


def profile_encode(torch, np, model, label, counters, with_clicks=False, **override):
    """Phase 16: one encode of a serving path (with ``override`` of its
    grouping) under torch.profiler (``profile``), on a model built anew (the
    timed phases keep none alive); ``with_clicks``: then its clicks
    (``profile_clicks``)."""
    from point_sam_tpu_torch.serving import Predictor

    pred = Predictor(model)
    xyz, rgb = synthetic_cloud(np.random.default_rng(0), N_FLAGSHIP)
    pred.set_pointcloud(xyz, rgb, **override)  # warm-up
    warm = tensors(pred._state["geom"])
    profile(torch, f"{label} encode", lambda: pred.set_pointcloud(xyz, rgb, **override),
            ENCODE_STAGES, counters)
    # The geometry (the FPS picks and all that follows from them) of the
    # profiled encode, bit-equal to the warm-up's: the traced launches ran.
    got = tensors(pred._state["geom"])
    check(len(got) == len(warm) and all(torch.equal(a, b) for a, b in zip(got, warm)),
          f"{label} encode: the profiled encode's geometry differs from the warm-up's")
    if with_clicks:
        profile_clicks(torch, pred, xyz, label, counters)
    del pred, warm, got
    torch.cuda.empty_cache()


def profile_clicks(torch, pred, xyz, label, counters):
    """A first click (3 masks, no mask prompt) and a refining click (a
    negative point and the previous logits as mask prompt, 1 mask) on
    ``pred``'s cloud under torch.profiler, by stage (``CLICK_STAGES``;
    the tail's traced kernels held to the launches K4 / K11 count)."""
    def first():
        return pred.predict_masks(xyz[10:11], [1])

    prev = first()[2][0, 0]  # warm-up

    def refine():
        return pred.predict_masks(xyz[[10, 700]], [1, 0], prev, False)

    refine()
    profile(torch, f"{label} first click", first, CLICK_STAGES, counters)
    profile(torch, f"{label} refining click", refine, CLICK_STAGES, counters)


def tail_digest(torch, UP) -> None:
    """sha256 of the fp32 outputs of K4 and K11 on seeded inputs at the
    tiny fp32 Predictor's and train step's kind of shape (D=256, C=3, M=2),
    through the public wrappers."""
    import hashlib

    g = torch.Generator(device="cuda").manual_seed(3)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, device="cuda", generator=g) * scale

    B, M, G, N, D, C = 2, 2, 128, 3000, 256, 3
    h1 = randn(B * M, G, D)
    idx = torch.randint(0, G, (B, N, 3), device="cuda", generator=g, dtype=torch.int32)
    idx[0, :5, 1] = idx[0, :5, 0]
    w = torch.rand((B, N, 3), device="cuda", generator=g)
    w = w / w.sum(-1, keepdim=True)
    params = (1.0 + randn(D, scale=0.1), randn(D, scale=0.1), randn(D, D, scale=D ** -0.5),
              randn(D, scale=0.1))
    hyper = randn(B * M, C, D)
    outs = {"K4": UP.interp_upscale_cuda(h1, idx, w, params, hyper, cdt=torch.float32),
            "K11": UP.upscale_hyper_cuda(randn(B * M, N, D), params, hyper, cdt=torch.float32)}
    torch.cuda.synchronize()
    print("decoder tail fp32 digests: " + ", ".join(
        f"{k} {hashlib.sha256(v.cpu().numpy().tobytes()).hexdigest()[:16]}"
        for k, v in outs.items()), flush=True)


def differ(torch, a: dict, b: dict) -> list:
    """The names whose tensors in ``a`` and ``b`` are not bit-equal."""
    return [n for n in a if not torch.equal(a[n], b[n])]


def tiny_train_check(torch, np, PS, criterion, counters, cpu_model, label, expect, loose):
    """One tiny fp32 train step of ``cpu_model``, the CPU's plain versions
    against the card's kernels (each of ``expect`` must launch), same
    weights, batch (B=2 seeded clouds of N=600 points, M=2 masks each) and
    clicks. Tolerances: loss 1e-4 relative; each grad 1e-4 of its largest
    entry + 1e-6, those whose names start with one of ``loose`` 5e-3 (the
    card sums in another order, and a max's near-tie within that fp32 noise
    moves a column's grad to another point). Then the card's step again on
    a fresh copy of the model: every grad must be bit-equal. Returns (step,
    the card's grads): ``step(dev, remat=None)`` runs the step on a fresh
    copy, with its ViT's remat set where ``remat`` is given, -> (outputs,
    loss, grads)."""
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

    def step(dev, remat=None):
        model = copy.deepcopy(cpu_model).to(dev)
        if remat is not None:
            model.pc_encoder.transformer.remat = remat
        tb = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
        with torch.no_grad():  # the clicks, drawn as train_step draws them
            outs = model(tb["coords"], tb["features"], tb["gt_masks"],
                         generator=torch.Generator().manual_seed(0))
        opt = PS.make_optimizer(model.parameters(), lambda step: 0.0, weight_decay=0.0,
                                max_grad_value=float("inf"))
        metrics = PS.train_step(model, opt, tb, torch.Generator().manual_seed(0),
                                criterion=criterion)
        grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()
                 if p.grad is not None}
        return outs, float(metrics["loss"]), grads

    results = []
    for dev in ("cpu", "cuda"):
        reset(counters)
        results.append(step(dev))
    missing = [k for k in expect if counters[k].launches == 0]
    check(not missing, f"{label}: kernels {missing} did not launch on the card")
    (co, cl, cg), (go, gl, gg) = results
    for c_, g_ in zip(co, go):
        check(torch.equal(c_["prompt_coords"], g_["prompt_coords"].cpu()),
              f"{label}: the clicks differ")
    check(abs(gl - cl) <= 1e-4 * abs(cl), f"{label}: loss {gl} vs {cl}")
    check(set(cg) == set(gg), f"{label}: grads of different parameters")
    worst = 0.0
    for n in cg:
        rel = 5e-3 if n.startswith(loose) else 1e-4
        err = (gg[n].cpu() - cg[n]).abs().max().item()
        scale = cg[n].abs().max().item()
        check(err <= rel * scale + 1e-6, f"{label}: grad {n} err {err:.3g} of {scale:.3g}")
        worst = max(worst, err / (rel * scale + 1e-6))
    print(f"{label} fp32: card kernels {list(expect)} vs CPU plain, loss {gl:.6f} vs {cl:.6f}, "
          f"{len(cg)} grads, worst error {worst:.3g} of its tolerance", flush=True)
    again = differ(torch, gg, step("cuda")[2])
    check(not again, f"{label}: two runs on the card differ in {len(again)} grads, the "
          f"first {again[0] if again else ''}")
    return step, gg


def train_step_tiny(torch, np, P, PS, criterion, counters):
    """Phase 13: the tiny kNN model's train step (``tiny_train_check``: the
    ViT of 3, so K3 and K6 run; G=32, so the forward's tail is K11; K1,
    K2 and K7 for the patch and mask PointNets, whose grads are the loose
    ones). Last, what broke the repeat before is printed (not gated): how
    many grads differ between two such steps with the gathers' backward as
    autograd's own (``index_select``'s: ``index_add_``, atomic adds on the
    card), plainly and under ``torch.use_deterministic_algorithms(True)``
    (or the op that raises)."""
    import importlib
    import os

    cfg = P.PointSAMConfig(vit=P.ViTConfig(**TINY_VIT), tokenizer=P.TokenizerConfig(32, 16),
                           prompt_iters=3, enable_mask_refinement_iterations=False)
    cpu_model = P.PointCloudSAM(cfg, generator=torch.Generator().manual_seed(0))
    step, gg = tiny_train_check(torch, np, PS, criterion, counters, cpu_model,
                                "train step tiny",
                                ("K1", "K2", "K3", "K6", "K7", "K11", "K12"),
                                loose=("pc_encoder.patch_embed.patch_encoder.",
                                       "mask_encoder.patch_encoder."))
    group = importlib.import_module("point_sam_tpu_torch.ops.group")
    port = group._SelectRows.apply
    group._SelectRows.apply = lambda flat, idx: flat.index_select(0, idx)
    config = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    try:
        found = [differ(torch, *(step("cuda")[2] for _ in range(2)))]
        os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
        torch.use_deterministic_algorithms(True)
        try:
            found.append(differ(torch, *(step("cuda")[2] for _ in range(2))))
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


def train_step_tiny_voronoi(torch, np, P, PS, criterion, counters):
    """Phase 13v: the tiny voronoi model's train step (``tiny_train_check``)
    twice: the giant-shaped ViT of phase 6 (dh 88: K5 forward, its plain
    backward) at G=32 (the tail: the gather and K11), and the ViT of 3 (dh
    64: K3, K6) at G=128 (K4), with refinement iterations; K8 and K10 for
    the geometry. The loose grads are the patch embed's per-point layers
    (before its scatter max) and the whole mask encoder, as phase 13's mask
    PointNet: its input is the previous iteration's logits, which differ by
    the card's summation order, and its scatter max picks among near-ties
    within that noise. Then the card's step with the ViT's remat off: every
    grad bit-equal to the step with it on (the blocks' forward run again in
    the backward gives the same bits)."""
    runs = (("train step tiny voronoi, dh 88", P.ViTConfig(**TINY_GIANT_VIT), 32, False,
             ("K5", "K8", "K10", "K11")),
            ("train step tiny voronoi, dh 64", P.ViTConfig(**TINY_VIT), 128, True,
             ("K3", "K4", "K6", "K8", "K10")))
    for label, vit, G, refine, expect in runs:
        cfg = P.VoronoiConfig(vit=vit, num_patches=G, prompt_iters=3,
                              enable_mask_refinement_iterations=refine)
        check(cfg.vit_remat, f"{label}: VoronoiConfig's vit_remat is not on by default")
        cpu_model = P.PointCloudSAMNN(cfg, generator=torch.Generator().manual_seed(0))
        step, gg = tiny_train_check(torch, np, PS, criterion, counters, cpu_model, label, expect,
                                    loose=("pc_encoder.patch_embed.in_proj.",
                                           "pc_encoder.patch_embed.blocks1_", "mask_encoder."))
        off = differ(torch, gg, step("cuda", remat=False)[2])
        check(not off, f"{label}: remat on and off differ in {len(off)} grads, the first "
              f"{off[0] if off else ''}")
        print(f"{label}: {len(gg)} grads bit-equal over two runs on the card, and with the "
              f"ViT's remat off", flush=True)


def train_step_tiny_hier(torch, np, P, PS, criterion, counters):
    """Phase 13h: the tiny hier model's train step (``tiny_train_check``):
    the ViT of 3 (K3, K6) over G=(128, 32), K=(16, 8) with hier.yaml's radii
    (K8, K10 twice, K2 and K7 at both levels, K7 with dx at level 2, whose
    input holds the level-1 embeddings; G1=128, so the tail is K4), 3
    click iterations with refinement. The CPU and the card cannot draw the
    same noise, so both click by the fixed sampler in the random one's
    place (``models/pc_sam.py``'s ``sample_prompts_random``) and their
    clicks agree; the card's step again, and with the ViT's remat off:
    every grad bit-equal. Then the card's step twice with the random
    sampler under one seed: the same clicks and every grad bit-equal. The
    loose grads are both PointNets' of the patch embed and the mask
    encoder (phase 13's reason; level 2 reads level 1's output)."""
    import importlib

    from point_sam_tpu_torch.ops.sampler import sample_prompts

    label = "train step tiny hier"
    cfg = P.HierConfig(vit=P.ViTConfig(**TINY_VIT),
                       tokenizer=P.HierTokenizerConfig((128, 32), (16, 8), (0.05, 0.1)),
                       prompt_iters=3)
    check(cfg.vit_remat and cfg.enable_mask_refinement_iterations,
          f"{label}: HierConfig's remat or refinement is not on by default")
    cpu_model = P.PointCloudSAMHier(cfg, generator=torch.Generator().manual_seed(0))
    pc = importlib.import_module("point_sam_tpu_torch.models.pc_sam")
    random = pc.sample_prompts_random
    pc.sample_prompts_random = lambda gen, coords, gt, pred=None, *, point_valid=None: (
        sample_prompts(coords, gt, pred, point_valid=point_valid))
    try:
        step, gg = tiny_train_check(torch, np, PS, criterion, counters, cpu_model, label,
                                    ("K2", "K3", "K4", "K6", "K7", "K8", "K10", "K12"),
                                    loose=("pc_encoder.patch_embed.", "mask_encoder."))
        off = differ(torch, gg, step("cuda", remat=False)[2])
    finally:
        pc.sample_prompts_random = random
    check(not off, f"{label}: remat on and off differ in {len(off)} grads, the first "
          f"{off[0] if off else ''}")
    (o1, _, g1), (o2, _, g2) = step("cuda"), step("cuda")
    check(all(torch.equal(a["prompt_coords"], b["prompt_coords"]) for a, b in zip(o1, o2)),
          f"{label}: the random sampler's clicks differ under one seed")
    again = differ(torch, g1, g2)
    check(not again, f"{label}: with the random sampler two runs differ in {len(again)} grads, "
          f"the first {again[0] if again else ''}")
    print(f"{label}: {len(gg)} grads bit-equal over two runs on the card and with the ViT's "
          f"remat off (fixed sampler); with the random sampler the clicks and {len(g1)} grads "
          f"bit-equal over two runs under one seed", flush=True)


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
# csrc/fps_interp.cu: on the grid route fps_interp_kernel<0> is K8, <1> K1;
# on the cluster route fps_cluster_kernel<false, R> is K8, and <true, R>
# with nn3_kernel<false> (csrc/nn3.cuh, the 3-NN launch) K1. K9 runs K1's
# launch, then knn_bins_kernel; K10 is nn3_kernel<true>; K12 (csrc/knn.cu)
# knn_select_kernel.
FPS_STAGES = (("K1 / K9 FPS + 3-NN",
               ("fps_interp_kernel<1>", "fps_cluster_kernel<true", "nn3_kernel<false")),
              ("K8 FPS", ("fps_interp_kernel<0>", "fps_cluster_kernel<false")))
K10_STAGE = ("K10 3-NN weights", ("nn3_kernel<true",))
K12_STAGE = ("K12 kNN select", ("knn_select_kernel",))
SCATTER_STAGE = ("torch scatter / gather (scatter max, gathers)", ("scatter",))
# The train steps of all three recipes (kNN ViT-L, voronoi ViT-L and
# EVA-giant) share these stages.
TRAIN_STAGES = (("K7 pass C (mma)", ("patch_encoder_bwd_c_mma",)),
                ("K7 pass D (mma)", ("patch_encoder_bwd_d_mma",)),
                ("K7 reduce_slices", ("reduce_slices",)),
                ("K7 one launch", ("patch_encoder_bwd_kernel",)),
                ("K2 patch encoder", ("patch_encoder",)), *K6_STAGES,
                ("K3 / K5 attention", ("mha_kernel",)),
                ("K4 / K11 decode tail", ("interp_upscale",)), *FPS_STAGES, K10_STAGE,
                K12_STAGE, SCATTER_STAGE, MATMULS)
ENCODE_STAGES = (*FPS_STAGES, ("K9 kNN bins", ("knn_bins_kernel",)), K10_STAGE, K12_STAGE,
                 ("K2 patch encoder", ("patch_encoder",)),
                 ("K3 / K5 attention", ("mha_kernel",)),
                 ("torch top-k / sort (K9's bins)", ("topk", "TopK", "sort", "Sort")),
                 SCATTER_STAGE, MATMULS)
# A click: the mask encoder's K2 (refining clicks), the decoder's
# attention (cuBLAS matmuls and elementwise kernels), the tail (K4, or the
# gather and K11), and the logits' copy to the host.
CLICK_STAGES = (("K4 / K11 decode tail", ("interp_upscale",)),
                ("K2 patch encoder", ("patch_encoder",)),
                ("copy to the host", ("Memcpy DtoH",)), MATMULS)
# Stage -> the kernel wrappers (launch counters) each of whose launches
# runs at least one kernel of the stage.
STAGE_WRAPPERS = {"K1 / K9 FPS + 3-NN": ("K1", "K9"), "K8 FPS": ("K8",),
                  "K9 kNN bins": ("K9",), "K10 3-NN weights": ("K10",),
                  "K2 patch encoder": ("K2",), "K3 / K5 attention": ("K3", "K5"),
                  "K4 / K11 decode tail": ("K4", "K11"), "K12 kNN select": ("K12",)}


def profile(torch, label, fn, stages, counters=None, tries=3):
    """``fn`` under torch.profiler: device time by stage (kernel names), the
    largest other kernels, and the device's busy share of the wall time.
    With ``counters``, every launch that a stage's wrappers
    (``STAGE_WRAPPERS``) count during ``fn`` must show a kernel of that
    stage in the trace: a trace that lost one is reported and taken again,
    up to ``tries`` sessions in all, and then the check fails."""
    for attempt in range(1, tries + 1):
        torch.cuda.synchronize()
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        # ``fn`` once as a warm-up step first (traced, its records dropped):
        # after earlier sessions a session's first kernel (a train step's
        # first FPS launch) went missing behind a warm-up of one small
        # kernel, and came back behind a warm-up of ``fn`` itself.
        traced = []
        with torch.profiler.profile(
                activities=acts, schedule=torch.profiler.schedule(wait=0, warmup=1, active=1),
                on_trace_ready=lambda p: traced.extend(p.key_averages())) as prof:
            fn()
            torch.cuda.synchronize()
            before = {k: c.launches for k, c in (counters or {}).items()}
            prof.step()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
            prof.step()
        by_stage = {name: 0.0 for name, _ in stages}
        by_stage["other kernels"] = 0.0
        events = dict.fromkeys(by_stage, 0)
        others = []
        total = 0.0
        for ev in traced:
            dev_us = getattr(ev, "self_device_time_total", 0) or 0
            if getattr(ev, "device_type", None) != torch.autograd.DeviceType.CUDA or dev_us <= 0:
                continue
            # Ranges on the device's timeline (the profiler's step, the
            # optimizer's step) span kernels counted on their own.
            if getattr(ev, "is_user_annotation", False):
                continue
            total += dev_us / 1e3
            stage = next((n for n, keys in stages if any(k in ev.key for k in keys)),
                         "other kernels")
            by_stage[stage] += dev_us / 1e3
            events[stage] += ev.count
            if stage == "other kernels":  # the name, without its namespaces
                others.append((dev_us / 1e3, ev.count,
                               re.sub(r"void |at::native::|at::|\(anonymous namespace\)::", "",
                                      ev.key)[:140]))
        lost = []
        for name in by_stage:
            wrappers = STAGE_WRAPPERS.get(name, ()) if counters else ()
            launched = sum(counters[k].launches - before[k] for k in wrappers)
            if events[name] < launched:
                lost.append(f"{name}: {events[name]} kernels traced for {launched} launches")
        if not lost:
            break
        print(f"{label} profile, session {attempt} of {tries}: the trace lost launches "
              f"({'; '.join(lost)})", flush=True)
    check(not lost, f"{label} profile: the trace lost launches in {tries} sessions")
    check(total <= 1.01 * wall, f"{label} profile: {total:.3f} ms of kernels in {wall:.3f} ms")
    split = ", ".join(f"{k} {v:.3f}" for k, v in by_stage.items())
    top = "; ".join(f"{ms:.3f} ms x{n} {name}" for ms, n, name in sorted(others, reverse=True)[:8])
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


def profile_step(torch, result, cfg, seed, counters):
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
    profile(torch, "train step", step, TRAIN_STAGES, counters)
    print(f"train step on one batch: {before:.3f} ms before the profiler session, "
          f"{step_ms():.3f} ms after it (median of 4)", flush=True)


def train_run(torch, trainer, build_model, load_config, counters, config, overrides, minimum,
              absent, label, steps=5):
    """A training path: ``trainer.main`` on ``config`` with ``overrides``
    for ``steps`` steps, the launches read around it, by shape. Checked:
    the step count, finite losses, no zero grad on the first step but
    ``MAY_BE_ZERO``'s, every parameter moved from its seeded initial value
    but those of ``MAY_BE_ZERO``'s that took no gradient in any step,
    each kernel of ``minimum`` launched at least that often a step and none
    of ``absent``. Printed: the losses, the median step of steps 2 on,
    the peak device memory (and what earlier phases held when the run
    began) and the launches a step. Returns (launch shapes, the trainer's
    result, the config)."""
    run_dir = ROOT / "build" / "chip_smoke_train"
    shutil.rmtree(run_dir, ignore_errors=True)
    overrides = [*overrides, "val_freq=0", f"max_steps={steps}", f"project_dir={run_dir}",
                 "log_freq=1"]
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset(counters)
    result = trainer.main(["--config", config, *overrides])
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in counters.items()}
    shapes = {name: dict(fn.shapes) for name, fn in counters.items() if fn.shapes}
    peak = torch.cuda.max_memory_allocated()
    shutil.rmtree(run_dir, ignore_errors=True)

    hist = result["history"]
    check(result["step"] == steps and len(hist) == steps,
          f"{label}: trained {result['step']} steps")
    check(all(math.isfinite(h["loss"]) for h in hist), f"{label}: non-finite loss: {hist}")
    bad = [n for n in result["first_step_zero_grads"] if not n.startswith(MAY_BE_ZERO)]
    check(not bad, f"{label}: zero gradient on the first step: {bad}")
    cfg = load_config(config, overrides)
    init = build_model(cfg.model, device="cuda",
                       generator=torch.Generator("cuda").manual_seed(cfg.get("seed", 42))
                       ).state_dict()
    # A parameter that kept its initial value must be one of MAY_BE_ZERO's
    # that took no gradient on any step: its AdamW first moment is all 0
    # (a multimask hypernetwork that the min-loss rule picked for no mask).
    state = result["optimizer"].opt.state
    frozen, idle = [], []
    for n, p in result["model"].named_parameters():
        if torch.equal(p.detach(), init[n]):
            m = state.get(p, {}).get("exp_avg")
            untouched = m is None or not bool(m.ne(0).any())
            (idle if n.startswith(MAY_BE_ZERO) and untouched else frozen).append(n)
    del init
    check(not frozen, f"{label}: parameters did not move: {frozen[:5]}")
    per_step = {k: v / steps for k, v in launches.items()}
    for name, lo in minimum.items():
        check(per_step[name] >= lo, f"{label}: {name} launched {per_step[name]} < {lo} per step")
    ran = [name for name in absent if launches[name]]
    check(not ran, f"{label}: kernels {ran} launched off their path")
    step_ms = statistics.median(h["ms"] for h in hist[1:])
    print(f"train {label}: {steps} steps, losses {[round(h['loss'], 4) for h in hist]}, step "
          f"{step_ms:.3f} ms (median of steps 2-{steps}; first {hist[0]['ms']:.1f} ms), peak "
          f"memory {peak / 2**30:.3f} GiB ({held / 2**30:.3f} GiB held before the run), "
          f"launches per step {per_step}; took no gradient in any step: {idle or 'none'}",
          flush=True)
    return shapes, result, cfg


def train_vit_l(torch, trainer, build_model, load_config, counters, steps=5):
    """Phase 14: the training path, the ViT-L recipe through trainer.main on
    synthetic data (``train_run``). Returns each kernel's launches by shape
    over the run, and the step to profile."""
    overrides = ["train_dataset.dataset.source=synthetic", "train_dataset.dataset.num_scenes=16"]
    shapes, result, cfg = train_run(
        torch, trainer, build_model, load_config, counters, "large", overrides,
        {"K1": 1, "K2": 5, "K3": 24, "K4": 5, "K6": 24, "K7": 5, "K12": 1},
        ("K5", "K8", "K9", "K10"),
        "ViT-L (configs/large.yaml, synthetic): B=2, N=10000, M=2, G=1024, K=256, 5 click "
        "iterations, bf16 compute", steps)
    return shapes, lambda: profile_step(torch, result, cfg, cfg.get("seed", 42), counters)


def voronoi_overrides(load_config, config, steps) -> list:
    """The voronoi recipe ``config`` on the synthetic set: its mixture (a
    ``dataset_dict`` of hub datasets) replaced by configs/dataset/
    synthetic.yaml as a whole ``train_dataset`` value (JSON, which the
    overrides read as YAML), with one scene for each example of ``steps``
    batches; the recipe's B, N, M, G, click iterations, rate and schedule
    stay as they are."""
    recipe = load_config(config)
    ds = load_config("dataset/synthetic", context={"num_samples": recipe.num_samples})
    ds["dataset"]["num_scenes"] = recipe.train_dataloader["batch_size"] * steps
    return [f"train_dataset={json.dumps(ds)}"]


# Phase 14v: the voronoi recipes, (config, label, launches a step at
# least, kernels that must not launch). The ViT's blocks run forward twice
# a step (remat), so K3 / K5 launch twice a block; K4 once a decode.
VORONOI_TRAIN = (
    ("voronoi_large", "voronoi-train",
     "voronoi ViT-L (configs/voronoi_large.yaml, synthetic): B=32, N=10000, M=2, G=1024, 5 click "
     "iterations, bf16 compute, remat", {"K3": 48, "K4": 5, "K6": 24, "K8": 1, "K10": 1},
     ("K1", "K2", "K5", "K7", "K9", "K11", "K12")),
    ("voronoi_giant", "giant-train",
     "voronoi EVA-giant (configs/voronoi_giant.yaml, synthetic): B=16, N=10000, M=2, G=1024, 10 "
     "click iterations, bf16 compute, remat", {"K4": 10, "K5": 80, "K8": 1, "K10": 1},
     ("K1", "K2", "K3", "K6", "K7", "K9", "K11", "K12")),
)


def time_sampler(torch, cfg, label) -> None:
    """The click sampler (``sample_prompts``, plain torch) alone at the
    recipe ``cfg``'s batch (B clouds of N points, M masks): CUDA events,
    median of 5, for a first click (M regions) and a refining click (3M:
    false negatives, false positives, the mask), and the calls a step makes
    (every click iteration but the refinement-only ones). Its work does not
    depend on the data: [B, N, 2048] fp32 tiles of every pair."""
    from point_sam_tpu_torch.ops.sampler import sample_prompts

    B, N = cfg.train_dataloader["batch_size"], cfg.num_samples
    M = next(t["num_samples"] for t in cfg.train_dataset["transforms"]
             if t["name"] == "random_sample_mask")
    g = torch.Generator(device="cuda").manual_seed(5)
    coords = torch.randn((B, N, 3), device="cuda", generator=g)
    gt = torch.rand((B, M, N), device="cuda", generator=g) < 0.3
    logits = torch.randn((B * M, N), device="cuda", generator=g)
    first = time_ms(torch, lambda: sample_prompts(coords, gt))
    refine = time_ms(torch, lambda: sample_prompts(coords, gt, logits))
    iters = cfg.model["prompt_iters"]
    # With refinement iterations, the last and one drawn iteration add no click.
    calls = iters - min(2, iters - 1) * cfg.model.get("enable_mask_refinement_iterations", True)
    print(f"click sampler {label} (plain torch) at B={B}, N={N}, M={M}: first click "
          f"{first:.3f} ms, refining click {refine:.3f} ms; {calls} calls a step "
          f"({first + (calls - 1) * refine:.1f} ms)", flush=True)


def train_voronoi(torch, trainer, build_model, load_config, counters, steps=5) -> dict:
    """Phase 14v: both voronoi recipes through trainer.main (``train_run``)
    at their batch, each model and optimizer freed after its run, then the
    click sampler alone at its batch (``time_sampler``). Returns {path:
    each kernel's launches by shape}."""
    import gc

    shapes = {}
    for config, path, label, minimum, absent in VORONOI_TRAIN:
        shapes[path], result, cfg = train_run(
            torch, trainer, build_model, load_config, counters, config,
            voronoi_overrides(load_config, config, steps), minimum, absent, label, steps)
        del result
        gc.collect()
        torch.cuda.empty_cache()
        time_sampler(torch, cfg, path)
    return shapes


def hier_overrides(load_config) -> list:
    """configs/large.yaml's recipe (B=2, N=10,000, M=2, its rate and
    schedule) on the synthetic set, with configs/model/hier.yaml as its
    whole ``model`` value (JSON, which the overrides read as YAML)."""
    return ["train_dataset.dataset.source=synthetic", "train_dataset.dataset.num_scenes=16",
            f"model={json.dumps(load_config('model/hier'))}"]


def train_hier(torch, trainer, build_model, load_config, counters, steps=5) -> dict:
    """Phase 14h: the hier recipe through trainer.main (``train_run``): 8
    click iterations a step, 7 with a mask prompt, so K2 and K7 launch
    2 + 2 x 7 times, K4 once a decode, K3 twice a block (remat). K7 must
    launch with dx exactly at level 2 (C_in = 131: the patch embed's ->
    512 and the mask encoder's -> 256). Returns each kernel's launches by
    shape."""
    import gc

    shapes, result, _ = train_run(
        torch, trainer, build_model, load_config, counters, "large", hier_overrides(load_config),
        {"K2": 16, "K3": 48, "K4": 8, "K6": 24, "K7": 16, "K8": 1, "K10": 2, "K12": 2},
        ("K1", "K5", "K9", "K11"),
        "hier EVA02-L (configs/large.yaml, model configs/model/hier.yaml, synthetic): B=2, "
        "N=10000, M=2, G=(2048, 512), K=(32, 32), 8 click iterations, bf16 compute, remat", steps)
    del result
    gc.collect()
    torch.cuda.empty_cache()
    k7 = [dict(k) for k in shapes["K7"]]
    with_dx = {k["cout"] for k in k7 if k["cin"] == 131 and k["need_dx"]}
    check(with_dx == {256, 512} and all(k["need_dx"] == (k["cin"] == 131) for k in k7),
          f"hier-train: K7 launched with dx at {[(k['cin'], k['cout'], k['need_dx']) for k in k7]}")
    return shapes


def profile_train_steps(torch, build_model, load_config, counters, runs):
    """Phase 16: one train step of each of ``runs`` ((path, config,
    overrides)) under torch.profiler (``profile``, the ViT-L step's
    stages), on its model and optimizer built anew and one batch of its
    synthetic set, after a warm-up step."""
    import gc

    from point_sam_tpu_torch.datasets.build import BatchIterator, build_dataset
    from point_sam_tpu_torch.parallel.train_step import make_optimizer, train_step
    from point_sam_tpu_torch.train.trainer import to_device

    for path, config, overrides in runs:
        cfg = load_config(config, overrides)
        seed = cfg.get("seed", 42)
        model = build_model(cfg.model, device="cuda",
                            generator=torch.Generator("cuda").manual_seed(seed))
        tx = make_optimizer(model.parameters(), lambda step: cfg.lr)
        ds = build_dataset(cfg.train_dataset, seed=seed, context={"num_samples": cfg.num_samples})
        batch = to_device(next(iter(BatchIterator(ds, cfg.train_dataloader["batch_size"],
                                                  seed=seed))), "cuda")
        gen = torch.Generator().manual_seed(0)

        def step():
            return float(train_step(model, tx, batch, gen)["loss"])

        step()  # warm
        profile(torch, f"{path} train step", step, TRAIN_STAGES, counters)
        del model, tx, batch
        gc.collect()
        torch.cuda.empty_cache()


# Phases 12e, 12f and 12s: evaluation and the demo server.
EVAL_TINY_ARMS = (
    ("exact", {}, ("K1", "K2", "K3", "K4", "K12"), ("K8", "K9", "K10")),
    ("fps_candidates=1024", {"fps_candidates": 1024}, ("K2", "K3", "K4", "K8", "K10", "K12"),
     ("K1", "K9")),
)


def eval_tiny(torch, np, cpu_model, counters) -> None:
    """Phase 12e: ``InteractiveEvaluator.evaluate_scene`` with the tiny fp32
    model of phase 3 on the CPU (plain versions) and on the card (kernels),
    same weights, on one synthetic scene of 1500 points (bucket 2048, so
    padded; G=256, K=16 by the evaluator's rule) whose 7 instances go in
    chunks of 2 (the last one partial), 3 clicks; two arms: exact, and
    approximate FPS (K8 on a 1024-point subset, then K10). The IoUs per
    instance and click must agree to 1e-5."""
    from point_sam_tpu_torch.datasets.synthetic import generate_scene
    from point_sam_tpu_torch.evalsuite.eval_interactive import (
        InteractiveEvaluator,
        filter_masks,
        normalize_scene,
    )

    ex = generate_scene(3, num_points=1500)
    xyz, rgb = normalize_scene(ex["coords"], ex["features"])
    gt = ex["gt_masks"][filter_masks(ex["gt_masks"])]
    check(len(gt) % 2 == 1, f"eval tiny: {len(gt)} instances, no partial chunk")
    gpu_model = copy.deepcopy(cpu_model)
    for arm, kw, expect, absent in EVAL_TINY_ARMS:
        ious = {}
        for model, dev in ((cpu_model, "cpu"), (gpu_model, "cuda")):
            ev = InteractiveEvaluator(model, device=dev, num_clicks=3, point_buckets=(2048,),
                                      masks_per_batch=2, **kw)
            reset(counters)
            ious[dev] = ev.evaluate_scene(xyz, rgb, gt)
        missing = [k for k in expect if counters[k].launches == 0]
        check(not missing, f"eval tiny {arm}: kernels {missing} did not launch on the card")
        extra = [k for k in absent if counters[k].launches]
        check(not extra, f"eval tiny {arm}: kernels {extra} launched")
        check(ious["cuda"].shape == (len(gt), 3), f"eval tiny {arm}: {ious['cuda'].shape}")
        err = float(np.abs(ious["cuda"] - ious["cpu"]).max())
        check(err <= 1e-5, f"eval tiny {arm}: IoUs differ from the CPU's by {err:.3g} > 1e-5")
        print(f"eval tiny fp32, {arm}: card kernels {list(expect)} vs CPU plain, {len(gt)} "
              f"instances x 3 clicks, max |dIoU| {err:.3g}, mIoU per click "
              f"{np.round(ious['cuda'].mean(0), 4).tolist()}", flush=True)


# Phase 12f: the arms of the flagship evaluation, (path, the evaluator's
# arguments, what it is, kernels that must launch, kernels that must not).
EVAL_ARMS = (
    ("eval", {}, "exact FPS and kNN", ("K1", "K12"), ("K8", "K9", "K10")),
    ("eval-fpscand", {"fps_candidates": 32768}, "approximate FPS, 32768 candidates",
     ("K8", "K10", "K12"), ("K1", "K9")),
    ("eval-fusedgeom", {"knn_method": "approx"}, 'knn_method="approx"', ("K9",),
     ("K1", "K8", "K10", "K12")),
    ("eval-approx95", {"knn_method": "approx", "knn_recall_target": 0.95},
     'knn_method="approx", knn_recall_target=0.95 (K9\'s gate fails: K1, then K12 over 8192 '
     'bins)', ("K1", "K12"), ("K8", "K9", "K10")),
)


def eval_flagship(torch, np, model, counters, workdir) -> dict:
    """Phase 12f: 2 synthetic scenes of 100,000 points written by
    ``serving/make_assets.py``, evaluated by the bf16 ViT-L ``model`` (kNN
    tokenizer, G=2048, K=256 by the evaluator's rule, bucket 131072) with 5
    clicks and 4 masks a batch: ``evaluate_directory`` (the exact arm), then
    ``evaluate_scene`` on the same scenes in two more arms (EVAL_ARMS).
    Per arm: mIoU per click (finite, in [0, 1]), each scene's ms by CUDA
    events and the share of it in the click sampler (``sample_prompts``,
    CUDA events around each call), peak memory, and the launches (each
    scene's encode: K1 / K8 + K10 / K9 once, K3 24 times; K2 once an encode
    and once a refining click of each chunk; K4 once a click of each
    chunk). A short warm-up (2 clicks of the first scene) goes first.
    Returns each arm's launches by shape, keyed by its path."""
    from point_sam_tpu_torch.evalsuite import eval_interactive as EI
    from point_sam_tpu_torch.serving import make_assets
    from point_sam_tpu_torch.utils.ply import load_ply

    make_assets.main(["--out", str(workdir), "--num", "2", "--points", str(N_FLAGSHIP)])
    scenes = []
    for path in sorted(workdir.glob("*.ply")):
        xyz, rgb = load_ply(path)
        gt = np.load(path.with_suffix(".masks.npy"))
        scenes.append((path.name, *EI.normalize_scene(xyz, rgb), gt[EI.filter_masks(gt)]))
    chunks = sum(-(-len(s[3]) // 4) for s in scenes)
    clicks = 5
    EI.InteractiveEvaluator(model, device="cuda", num_clicks=2).evaluate_scene(*scenes[0][1:])

    # Each scene's and each sampler call's CUDA events, read after the arm.
    spans = {"scene": [], "sampler": []}
    real_scene, real_sampler = EI.InteractiveEvaluator.evaluate_scene, EI.sample_prompts

    def timed(fn, name):
        def run(*args, **kw):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            out = fn(*args, **kw)
            end.record()
            spans[name].append((start, end))
            return out
        return run

    EI.InteractiveEvaluator.evaluate_scene = timed(real_scene, "scene")
    EI.sample_prompts = timed(real_sampler, "sampler")
    shapes_by_path = {}
    try:
        for path, kw, what, present, absent in EVAL_ARMS:
            for spans_of in spans.values():
                spans_of.clear()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset(counters)
            if path == "eval":
                report = EI.evaluate_directory(model, workdir, device="cuda", num_clicks=clicks,
                                               masks_per_batch=4, **kw)
                check(report["num_instances"] == sum(len(s[3]) for s in scenes),
                      f"{path}: {report['num_instances']} instances")
                miou = [report["mean_iou_per_click"][k + 1] for k in range(clicks)]
            else:
                ev = EI.InteractiveEvaluator(model, device="cuda", num_clicks=clicks,
                                             masks_per_batch=4, **kw)
                ious = np.concatenate([ev.evaluate_scene(*s[1:]) for s in scenes])
                check(ious.shape == (sum(len(s[3]) for s in scenes), clicks),
                      f"{path}: IoUs {ious.shape}")
                miou = ious.mean(0).tolist()
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated()
            launches = {name: fn.launches for name, fn in counters.items()}
            shapes_by_path[path] = {name: dict(fn.shapes) for name, fn in counters.items()
                                    if fn.shapes}
            check(all(np.isfinite(m) and 0.0 <= m <= 1.0 for m in miou),
                  f"{path}: mIoU per click {miou}")
            want = {"K2": len(scenes) + (clicks - 1) * chunks, "K3": 24 * len(scenes),
                    "K4": clicks * chunks, **{k: len(scenes) for k in present}}
            for name, n in want.items():
                check(launches[name] == n, f"{path}: {name} launched {launches[name]}, not {n}")
            extra = [k for k in absent if launches[k]]
            check(not extra, f"{path}: kernels {extra} launched")
            scene_ms = [s.elapsed_time(e) for s, e in spans["scene"]]
            sampler_ms = sum(s.elapsed_time(e) for s, e in spans["sampler"])
            check(len(scene_ms) == len(scenes), f"{path}: {len(scene_ms)} scenes timed")
            print(f"eval {path} ({what}), ViT-L bf16, {len(scenes)} scenes of {N_FLAGSHIP} "
                  f"points (bucket 131072), {clicks} clicks, 4 masks a batch, "
                  f"{sum(len(s[3]) for s in scenes)} instances in {chunks} chunks: mIoU per "
                  f"click {[round(m, 4) for m in miou]}; ms per scene "
                  f"{[round(m, 3) for m in scene_ms]}; click sampler {sampler_ms:.3f} ms "
                  f"({len(spans['sampler'])} calls, {sampler_ms / sum(scene_ms):.1%} of the "
                  f"scenes' time); peak memory {peak / 2**30:.3f} GiB; launches {launches}",
                  flush=True)
    finally:
        EI.InteractiveEvaluator.evaluate_scene, EI.sample_prompts = real_scene, real_sampler
    return shapes_by_path


def serve_http(torch, np, model, counters, workdir) -> None:
    """Phase 12s: ``build_server`` over the bf16 ViT-L ``model`` on
    127.0.0.1, port 0, in a thread; over HTTP: GET /pointcloud of the first
    100,000-point asset of 12f, three POST /segment (positive, negative,
    positive), /next and /save. Each seg has N entries and equals, bit for
    bit, the mask of ``Predictor.click`` on the same normalised cloud and
    clicks; the launches of each request are read around it (the encode:
    K1 1, K2 1, K3 24, K12 1; a click: K4 1, and K2 1 on a refining click); each
    request's wall ms printed. The server is shut down and its thread
    joined."""
    import threading
    import urllib.request

    from point_sam_tpu_torch.serving.server import build_server

    httpd, session = build_server(model, device="cuda", port=0, model_dir=workdir,
                                  output_dir=workdir / "out")
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    name = sorted(workdir.glob("*.ply"))[0].name
    timings = []
    try:
        def request(label, path, payload=None, **want):
            """One GET (no payload) or POST over HTTP: its JSON, its wall ms
            and its launches."""
            data = None if payload is None else json.dumps(payload).encode()
            req = urllib.request.Request(url + path, data=data,
                                         headers={"Content-Type": "application/json"})
            reset(counters)
            t0 = time.perf_counter()
            with urllib.request.urlopen(req, timeout=300) as r:
                body = json.loads(r.read())
            ms = (time.perf_counter() - t0) * 1e3
            launches = {k: fn.launches for k, fn in counters.items() if fn.launches}
            check(launches == want, f"server {label}: launches {launches}, not {want}")
            timings.append(f"{label} {ms:.1f} ms")
            return body

        cloud = request(f"GET /pointcloud/{name}", f"/pointcloud/{name}", K1=1, K2=1, K3=24,
                        K12=1)
        xyz = np.asarray(cloud["xyz"], np.float32).reshape(-1, 3)
        rgb = np.asarray(cloud["rgb"], np.float32).reshape(-1, 3)
        check(xyz.shape == rgb.shape == (N_FLAGSHIP, 3), f"server: cloud {xyz.shape}")
        check(float(rgb.min()) >= 0.0 and float(rgb.max()) <= 1.0, "server: rgb not in [0, 1]")
        segs, points, labels = [], [], []
        for i, (idx, label) in enumerate(((10, 1), (700, 0), (500, 1))):
            points.append(xyz[idx].tolist())
            labels.append(label)
            out = request(f"POST /segment {i + 1}", "/segment",
                          {"prompt_point": points[-1], "prompt_label": label},
                          K4=1, **({"K2": 1} if i else {}))
            seg = np.asarray(out["seg"])
            check(seg.shape == (N_FLAGSHIP,) and seg.dtype == bool, f"server: seg {seg.shape}")
            segs.append(seg)
        nxt = request("POST /next", "/next", {})
        check(nxt == {"status": "cleared", "num_instances": 1}, f"server: /next {nxt}")
        saved = request("POST /save", "/save", {})
        check(saved["status"] == "saved", f"server: /save {saved}")
        mask = np.load(saved["path"], allow_pickle=True).item()["mask"]
        check(mask.shape == (1, N_FLAGSHIP) and np.array_equal(mask[0], segs[-1]),
              "server: the saved instance is not the last seg")
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=60)
    check(not thread.is_alive(), "server: the serving thread did not stop")

    # The same cloud and clicks through the session's Predictor directly.
    pred = session.predictor
    pred.set_pointcloud(xyz, rgb)
    prev = None
    for i, seg in enumerate(segs):
        want, prev = pred.click(np.asarray(points[:i + 1], np.float32), labels[:i + 1], prev)
        check(np.array_equal(seg, want), f"server: seg {i + 1} differs from Predictor.click")
    print(f"server ViT-L bf16 over HTTP, {name} ({N_FLAGSHIP} points): segs equal "
          f"Predictor.click bit for bit ({[int(s.sum()) for s in segs]} points in each); "
          f"wall {'; '.join(timings)}", flush=True)


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
                "K11": UP.upscale_hyper_cuda, "K12": K.knn_select_cuda}
    dev = torch.device("cuda")

    tiny = P.PointCloudSAM(P.PointSAMConfig(vit=P.ViTConfig(**TINY_VIT),
                                            tokenizer=P.TokenizerConfig(128, 16)),
                           generator=torch.Generator().manual_seed(0)).eval()
    end_to_end_tiny(torch, np, tiny, "e2e tiny", counters, ("K1", "K2", "K3", "K4", "K12"))

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
                         {"K1": 1, "K2": 2, "K3": 24, "K4": 3, "K12": 1}, absent=("K9",))
    rows = check_kernels(torch, np, mods, serve_shapes, "serve")
    torch.cuda.empty_cache()
    attention_edges(torch, A)
    patch_encoder_edges(torch, PE)

    tiny_nn = P.PointCloudSAMNN(P.VoronoiConfig(vit=P.ViTConfig(**TINY_GIANT_VIT), num_patches=32),
                                generator=torch.Generator().manual_seed(0)).eval()
    end_to_end_tiny(torch, np, tiny_nn, "e2e tiny voronoi", counters, ("K5", "K8", "K10", "K11"))
    voronoi = serve(torch, np, Predictor(giant()), counters, "voronoi EVA-giant",
                    {"K4": 3, "K5": 40, "K8": 1, "K10": 1}, group=(2048, None),
                    absent=("K12",))
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
                    ("K2", "K3", "K4", "K8", "K10", "K12"))
    end_to_end_tiny(torch, np, tiny_hier, "e2e tiny hier, group_number=64", counters,
                    ("K2", "K3", "K8", "K10", "K11", "K12"), group_number=64)
    pred = Predictor(hier())
    hier_shapes = serve(torch, np, pred, counters, "hier EVA02-L",
                        {"K2": 2, "K3": 24, "K4": 3, "K8": 1, "K10": 2, "K12": 2},
                        group=((2048, 512), (32, 32)), tokens=512, absent=("K11",))
    hier_big = serve(torch, np, pred, counters, "hier EVA02-L, group_number=4096",
                     {"K2": 2, "K3": 24, "K8": 1, "K10": 2, "K11": 3, "K12": 2},
                     group=((4096, 512), (32, 32)), tokens=512, absent=("K4",),
                     group_number=4096)
    tail_routes(torch, UP, pred, counters)
    tail_digest(torch, UP)
    del pred
    torch.cuda.empty_cache()
    rows += check_kernels(torch, np, mods, hier_shapes, "hier")
    rows += check_kernels(torch, np, mods, hier_big, "hier4096")

    # The fused-geometry path: the ViT-L of phase 4 with knn_method="approx".
    fused = serve(torch, np, Predictor(vit_l("approx")), counters, "fused-geometry ViT-L",
                  {"K2": 2, "K3": 24, "K4": 3, "K9": 1}, absent=("K1", "K12"))
    k9 = sum(fused["K9"].values())
    check(k9 == 1, f"fused-geometry ViT-L: K9 launched {k9} times in one encode")
    torch.cuda.empty_cache()
    rows += check_kernels(torch, np, mods, fused, "fusedgeom")
    # Phase 12k: K12 alone at the paths' shapes, both modes, ties, invalid keys.
    rows += check_kernels(torch, np, mods, {"K12": {tuple(c.items()): 0 for c in K12_CASES}},
                          "knn")

    # Evaluation and the demo server: the tiny evaluator on the card against
    # the CPU, the flagship evaluation in three arms, then the HTTP server.
    eval_tiny(torch, np, tiny, counters)
    workdir = ROOT / "build" / "chip_smoke_eval"
    shutil.rmtree(workdir, ignore_errors=True)
    try:
        evals = eval_flagship(torch, np, vit_l(), counters, workdir)
        torch.cuda.empty_cache()
        for path, shapes in evals.items():
            rows += check_kernels(torch, np, mods, shapes, path)
        serve_http(torch, np, vit_l(), counters, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    torch.cuda.empty_cache()

    train_step_tiny(torch, np, P, PS, criterion, counters)
    train_step_tiny_voronoi(torch, np, P, PS, criterion, counters)
    train_step_tiny_hier(torch, np, P, PS, criterion, counters)
    train, train_profile = train_vit_l(torch, trainer, build_model, load_config, counters)
    torch.cuda.empty_cache()
    rows += check_kernels(torch, np, mods, train, "train")
    check({r["kernel"] for r in rows} == set(counters), "a kernel was checked on no path")
    pe_train_repeats(torch, PE)
    patch_encoder_bwd_edges(torch, PE)
    attention_bwd_edges(torch, A)
    for path, shapes in train_voronoi(torch, trainer, build_model, load_config,
                                      counters).items():
        rows += check_kernels(torch, np, mods, shapes, path)
    hier_train = train_hier(torch, trainer, build_model, load_config, counters)
    rows += check_kernels(torch, np, mods, hier_train, "hier-train")

    train_profile()
    del train_profile  # the ViT-L model and optimizer
    torch.cuda.empty_cache()
    profile_train_steps(torch, build_model, load_config, counters,
                        [(path, config, voronoi_overrides(load_config, config, 1))
                         for config, path, *_ in VORONOI_TRAIN]
                        + [("hier-train", "large", hier_overrides(load_config))])
    profile_encode(torch, np, vit_l(), "flagship ViT-L", counters, with_clicks=True)
    profile_encode(torch, np, giant(), "voronoi EVA-giant", counters)
    profile_encode(torch, np, hier(), "hier EVA02-L", counters)
    profile_encode(torch, np, hier(), "hier EVA02-L, group_number=4096", counters,
                   group_number=4096)
    profile_encode(torch, np, vit_l("approx"), "fused-geometry ViT-L", counters)
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
        # Not a pallas_call: lax.approx_min_k (and lax.top_k at :32, :284).
        "K12": ("knn_select", "knn.cu", "point_sam_tpu/ops/knn.py:161"),
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
                      "ms_reduce", "fps_route", "us_per_step", "tail_route", "other_route",
                      "ms_other_route", "device_ms_other_route", "us_per_step_other_route",
                      "device_ms", "ms_bins", "device_ms_bins", "bound_ms_bins", "ms_top_k",
                      "device_ms_top_k", "recall"):
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
