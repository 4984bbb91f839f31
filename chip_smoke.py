#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (point_sam_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each fatal on failure (the script then exits non-zero before its
last line):

1. header: the card's name and power limit (nvidia-smi), torch, CUDA, nvcc;
2. build: compile the six kernels from point_sam_tpu_torch/csrc;
3. end to end, tiny config, fp32: the Predictor on the CPU (plain
   versions) and on the card (kernels), same weights, cloud and 3 clicks;
4. the serving path: ViT-L (eva02_large) in bf16 with seeded random
   weights, a seeded 100k-point cloud (bucket 131072, G=2048, K=256),
   set_pointcloud and 3 clicks, with every kernel's launches read around
   that run, by shape (each wrapper tallies its launches by the sizes and
   dtypes it was called with);
5. each kernel of the serving path against its plain torch version at
   every shape and dtype that path launched it with, on seeded inputs, both
   timed with CUDA events (median after a warm-up), with the one PyTorch
   call of the same function as a yardstick where there is one (SDPA for
   K3; the port never calls it);
6. tiny train step in fp32: the CPU with the plain versions against the
   card with the kernels, same weights, batch and clicks;
7. the training path: ViT-L through ``trainer.main`` with the reference
   recipe (configs/large.yaml on synthetic data: B=2, N=10,000, M=2,
   G=1024, K=256, 5 click iterations, bf16 compute, fp32 AdamW), 5 steps,
   with the launches read around that run, by shape;
8. as 5, for every kernel of the training path (K1-K4 forward, K6 and K7
   backward; SDPA's backward is K6's yardstick).

Every kernel's bound (bound_ms) is computed here from this run's shapes:
the larger of bytes / 3.35 TB/s and the operations over the card's peak
for their type (989 TFLOP/s bf16 tensor, 67 TFLOP/s fp32), H100 SXM data
sheet figures at 700 W.

The kernels' JSON record has one row per kernel, path and launch shape.
The second-to-last lines are that record and the nvidia-smi
line; the last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import copy
import json
import math
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


def pe_work(rows, groups, cin, h0, h1, cout, elem):
    """(bytes, bf16 FLOPs) of one K2 forward over ``rows`` grouped points."""
    w = cin * h0 + h0 * h0 + 2 * h0 * h1 + h1 * cout
    flops = 2 * rows * (cin * h0 + h0 * h0 + h0 * h1 + h1 * cout) + 2 * groups * h0 * h1
    return rows * cin * elem + w * elem + groups * cout * elem, flops


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


def kernel_case(torch, np, mods, name: str, key: dict, g):
    """Kernel ``name`` at one launch key of its wrapper (the sizes and dtypes
    its ``count_launch`` recorded): seeded inputs on the card, the kernel
    and plain calls, how to compare them, the work for the bound, and the
    one PyTorch call of the same function where there is one."""
    F, PE, A, UP = mods
    dev = torch.device("cuda")
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def randn(*shape, scale=1.0):
        return torch.randn(shape, device=dev, generator=g) * scale

    def dtype(field):
        dt = getattr(torch, key[field].rsplit(".", 1)[-1])
        return dt, dt.itemsize, "bf16" if dt == torch.bfloat16 else "fp32"

    def pe_params(cin, h0, h1, cout):
        def mat(i, o):
            return randn(i, o, scale=i ** -0.5)

        def vec(d, mean=0.0):
            return mean + randn(d, scale=0.1)

        return (mat(cin, h0), vec(h0), vec(h0, 1.0), vec(h0), mat(h0, h0), vec(h0),
                mat(2 * h0, h1), vec(h1), vec(h1, 1.0), vec(h1), mat(h1, cout), vec(cout))

    if name == "K1":
        B, N, G = key["B"], key["N"], key["G"]
        n_real = min(N, N_FLAGSHIP) if key["valid"] else N
        pts = torch.zeros((B, N, 3), device=dev)
        for b in range(B):
            xyz, _ = synthetic_cloud(np.random.default_rng(b), n_real)
            pts[b, :n_real] = torch.from_numpy(xyz).to(dev)
        valid = None
        if key["valid"]:
            valid = torch.zeros((B, N), dtype=torch.bool, device=dev)
            valid[:, :n_real] = True

        def exact(got, want):
            for field, a, b_ in zip(("idx", "centers", "interp_idx", "interp_d2"), got, want):
                check(torch.equal(a, b_), f"K1 {field} differs from its plain version")
            return 0.0

        # ~10 fp32 operations per point per selection step (distance, min,
        # the running argmax and best-3); the G sequential steps each end
        # in a grid-wide sync, a latency floor the roofline does not see.
        nbytes = B * (N * (3 * 4 + (valid is not None)) + G * 16 + N * 3 * 8)
        return dict(run=lambda: F.fps_interp_cuda(pts, G, valid=valid),
                    plain=lambda: F.fps_interp_plain(pts, G, valid=valid), compare=exact,
                    work=(nbytes, {"fp32": 10.0 * B * N * G}))

    if name in ("K2", "K7"):
        B, G, K, cin, h0, h1, cout = (key[f] for f in ("B", "G", "K", "cin", "h0", "h1", "cout"))
        cdt, elem, kind = dtype("cdt")
        params = pe_params(cin, h0, h1, cout)
        x = randn(B, G * K, cin).to(cdt)
        kw = dict(num_groups=G, group_size=K, cdt=cdt, act=key["act"])
        rows = B * G * K
        nbytes, flops = pe_work(rows, B * G, cin, h0, h1, cout, elem)
        if name == "K2":
            return dict(run=lambda: PE.patch_encoder_cuda(x, params, **kw),
                        plain=lambda: PE.patch_encoder_plain(x, params, **kw),
                        compare=within("K2", 2e-2), work=(nbytes, {kind: flops}))
        need_dx = key["need_dx"]
        dout = randn(B, G, cout).to(cdt)

        # In bf16 a 1-ulp difference in a recomputed activation can move a
        # max-pool's first argmax to another row (and that column's grad
        # with it), so the grads are held in norm: ||diff|| <= 5e-2 ||plain||.
        def in_norm(got, want):
            pairs = list(zip(got[1], want[1])) + ([(got[0], want[0])] if need_dx else [])
            err = 0.0
            for i, (a, w) in enumerate(pairs):
                diff = (a - w).float()
                rel = (diff.norm() / w.float().norm().clamp_min(1e-30)).item()
                check(rel <= 5e-2, f"K7 grad {i}: norm err {rel:.3g} > 5e-2")
                err = max(err, diff.abs().max().item())
            return err

        # The forward recompute plus the backward's products over every row
        # (da3 w2x^T, a2^T da3, da2 w1b^T, g1^T da2, x^T da1, and da1 w1a^T
        # for dx); the final Dense's backward touches only the pooled rows.
        bwd = 2.0 * rows * (2 * h0 * h1 + 2 * h0 * h0 + (1 + need_dx) * cin * h0)
        nparam = sum(p.numel() for p in params)
        nbytes += B * G * cout * elem + nparam * 4 + need_dx * rows * cin * elem
        return dict(
            run=lambda: PE.patch_encoder_bwd_cuda(x, params, dout, need_dx=need_dx, **kw),
            plain=lambda: PE.patch_encoder_bwd_plain(x, params, dout, **kw),
            compare=in_norm, work=(nbytes, {kind: flops + bwd}))

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
        # q k^T and do v^T have bf16-exact operands; p^T do, ds k and ds^T q
        # are fp32 products.
        ops = {"bf16": 2 * product, "fp32": 3 * product} if kind == "bf16" else {"fp32": 5 * product}
        return dict(run=lambda: A.mha_packed_bwd_cuda(q, k, v, do, H),
                    plain=lambda: A.mha_packed_bwd_plain(q, k, v, do, H), compare=each_grad,
                    work=(7 * B * S * D * elem, ops),
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
    raise ValueError(name)


def check_kernels(torch, np, mods, shapes_by_kernel: dict, path: str) -> list:
    """Each kernel a path launched, against its plain version at every
    shape and dtype the path gave it: one row per launch key, with the
    path's launches at that key, the error, the kernel's, plain and library
    times (CUDA events, median) and the bound."""
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
            row["bound_ms"], row["bound_by"] = bound(*case["work"])
            del case
            torch.cuda.empty_cache()
            lib = "" if row["library_ms"] is None else f"  library {row['library_ms']:.4f} ms"
            print(f"kernel {name} {path} {key}: {row['launches']} launches, max_abs_err "
                  f"{err:.6g}  kernel {row['ms']:.4f} ms  plain {row['plain_ms']:.4f} ms{lib}  "
                  f"bound {row['bound_ms']:.4f} ms ({row['bound_by']})", flush=True)
            rows.append(row)
    return rows

def clicks(pred, xyz):
    """3 clicks: one positive point without a mask prompt, then adding a
    negative and a positive point with the previous best logits as mask."""
    out = [pred.predict_masks(xyz[10:11], [1])]
    prev = out[-1][2][0, int(out[-1][1][0].argmax())]
    for pts, labels in ((xyz[[10, 700]], [1, 0]), (xyz[[10, 700, 500]], [1, 0, 1])):
        out.append(pred.predict_masks(pts, labels, prev, False))
        prev = out[-1][2][0, 0]
    return out


def end_to_end_tiny(torch, np, P, Predictor, device="cuda"):
    """Phase 3: the tiny config in fp32 on the CPU (plain) and the card."""
    cfg = P.PointSAMConfig(vit="tiny", tokenizer=P.TokenizerConfig(32, 16))
    cpu_model = P.PointCloudSAM(cfg, generator=torch.Generator().manual_seed(0)).eval()
    gpu_model = copy.deepcopy(cpu_model).to(device)
    rng = np.random.default_rng(0)
    xyz = rng.standard_normal((1200, 3)).astype(np.float32)
    xyz /= np.abs(xyz).max() + 1e-3
    rgb = rng.random((1200, 3)).astype(np.float32)
    results = []
    for model, dev in ((cpu_model, "cpu"), (gpu_model, device)):
        pred = Predictor(model, device=dev, point_buckets=(2048,))
        pred.set_pointcloud(xyz, rgb)
        results.append(clicks(pred, xyz))
    worst = 0.0
    for (wm, ws, wl), (gm, gs, gl) in zip(*results):
        check(gl.shape == wl.shape and np.isfinite(gl).all(), "tiny e2e: bad logits")
        dl = float(np.abs(gl - wl).max())
        worst = max(worst, dl)
        check(dl <= 1e-3, f"tiny e2e: logits differ by {dl:.3g} > 1e-3")
        check(float(np.abs(gs - ws).max()) <= 1e-4, "tiny e2e: scores differ > 1e-4")
        sure = np.abs(wl) >= 1e-3
        check(np.array_equal(gm[sure], wm[sure]), "tiny e2e: masks differ")
    print(f"e2e tiny fp32: card kernels vs CPU plain, 3 clicks, max |dlogit| {worst:.3g}")


def flagship(torch, np, P, Predictor, counters):
    """Phase 4: the serving path, ViT-L bf16 Predictor over a 100k-point
    cloud. Returns each kernel's launches by shape in the counted run."""
    dev = torch.device("cuda")
    model = P.PointCloudSAM(P.PointSAMConfig(vit="eva02_large"), dtype=torch.bfloat16,
                            device=dev, generator=torch.Generator(device=dev).manual_seed(0))
    pred = Predictor(model)
    xyz, rgb = synthetic_cloud(np.random.default_rng(0), N_FLAGSHIP)

    pred.set_pointcloud(xyz, rgb)  # warm-up: cuBLAS handles, allocator
    clicks(pred, xyz)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    reset(counters)
    pred.set_pointcloud(xyz, rgb)
    out = clicks(pred, xyz)
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in counters.items()}
    shapes = {name: dict(fn.shapes) for name, fn in counters.items() if fn.shapes}
    peak = torch.cuda.max_memory_allocated()

    check(pred._state["group"] == (2048, 256), f"G/K rule gave {pred._state['group']}")
    check(pred._state["n_pad"] == 131072, "bucket is not 131072")
    for i, (m, s, lg) in enumerate(out):
        c = 3 if i == 0 else 1
        check(m.shape == (1, c, N_FLAGSHIP) and lg.shape == (1, c, N_FLAGSHIP),
              f"click {i}: shape {lg.shape}")
        check(s.shape == (1, c) and np.isfinite(s).all(), f"click {i}: bad scores")
        check(np.isfinite(lg).all(), f"click {i}: non-finite logits")
    minimum = {"K1": 1, "K2": 2, "K3": 24, "K4": 3}
    for name, lo in minimum.items():
        check(launches[name] >= lo, f"{name} launched {launches[name]} < {lo} times")

    enc_ms = time_ms(torch, lambda: pred.set_pointcloud(xyz, rgb))
    first = lambda: pred.predict_masks(xyz[10:11], [1])  # noqa: E731
    prev = out[0][2][0, 0]
    masked = lambda: pred.predict_masks(xyz[[10, 700]], [1, 0], prev, False)  # noqa: E731
    dec_ms = time_ms(torch, first)
    dec_mask_ms = time_ms(torch, masked)
    print(f"flagship ViT-L bf16, N={N_FLAGSHIP} (bucket 131072), G=2048, K=256: "
          f"encode {enc_ms:.3f} ms, decode {dec_ms:.3f} ms/click (no mask prompt), "
          f"{dec_mask_ms:.3f} ms/click (mask prompt), peak memory "
          f"{peak / 2**30:.3f} GiB, launches {launches}", flush=True)
    return shapes


def train_step_tiny(torch, np, P, PS, criterion):
    """Phase 6: one tiny fp32 train step, the CPU's plain versions against
    the card's kernels, same weights, batch and clicks. Tolerances: loss
    1e-4 relative; each grad 1e-4 of its largest entry + 1e-6, the two
    PointNets' 5e-3 (the card sums in another order, and a max-pool
    near-tie within that fp32 noise moves a column's grad to another row)."""
    cfg = P.PointSAMConfig(vit="tiny", tokenizer=P.TokenizerConfig(32, 16), prompt_iters=3,
                           enable_mask_refinement_iterations=False)
    cpu_model = P.PointCloudSAM(cfg, generator=torch.Generator().manual_seed(0))
    gpu_model = copy.deepcopy(cpu_model).to("cuda")
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
    results = []
    for model, dev in ((cpu_model, "cpu"), (gpu_model, "cuda")):
        tb = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
        with torch.no_grad():
            outs = model(tb["coords"], tb["features"], tb["gt_masks"])
        opt = PS.make_optimizer(model.parameters(), lambda step: 0.0, weight_decay=0.0,
                                max_grad_value=float("inf"))
        metrics = PS.train_step(model, opt, tb, torch.Generator().manual_seed(0),
                                criterion=criterion)
        grads = {n: p.grad.detach().cpu() for n, p in model.named_parameters()
                 if p.grad is not None}
        results.append((outs, float(metrics["loss"]), grads))
    (co, cl, cg), (go, gl, gg) = results
    for c_, g_ in zip(co, go):
        check(torch.equal(c_["prompt_coords"], g_["prompt_coords"].cpu()),
              "tiny train step: the clicks differ")
    check(abs(gl - cl) <= 1e-4 * abs(cl), f"tiny train step: loss {gl} vs {cl}")
    check(set(cg) == set(gg), "tiny train step: grads of different parameters")
    worst = 0.0
    for n in cg:
        rel = 5e-3 if ".patch_encoder." in n else 1e-4
        err = (gg[n] - cg[n]).abs().max().item()
        scale = cg[n].abs().max().item()
        check(err <= rel * scale + 1e-6, f"tiny train step: grad {n} err {err:.3g} of {scale:.3g}")
        worst = max(worst, err / (rel * scale + 1e-6))
    print(f"train step tiny fp32: card kernels vs CPU plain, loss {gl:.6f} vs {cl:.6f}, "
          f"{len(cg)} grads, worst error {worst:.3g} of its tolerance", flush=True)


# Parameters whose gradient may be zero on a step for reasons of the data:
# the multimask hypernetworks the min-loss rule did not pick, and the
# negative-click embedding when no negative click was sampled.
MAY_BE_ZERO = ("mask_decoder.output_hypernetworks_mlps.1.", "mask_decoder.output_hypernetworks_mlps.2.",
               "mask_decoder.output_hypernetworks_mlps.3.", "point_encoder.point_embeddings.0.")


# Kernel name fragments -> stage of the train step, for the profile.
STAGES = (("K7 patch encoder bwd", ("patch_encoder_bwd", "reduce_slices")),
          ("K2 patch encoder", ("patch_encoder",)), ("K6 attention bwd", ("attn_bwd",)),
          ("K3 attention", ("mha_kernel",)), ("K4 decode tail", ("interp_upscale",)),
          ("K1 FPS + 3-NN", ("fps_interp",)),
          ("matmuls (cuBLAS)", ("gemm", "sm90_", "cutlass", "xmma", "nvjet")))


def profile_step(torch, result, cfg, seed):
    """One more ViT-L train step under torch.profiler: device time by stage
    (kernel names), and the device's busy share of the step's wall time."""
    from point_sam_tpu_torch.datasets.build import BatchIterator, build_dataset
    from point_sam_tpu_torch.parallel.train_step import train_step
    from point_sam_tpu_torch.train.trainer import to_device

    ds = build_dataset(cfg.train_dataset, seed=seed, context={"num_samples": cfg.num_samples})
    batch = to_device(next(iter(BatchIterator(ds, 2, seed=seed))), "cuda")
    gen = torch.Generator().manual_seed(0)
    train_step(result["model"], result["optimizer"], batch, gen)  # warm
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        train_step(result["model"], result["optimizer"], batch, gen)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    by_stage = {name: 0.0 for name, _ in STAGES}
    by_stage["other kernels"] = 0.0
    others = []
    total = 0.0
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total", 0) or 0
        if getattr(ev, "device_type", None) != torch.autograd.DeviceType.CUDA or dev_us <= 0:
            continue
        total += dev_us / 1e3
        stage = next((n for n, keys in STAGES if any(k in ev.key for k in keys)), "other kernels")
        by_stage[stage] += dev_us / 1e3
        if stage == "other kernels":
            others.append((dev_us / 1e3, ev.count, ev.key[:60]))
    split = ", ".join(f"{k} {v:.3f}" for k, v in by_stage.items())
    top = "; ".join(f"{ms:.3f} ms x{n} {name}" for ms, n, name in sorted(others, reverse=True)[:6])
    print(f"train step profile (ms of device time): {split}; total {total:.3f} ms over "
          f"{wall:.3f} ms wall under the profiler (device busy {100 * total / wall:.1f}%); "
          f"largest other kernels: {top}", flush=True)


def train_vit_l(torch, trainer, build_model, load_config, counters, steps=5):
    """Phase 7: the training path, the ViT-L recipe through trainer.main on
    synthetic data. Returns each kernel's launches by shape over the run."""
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
    profile_step(torch, result, cfg, seed)
    print(f"train ViT-L (configs/large.yaml, synthetic): B=2, N=10000, M=2, G=1024, K=256, "
          f"5 click iterations, bf16 compute: {steps} steps, losses "
          f"{[round(h['loss'], 4) for h in hist]}, step {step_ms:.3f} ms (median of steps "
          f"2-{steps}; first {hist[0]['ms']:.1f} ms), peak memory {peak / 2**30:.3f} GiB, "
          f"launches per step {per_step}", flush=True)
    return shapes


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

    mods = [importlib.import_module(f"point_sam_tpu_torch.ops.{m}")
            for m in ("fps", "patch_encoder_pallas", "attention", "upscale_pallas")]
    F, PE, A, UP = mods
    counters = {"K1": F.fps_interp_cuda, "K2": PE.patch_encoder_cuda, "K3": A.mha_cuda,
                "K4": UP.interp_upscale_cuda, "K6": A.mha_packed_bwd_cuda,
                "K7": PE.patch_encoder_bwd_cuda}
    end_to_end_tiny(torch, np, P, Predictor)
    serve = flagship(torch, np, P, Predictor, counters)
    rows = check_kernels(torch, np, mods, serve, "serve")
    train_step_tiny(torch, np, P, PS, criterion)
    train = train_vit_l(torch, trainer, build_model, load_config, counters)
    torch.cuda.empty_cache()
    rows += check_kernels(torch, np, mods, train, "train")
    check({r["kernel"] for r in rows} == set(counters), "a kernel was checked on no path")

    meta = {
        "K1": ("fps_interp", "fps_interp.cu", "point_sam_tpu/ops/fps_pallas.py:138"),
        "K2": ("patch_encoder", "patch_encoder.cu",
               "point_sam_tpu/ops/patch_encoder_pallas.py:135"),
        "K3": ("attention", "attention.cu", "point_sam_tpu/ops/attention.py:178"),
        "K4": ("interp_upscale", "upscale.cu", "point_sam_tpu/ops/upscale_pallas.py:177"),
        "K6": ("attention_bwd", "attention_bwd.cu", "point_sam_tpu/ops/attention.py:327"),
        "K7": ("patch_encoder_bwd", "patch_encoder_bwd.cu",
               "point_sam_tpu/ops/patch_encoder_pallas.py:484"),
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
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
