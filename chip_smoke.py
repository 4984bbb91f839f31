#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (point_sam_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each fatal on failure (the script then exits non-zero before its
last line):

1. header: the card's name and power limit (nvidia-smi), torch, CUDA, nvcc;
2. build: compile the four kernels from point_sam_tpu_torch/csrc;
3. per-kernel check at the flagship shapes (bf16, K1 fp32): each kernel
   against its plain torch version on the same inputs, both timed with CUDA
   events (median of 5 after a warm-up);
4. end to end, tiny config, fp32: the Predictor on the CPU (plain
   versions) and on the card (kernels), same weights, cloud and 3 clicks;
5. flagship slice: ViT-L (eva02_large) in bf16 with seeded random weights,
   a seeded 100k-point cloud (bucket 131072, G=2048, K=256), set_pointcloud
   and 3 clicks, with every kernel's launch count read around that run.

The second-to-last lines are the kernels' JSON record and the nvidia-smi
line; the last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import copy
import json
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
N_FLAGSHIP = 100_000


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


def kernel_checks(torch, np, ops_mods):
    """Phase 3: each kernel against its plain version at flagship shapes."""
    F, PE, A, UP = ops_mods
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)
    rows = {}

    def rel_err(got, want):
        err = (got.float() - want.float()).abs().max().item()
        scale = want.float().abs().max().item()
        return err, err / max(scale, 1e-30)

    # K1: FPS + 3-NN over a 100k cloud padded to the 131072 bucket.
    xyz, _ = synthetic_cloud(np.random.default_rng(0), N_FLAGSHIP)
    pts = torch.zeros((1, 131072, 3), device=dev)
    pts[0, :N_FLAGSHIP] = torch.from_numpy(xyz).to(dev)
    valid = torch.zeros((1, 131072), dtype=torch.bool, device=dev)
    valid[0, :N_FLAGSHIP] = True
    got = F.fps_interp_cuda(pts, 2048, valid=valid)
    want = F.fps_interp_plain(pts, 2048, valid=valid)
    for name, a, b in zip(("idx", "centers", "interp_idx", "interp_d2"), got, want):
        check(torch.equal(a, b), f"K1 {name} differs from its plain version")
    rows["K1"] = dict(max_abs_err=max((a.double() - b.double()).abs().max().item()
                                      for a, b in zip(got, want)),
                      ms=time_ms(torch, lambda: F.fps_interp_cuda(pts, 2048, valid=valid)),
                      plain_ms=time_ms(torch, lambda: F.fps_interp_plain(pts, 2048, valid=valid)))

    bf = torch.bfloat16

    def randn(*shape, scale=1.0):
        return torch.randn(shape, device=dev, generator=g) * scale

    def pe_params(cin, cout, h0=128, h1=512):
        def mat(i, o):
            return randn(i, o, scale=i ** -0.5)

        def vec(d, mean=0.0):
            return mean + randn(d, scale=0.1)

        return (mat(cin, h0), vec(h0), vec(h0, 1.0), vec(h0), mat(h0, h0), vec(h0),
                mat(2 * h0, h1), vec(h1), vec(h1, 1.0), vec(h1), mat(h1, cout), vec(cout))

    # K2 at its two slice shapes: encode (C_in 6 -> 512), mask prompt (4 -> 256).
    for label, cin, cout in (("K2", 6, 512), ("K2_mask", 4, 256)):
        params = pe_params(cin, cout)
        x = randn(1, 2048 * 256, cin)
        kw = dict(num_groups=2048, group_size=256, cdt=bf, act="erf")
        err, rel = rel_err(PE.patch_encoder_cuda(x, params, **kw),
                           PE.patch_encoder_plain(x, params, **kw))
        check(rel <= 2e-2, f"{label} rel err {rel:.3g} > 2e-2")
        rows[label] = dict(max_abs_err=err,
                           ms=time_ms(torch, lambda: PE.patch_encoder_cuda(x, params, **kw)),
                           plain_ms=time_ms(torch, lambda: PE.patch_encoder_plain(x, params, **kw)))

    # K3: one ViT-L attention call.
    q, k, v = (randn(1, 2048, 1024).to(bf) for _ in range(3))
    err, rel = rel_err(A.mha_cuda(q, k, v, 16), A.mha_plain(q, k, v, 16))
    check(rel <= 2e-2, f"K3 rel err {rel:.3g} > 2e-2")
    rows["K3"] = dict(max_abs_err=err, ms=time_ms(torch, lambda: A.mha_cuda(q, k, v, 16)),
                      plain_ms=time_ms(torch, lambda: A.mha_plain(q, k, v, 16)))

    # K4: one decode tail, 3 masks over the 131072-point bucket.
    h1 = randn(1, 2048, 256).to(bf)
    idx = torch.randint(0, 2048, (1, 131072, 3), device=dev, generator=g, dtype=torch.int32)
    w = torch.rand((1, 131072, 3), device=dev, generator=g)
    w = w / w.sum(-1, keepdim=True)
    params = (1.0 + randn(256, scale=0.1), randn(256, scale=0.1),
              randn(256, 256, scale=256 ** -0.5), randn(256, scale=0.1))
    hyper = randn(1, 3, 256).to(bf)
    err, rel = rel_err(UP.interp_upscale_cuda(h1, idx, w, params, hyper, cdt=bf),
                       UP.interp_upscale_plain(h1, idx, w, params, hyper, cdt=bf))
    check(rel <= 2e-2, f"K4 rel err {rel:.3g} > 2e-2")
    rows["K4"] = dict(
        max_abs_err=err,
        ms=time_ms(torch, lambda: UP.interp_upscale_cuda(h1, idx, w, params, hyper, cdt=bf)),
        plain_ms=time_ms(torch, lambda: UP.interp_upscale_plain(h1, idx, w, params, hyper,
                                                                cdt=bf)))
    for label, r in rows.items():
        print(f"kernel {label}: max_abs_err {r['max_abs_err']:.6g}  kernel {r['ms']:.4f} ms  "
              f"plain {r['plain_ms']:.4f} ms")
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
    """Phase 4: the tiny config in fp32 on the CPU (plain) and the card."""
    cfg = P.PointSAMConfig(vit="tiny", tokenizer=P.TokenizerConfig(32, 16))
    cpu_model = P.PointCloudSAM(cfg, generator=torch.Generator().manual_seed(0)).eval()
    gpu_model = copy.deepcopy(cpu_model).to(device)
    rng = np.random.default_rng(0)
    xyz = rng.standard_normal((1200, 3)).astype(np.float32)
    xyz /= np.abs(xyz).max() + 1e-3
    rgb = rng.random((1200, 3)).astype(np.float32)
    results = []
    for model in (cpu_model, gpu_model):
        pred = Predictor(model, point_buckets=(2048,))
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
    """Phase 5: ViT-L bf16 Predictor over a 100k-point cloud."""
    dev = torch.device("cuda")
    model = P.PointCloudSAM(P.PointSAMConfig(vit="eva02_large"), dtype=torch.bfloat16,
                            device=dev, generator=torch.Generator(device=dev).manual_seed(0))
    pred = Predictor(model)
    xyz, rgb = synthetic_cloud(np.random.default_rng(0), N_FLAGSHIP)

    pred.set_pointcloud(xyz, rgb)  # warm-up: cuBLAS handles, allocator
    clicks(pred, xyz)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    for fn in counters.values():
        fn.launches = 0
    pred.set_pointcloud(xyz, rgb)
    out = clicks(pred, xyz)
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in counters.items()}
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
          f"{peak / 2**30:.3f} GiB, launches {launches}")
    return launches


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
    from point_sam_tpu_torch.ops import _cuda
    from point_sam_tpu_torch.serving import Predictor

    t0 = time.perf_counter()
    _cuda.library()
    print(f"build: {time.perf_counter() - t0:.1f} s to a loaded library (nvcc + load)",
          flush=True)

    mods = [importlib.import_module(f"point_sam_tpu_torch.ops.{m}")
            for m in ("fps", "patch_encoder_pallas", "attention", "upscale_pallas")]
    F, PE, A, UP = mods
    counters = {"K1": F.fps_interp_cuda, "K2": PE.patch_encoder_cuda, "K3": A.mha_cuda,
                "K4": UP.interp_upscale_cuda}
    with torch.no_grad():
        rows = kernel_checks(torch, np, mods)
    end_to_end_tiny(torch, np, P, Predictor)
    launches = flagship(torch, np, P, Predictor, counters)

    meta = {
        "K1": ("fps_interp", "fps_interp.cu", "point_sam_tpu/ops/fps_pallas.py:138"),
        "K2": ("patch_encoder", "patch_encoder.cu",
               "point_sam_tpu/ops/patch_encoder_pallas.py:135"),
        "K3": ("attention", "attention.cu", "point_sam_tpu/ops/attention.py:178"),
        "K4": ("interp_upscale", "upscale.cu", "point_sam_tpu/ops/upscale_pallas.py:177"),
    }
    kernels = []
    for key, (name, src, replaces) in meta.items():
        r = rows[key]
        kernels.append(dict(name=name, route="cuda",
                            source=f"point_sam_tpu_torch/csrc/{src}", replaces=replaces,
                            launches=launches[key], max_abs_err=r["max_abs_err"],
                            ms=r["ms"], plain_ms=r["plain_ms"]))
    m = rows["K2_mask"]
    print(f"kernel patch_encoder at the mask-prompt shape (4 -> 256): "
          f"max_abs_err {m['max_abs_err']:.6g}, {m['ms']:.4f} ms vs plain {m['plain_ms']:.4f} ms")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
