"""``work.py``'s model FLOPs against torch's own count
(``torch.utils.flop_counter.FlopCounterMode``) of the program's plain path
on the CPU at tiny widths, and its kernel arithmetic.

    python -m pytest psam_bench/tests/test_bench_work.py -q -p no:cacheprovider
"""

from __future__ import annotations

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from psam_bench import drive, spec, work
from psam_bench.tests import tiny

CPU = torch.device("cpu")


def counted(fn) -> int:
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


def setup(name: str, G: int, B: int = 2, N: int = 400):
    cfg = tiny.config(name)
    cfg["model"]["tokenizer"]["num_patches"] = G
    ctx = drive.Ctx(torch=torch, config=cfg, traffic={}, seed=1, seconds=0,
                    traced=False, device=CPU, tmpdir="", kind=spec.kind(spec.load(), cfg))
    model, _ = drive.build_model(ctx, 11)
    model.requires_grad_(False)
    g = torch.Generator().manual_seed(3)
    coords = torch.rand((B, N, 3), generator=g) * 2 - 1
    feats = torch.rand((B, N, 3), generator=g)
    K = cfg["model"]["tokenizer"].get("patch_size")
    geom = model.make_geometry(coords) if K is None else model.make_geometry(coords, group_size=K)
    geom.update(model.prompt_cache(coords, geom))
    return cfg, ctx.kind, model, coords, feats, geom, K


@pytest.mark.parametrize("name", ["vitl_knn", "voronoi_giant"])
@pytest.mark.parametrize("G", [32, 128])
def test_encode_flops_match_torch_count(name, G):
    cfg, kind, model, coords, feats, geom, K = setup(name, G)
    with torch.no_grad():
        got = counted(lambda: model.encode(coords, feats, geom))
    assert got == work.encode_flops(drive.ref_config(cfg), kind, 2, coords.shape[1], G, K)


@pytest.mark.parametrize("name", ["vitl_knn", "voronoi_giant"])
@pytest.mark.parametrize("G", [32, 128])
@pytest.mark.parametrize("P, multimask, with_mask", [(1, True, False), (3, False, True)])
def test_decode_flops_match_torch_count(name, G, P, multimask, with_mask):
    cfg, kind, model, coords, feats, geom, K = setup(name, G)
    B, N = coords.shape[:2]
    M = 2
    g = torch.Generator().manual_seed(4)
    with torch.no_grad():
        emb, pe = model.encode(coords, feats, geom)[:2]
        pts = torch.rand((B * M, P, 3), generator=g)
        labels = torch.rand((B * M, P), generator=g) > 0.5
        prompt = torch.randn((B * M, N), generator=g) if with_mask else None
        got = counted(lambda: model.decode(emb, pe, coords, geom, pts, labels, prompt,
                                           prompt_valid=torch.ones_like(labels),
                                           multimask_output=multimask))
    want = work.decode_flops(drive.ref_config(cfg), kind, B * M, P, G, N, 3 if multimask else 1,
                             with_mask, K)
    assert got == want


def test_bound_and_families():
    t, what = work.bound(3.35e12, {"bf16": 1.0})
    assert (t, what) == (1.0, "bytes")
    t, what = work.bound(0.0, {"bf16": 989e12, "fp32": 67e12})
    assert what == "operations" and t == pytest.approx(2.0)
    assert work.family_of("void fps_cluster_kernel<true, 32>(float const*)") == "K1"
    assert work.family_of("fps_cluster_kernel<false, 16>") == "K8"
    assert work.family_of("void nn3_kernel<true>(...)") == "K10"
    assert work.family_of("patch_encoder_mma_kernel<128>") == "K2"
    assert work.family_of("patch_encoder_bwd_c_mma_kernel") == "K7"
    assert work.family_of("mha_kernel_mma<64>") == "attention"
    assert work.family_of("interp_upscale_mma_kernel<256, true>") == "tail"
    assert work.family_of("cutlass::Kernel2<...>") is None
    # Every family's work at a launch key as the program's counters record it.
    keys = {"K1": dict(B=1, N=131072, G=2048, valid=True, route="cluster"),
            "K8": dict(B=16, N=10000, G=1024, valid=False, route="cluster"),
            "K10": dict(B=1, N=131072, G=2048),
            "K12": dict(B=1, Nq=2048, Nk=131072, k=256, valid=True, bins=None),
            "K2": dict(B=1, G=2048, K=256, cin=6, h0=128, h1=512, cout=512,
                       cdt="torch.bfloat16", act="erf", argmax=False),
            "attention": dict(B=1, heads=16, S=2048, dh=88, dtype="torch.bfloat16"),
            "K6": dict(B=2, S=1024, D=1024, heads=16, dtype="torch.bfloat16"),
            "tail": dict(B=1, M=1, G=2048, N=131072, D=256, C=3, cdt="torch.bfloat16",
                         route="mma")}
    for fam, key in keys.items():
        nbytes, ops = work.kernel_work(fam, key, n_real=100000)
        assert nbytes > 0 and all(v > 0 for v in ops.values())
    assert work.kernel_work("K7", {}) is None
    # K1 counts the farthest-point loop over the real points only.
    assert work.kernel_work("K1", keys["K1"], 100000)[1]["fp32"] == 10.0 * 100000 * 2048
