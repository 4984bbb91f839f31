"""The frozen plain reference against the program (``point_sam_tpu_torch``)
on the CPU at tiny widths, and its independence from the program.

    python -m pytest psam_bench/tests/test_bench_reference.py -q -p no:cacheprovider
"""

from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from psam_bench import check, drive, spec, weights
from psam_bench.reference import model as ref
from psam_bench.tests import tiny

REF_DIR = Path(ref.__file__).resolve().parent
CPU = torch.device("cpu")


def program_and_params(name: str):
    cfg = tiny.config(name)
    kind = spec.kind(spec.load(), cfg)
    ctx = drive.Ctx(torch=torch, config=cfg, traffic={}, seed=1, seconds=0,
                    traced=False, device=CPU, tmpdir="", kind=kind)
    model, shapes = drive.build_model(ctx, 12345)
    model.requires_grad_(False)
    return cfg, kind, model, weights.seeded_state(shapes, 12345, CPU)


def cloud(B=2, N=500, seed=0, twins=False):
    g = torch.Generator().manual_seed(seed)
    xyz = torch.rand((B, N, 3), generator=g) * 2 - 1
    if twins:  # every point twice: ties in every distance
        xyz = torch.cat([xyz[:, : N // 2], xyz[:, : N // 2]], 1)
    return xyz, torch.rand((B, xyz.shape[1], 3), generator=g)


@pytest.mark.parametrize("name", ["vitl_knn", "voronoi_giant"])
@pytest.mark.parametrize("twins", [False, True])
def test_geometry_equals_the_programs(name, twins):
    cfg, kind, model, _ = program_and_params(name)
    xyz, _ = cloud(twins=twins)
    K = cfg["model"]["tokenizer"].get("patch_size")
    G = cfg["model"]["tokenizer"]["num_patches"]
    got = model.make_geometry(xyz) if K is None else model.make_geometry(xyz, group_size=K)
    want = ref.geometry(kind, xyz, G, K)
    assert torch.equal(got["fps_idx"].long(), want["fps_idx"])
    assert torch.equal(got["centers"], want["centers"])
    if K is None:
        assert torch.equal(got["nn_idx"].long(), want["nn_idx"])
    else:
        assert torch.equal(got["knn_idx"].long(), want["knn_idx"])
    assert torch.equal(got["interp_index"].long(), want["interp_idx"])
    assert torch.allclose(got["interp_weight"], want["interp_w"], rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("name", ["vitl_knn", "voronoi_giant"])
def test_encode_and_decode_agree_with_the_program(name):
    cfg, kind, model, P = program_and_params(name)
    rc = drive.ref_config(cfg)
    xyz, rgb = cloud()
    K = cfg["model"]["tokenizer"].get("patch_size")
    G = cfg["model"]["tokenizer"]["num_patches"]
    geom = model.make_geometry(xyz) if K is None else model.make_geometry(xyz, group_size=K)
    geom.update(model.prompt_cache(xyz, geom))
    emb, pe = model.encode(xyz, rgb, geom)[:2]
    rgeom = ref.geometry(kind, xyz, G, K)
    remb, rpe = ref.encode(P, kind, rc["vit"], xyz, rgb, rgeom)
    assert check.rel(emb, remb) < 1e-5 and check.rel(pe, rpe) < 1e-6
    g = torch.Generator().manual_seed(9)
    for P_, multimask, prompt in ((1, True, None), (3, False, torch.randn((4, 500), generator=g))):
        pts = torch.rand((4, P_, 3), generator=g)
        labels = torch.rand((4, P_), generator=g) > 0.5
        masks, iou = model.decode(emb, pe, xyz, geom, pts, labels, prompt,
                                  prompt_valid=torch.ones_like(labels), multimask_output=multimask)
        rmasks, riou = ref.decode(P, kind, rc["decoder"], remb, rpe, xyz, rgeom, pts,
                                  labels, prompt, multimask)
        assert check.rel(masks, rmasks) < 1e-5 and check.rel(iou, riou) < 1e-5


def test_the_fp8_rounding_is_coarser_than_bf16():
    x = torch.randn(4096, generator=torch.Generator().manual_seed(1))
    fp8 = check.rel(ref.Prec("fp8").q(x), x)
    bf16 = check.rel(x.bfloat16().float(), x)
    assert 4 * bf16 < fp8 < 0.1


def test_the_reference_imports_nothing_of_the_program():
    own = ("psam_bench.reference.model", "psam_bench.work")  # work.py imports nothing
    for path in REF_DIR.glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            for n in names:
                assert n in own or n.split(".")[0] in ("torch", "math", "__future__"), \
                    f"{path.name} imports {n}"
    code = ("import sys; import psam_bench.reference.model, psam_bench.reference.knn, "
            "psam_bench.reference.voronoi; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('point_sam_tpu_torch', 'point_sam_tpu', 'jax')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REF_DIR.parents[1],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "[]", out.stderr[-2000:]
