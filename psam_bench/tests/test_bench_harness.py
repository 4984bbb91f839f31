"""The harness on the CPU: names found by name, malformed names refused, a
tiny run of each mix giving a well-formed result line, a cell / config /
mix / metric added as files and entries only, the JAX-module check, and
the comparison failing under the control and under each planted fault.

    python -m pytest psam_bench/tests -q -p no:cacheprovider
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
import types
from pathlib import Path

import pytest
import torch

from psam_bench import check, control, run, spec
from psam_bench.tests import tiny

HOME = Path(spec.HERE)
CPU = torch.device("cpu")
CELLS = ("vitl_knn.annotate", "voronoi_giant.annotate")


@pytest.fixture(scope="module")
def bench():
    return spec.load()


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def tiny_run(bench, cell, seed=987654321012, traced=False, faults=(), limits=None):
    cfg, mix = cell.split(".")
    return run.run_cell(bench, cell, seed, 0.3, traced, CPU, faults=faults, limits=limits,
                        config=tiny.config(cfg), traffic=tiny.traffic(mix))


def well_formed(line: dict, metrics: list, traced: bool) -> None:
    line = json.loads(json.dumps(line))
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks"
    assert isinstance(line["correct"], bool)
    assert line["attempted"] >= 1 and line["failed"] == 0
    for name in metrics:
        m = line["metrics"][name]
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(line["device"])
    if traced:
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    for v in line["checks"].values():
        assert set(v) == {"value", "limit"}


def test_names_found_by_name(bench):
    for w in bench["workloads"]:
        cell = spec.cell(bench, w["name"])
        assert callable(spec.loop(bench, cell["traffic_data"]).run)
        assert spec.kind(bench, cell["config_data"]).GROUPS in ("knn_idx", "nn_idx")
        assert set(cell["limits"]) == set(check.judge({}, cell["limits"])[1]) != set()
        assert spec.end_to_end(bench, w["name"])[0]["name"] == "setup_s"
        for m in spec.per_layer(bench, w["name"]):
            assert callable(spec.reader(bench, m["name"]))


@pytest.mark.parametrize("field, bad", [
    ("name", "vitl knn"), ("name", "a/b"), ("name", ""), ("unit", "tokens per second"),
    ("unit", "µs"), ("config", "x,y"), ("better", "faster")])
def test_malformed_names_refused(tmp_path, field, bad):
    home = tmp_path / "psam_bench"
    shutil.copytree(HOME, home, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    data = json.loads((HOME.parent / "BENCHMARK.json").read_text())
    if field in ("name", "config"):
        data["workloads"][0][field] = bad
    else:
        data["end_to_end"][1][field] = bad
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(data))
    with pytest.raises(spec.SpecError):
        spec.load(home)


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("traced", [False, True])
def test_tiny_run_gives_a_well_formed_line(bench, cell, traced):
    out = tiny_run(bench, cell, traced=traced)
    names = [m["name"] for m in spec.end_to_end(bench, cell)]
    well_formed(out["line"], [] if traced else names, traced)
    # On the CPU nothing is read from a device trace: only host readings.
    if traced:
        assert set(out["line"]["metrics"]) <= {"click_p95_ms"}


def test_a_cell_config_mix_and_metric_are_added_as_files(tmp_path):
    home = tmp_path / "psam_bench"
    shutil.copytree(HOME, home, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    data = json.loads((HOME.parent / "BENCHMARK.json").read_text())
    cfg = tiny.config("vitl_knn")
    (home / "configs" / "tiny_knn.json").write_text(json.dumps(cfg))
    (home / "traffic" / "few_clicks.json").write_text(json.dumps(tiny.traffic("annotate")))
    (home / "limits" / "tiny_knn.few_clicks.json").write_text(
        (HOME / "limits" / "vitl_knn.annotate.json").read_text())
    (home / "metrics" / "sessions_checked.py").write_text(
        "def read(rec):\n    return float(len(rec['ranges'].get('psam.set_pointcloud', [])))\n")
    data["configs"].append(dict(name="tiny_knn", source="https://arxiv.org/abs/2406.17741",
                                file="psam_bench/configs/tiny_knn.json", reduced=["vit"],
                                why="tiny"))
    data["workloads"].append(dict(name="tiny_knn.few_clicks", config="tiny_knn",
                                  traffic="few_clicks", chips=1, why="tiny"))
    data["per_layer"].append(dict(name="sessions_checked", unit="1", better="higher",
                                  source="program_span", layer="harness",
                                  moves="session_ms", workloads=["tiny_knn.few_clicks"]))
    for m in data["end_to_end"]:
        if "workloads" in m and "vitl_knn.annotate" in m["workloads"]:
            m["workloads"].append("tiny_knn.few_clicks")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(data))
    bench = spec.load(home)
    out = run.run_cell(bench, "tiny_knn.few_clicks", 5, 0.3, True, CPU)
    assert out["line"]["metrics"]["sessions_checked"]["value"] == 1.0
    assert out["line"]["correct"]
    plain = run.run_cell(bench, "tiny_knn.few_clicks", 5, 0.3, False, CPU)
    assert set(plain["line"]["metrics"]) == {"setup_s", "encode_p95_ms", "session_ms"}


# A loop of encodes alone, as a later cell would add one: each request opens
# the next of two clouds; the comparison reads one kept encode's embeddings.
ENCODE_LOOP = '''
import time

import numpy as np

from psam_bench import check, drive, scenes
from psam_bench.reference import model as ref


def run(ctx):
    from point_sam_tpu_torch.serving.predictor import Predictor

    torch, tr = ctx.torch, ctx.traffic
    w_seed, pool_seed, res_seed = drive.seeds(ctx.seed, 3)
    model, shapes = drive.build_model(ctx, w_seed)
    pred = Predictor(model, device=ctx.device, point_buckets=ctx.config["serve"]["point_buckets"])
    clouds = [scenes.unit_sphere(scenes.generate_scene(s, tr["points"])["coords"])
              .astype(np.float32) for s in drive.seeds(pool_seed, 2)]
    rgb = np.full((tr["points"], 3), 0.5, np.float32)
    times = []

    def encode(i, keep):
        t0 = time.perf_counter()
        pred.set_pointcloud(clouds[i % 2], rgb)
        times.append((time.perf_counter() - t0) * 1e3)
        return (i % 2, pred._state["emb"][0].float()) if keep else None

    encode(0, False)
    result = drive.window(ctx, encode, 1, res_seed)
    (i, emb), = result["kept"]
    del pred, model
    drive.free(ctx)
    P = drive.reference_params(ctx, shapes, w_seed)
    ref.fp32_matmuls()
    xyz = torch.as_tensor(clouds[i])[None]
    tok = ctx.config["model"]["tokenizer"]
    geom = ref.geometry(ctx.kind, xyz, tok["num_patches"], tok.get("patch_size"))
    want = ref.encode(P, ctx.kind, drive.ref_config(ctx.config)["vit"], xyz,
                      torch.as_tensor(rgb)[None], geom)[0][0]
    return dict(metrics=dict(setup_s=result["setup_s"], encode_p95_ms=drive.p95(times)),
                numbers=dict(embed_err=check.rel(emb, want)), records=None,
                peak=result["peak"], done=result["done"], state=None)
'''


def test_a_loop_and_a_model_kind_are_added_as_files(tmp_path):
    """A new loop (``loops/<loop>.py``, named by a new mix) and a new model
    kind (``reference/<kind>.py``, named by a new configuration) run a new
    cell with no existing file edited."""
    home = tmp_path / "psam_bench"
    shutil.copytree(HOME, home, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    data = json.loads((HOME.parent / "BENCHMARK.json").read_text())
    (home / "loops" / "encodes.py").write_text(ENCODE_LOOP)
    (home / "reference" / "knn_twin.py").write_text((HOME / "reference" / "knn.py").read_text())
    cfg = dict(tiny.config("vitl_knn"), kind="knn_twin")
    (home / "configs" / "twin.json").write_text(json.dumps(cfg))
    (home / "traffic" / "encodes.json").write_text(json.dumps(dict(loop="encodes", points=600)))
    (home / "limits" / "twin.encodes.json").write_text(json.dumps(dict(embed_err=1e-4)))
    data["configs"].append(dict(name="twin", source="https://arxiv.org/abs/2406.17741",
                                file="psam_bench/configs/twin.json", reduced=["vit"],
                                why="tiny"))
    data["workloads"].append(dict(name="twin.encodes", config="twin", traffic="encodes",
                                  chips=1, why="tiny"))
    for m in data["end_to_end"]:
        if m["name"] == "encode_p95_ms":
            m["workloads"].append("twin.encodes")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(data))
    bench = spec.load(home)
    assert spec.kind(bench, cfg).__file__ == str(home / "reference" / "knn_twin.py")
    out = run.run_cell(bench, "twin.encodes", 7, 0.3, False, CPU)
    well_formed(out["line"], ["setup_s", "encode_p95_ms"], False)
    assert out["line"]["correct"], out["line"]["checks"]
    bad = run.run_cell(bench, "twin.encodes", 7, 0.3, False, CPU,
                       limits=dict(embed_err=out["numbers"]["embed_err"] / 2))
    assert not bad["line"]["correct"]


def test_forbidden_modules_by_whole_top_level_name(monkeypatch):
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "point_sam_tpu_torch_extra", types.ModuleType("x"))
    assert run.forbidden_modules() == []
    for name in ("jax", "jaxlib.xla_client", "flax", "point_sam_tpu.models"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert run.forbidden_modules() == ["flax", "jax", "jaxlib.xla_client", "point_sam_tpu.models"]


def test_the_harness_loads_no_jax():
    code = ("import sys, torch; from psam_bench.tests.test_bench_harness import tiny_run; "
            "from psam_bench import spec, run; tiny_run(spec.load(), 'voronoi_giant.annotate'); "
            "print(run.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=HOME.parent, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_no_card_no_result():
    """Without a CUDA card (this machine) the command exits non-zero and
    prints nothing on standard output."""
    out = subprocess.run([sys.executable, "-m", "psam_bench.run", "--workload",
                          "vitl_knn.annotate", "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=HOME.parent, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""


def test_only_the_benchmark_files_give_no_result(tmp_path):
    """A directory holding only BENCHMARK.json and the benchmark's folder
    has no program to run: non-zero, no result."""
    shutil.copytree(HOME, tmp_path / "psam_bench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(HOME.parent / "BENCHMARK.json", tmp_path)
    code = ("import sys, torch; from psam_bench import run, spec; "
            "run.run_cell(spec.load(), 'vitl_knn.annotate', 1, 1.0, False, torch.device('cpu'))")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0 and "point_sam_tpu_torch" in out.stderr


@pytest.mark.parametrize("cell", CELLS)
def test_sound_tiny_run_is_correct_under_the_cells_limits(bench, cell):
    out = tiny_run(bench, cell)
    assert out["line"]["correct"], out["line"]["checks"]


def test_the_reference_turns_tf32_off_itself(bench):
    """The program's import sets the card's matmul precision; the reference
    sets its own, so a program that turned TF32 on would not move it."""
    import point_sam_tpu_torch  # noqa: F401

    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    try:
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
        tiny_run(bench, "vitl_knn.annotate")
        assert not torch.backends.cuda.matmul.allow_tf32
        assert not torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", ["stale_state", "altered_answer", "mask_prompt_ignored"])
def test_a_planted_fault_is_not_correct(bench, cell, fault):
    """The timed path broken underneath (a state left unchanged, an answer
    altered where it is produced, the refining clicks' mask prompt
    dropped): the run's comparison under the cell's own limits comes out
    false."""
    out = tiny_run(bench, cell, faults=(fault,))
    assert not out["line"]["correct"], out["line"]["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_a_dropped_mask_prompt_shows_in_the_refining_clicks_alone(bench, cell):
    """Only the refining clicks carry a mask prompt: the fault moves their
    pool and leaves the first clicks' and the encode's within limits."""
    checks = tiny_run(bench, cell, faults=("mask_prompt_ignored",))["line"]["checks"]
    failed = {k for k, v in checks.items() if v["value"] > v["limit"]}
    assert failed and failed <= {"refine_logits_gap", "refine_iou_gap"}, checks


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(bench, cell):
    """The plain reference one precision below the configuration's (float8
    products, bfloat16 geometry), put in the program's place, fails the
    cell's limits."""
    cfg, mix = cell.split(".")
    rows = control.readings(bench, cell, 24680, 0.3, True, CPU, tiny.config(cfg),
                            tiny.traffic(mix))
    limits = spec.cell(bench, cell)["limits"]
    by = {what: numbers for what, numbers, _ in rows}
    assert check.judge(by["program"], limits)[0]
    assert not check.judge(by["control"], limits)[0]
