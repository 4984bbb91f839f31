"""The port's multi-process training against the JAX package, on the CPU.

Two gloo ranks (``tests/_torch_dist_worker.py``, one
``torch.multiprocessing.spawn`` job a fixture, one intra-op thread a rank)
against JAX on a 2-device mesh of ``tests/conftest.py``'s 8 CPU devices,
on the tiny model (``vit="tiny"``, ``TokenizerConfig(16, 8)``,
``prompt_iters=2``) and tests/test_fsdp.py's batch (B=8, N=192, M=2):

- per-rank batches: ``BatchIterator``'s shards at W=2 and W=4 equal JAX's,
  and concatenate to the global batch;
- the DDP step (accum_steps 1 and 2) and the FSDP step against JAX's
  ``make_train_step`` over ``make_mesh(jax.devices()[:2])``, from the same
  weights, with a real schedule (rate 1e-6 at count 0, weight decay 0.1,
  clip 1.0): the loss within 2e-5 relative and every post-step parameter
  within 2e-5, JAX's own bounds (tests/test_fsdp.py); both ranks equal bit
  for bit, and the port's one-process step on the global batch within the
  same bounds (gradients 1e-4 * max + 1e-7, the mask prompt's PointNets
  5e-3: tests/test_torch_port_train.py's and test_torch_port_hier_train.py's
  bounds, for max-pool near-ties on the previous logits); the FSDP ranks hold at
  most ceil(numel / 2) of every ViT-block parameter and of its moments;
- the click draws: a tiny hier model (3 iterations, random sampler, remat)
  at 2 ranks x 2 micro-batches, under DDP and FSDP, equals one process on
  the global batch;
- the trainer CLI at 2 ranks (DDP and FSDP): the one-process losses, only
  rank 0 printing; checkpoints written at 2 ranks resume in one process
  and the other way round, with the same parameters, count and losses;
- ``sharded_knn`` (exact) and ``sharded_min_sq_dist_to_complement``
  against JAX's on a 2-device mesh: indices equal, distances within 1e-6;
- ``maybe_initialize`` reading a ``distributed:`` section and torchrun's
  environment as JAX's reads its own, on a world-1 gloo group.
"""

import math
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from point_sam_tpu import models as J
from point_sam_tpu.datasets.build import BatchIterator as JBatchIterator
from point_sam_tpu.parallel import TrainState, make_mesh, make_train_step, replicate, shard_batch
from point_sam_tpu.parallel import distributed as JD
from point_sam_tpu.parallel import make_optimizer as j_make_optimizer
from point_sam_tpu.parallel import sharded_geometry as JG
from point_sam_tpu.parallel.fsdp import _leaf_spec
from point_sam_tpu.train import warmup_multistep as j_warmup

from point_sam_tpu_torch.datasets.build import BatchIterator
from point_sam_tpu_torch.ops.sampler import sample_prompts_random
from point_sam_tpu_torch.parallel import distributed as D
from point_sam_tpu_torch.parallel import shard_dim
from point_sam_tpu_torch.train import trainer
from point_sam_tpu_torch.utils import state_dict_from_flax

WORKER = Path(__file__).parent / "_torch_dist_worker.py"
REPO = Path(__file__).parent.parent
RTOL, ATOL = 2e-5, 2e-5


def make_batch():
    """tests/test_fsdp.py's batch."""
    rng = np.random.default_rng(0)
    B, N, M = 8, 192, 2
    coords = rng.standard_normal((B, N, 3)).astype(np.float32)
    coords /= np.abs(coords).max() + 1e-3
    feats = rng.random((B, N, 3)).astype(np.float32)
    gt = np.zeros((B, M, N), bool)
    for b in range(B):
        for m in range(M):
            d = ((coords[b] - coords[b, rng.integers(N)]) ** 2).sum(-1)
            gt[b, m] = d < np.quantile(d, 0.3)
    return dict(coords=coords, features=feats, gt_masks=gt)


def make_geometry():
    """Clouds for the sharded geometry: 512 keys, the second row's second
    half a copy of its first (equal distances across the two shards), the
    last 12 keys and 40 in the middle of row 0 padding."""
    rng = np.random.default_rng(3)
    keys = rng.standard_normal((2, 512, 3)).astype(np.float32)
    keys[1, 256:] = keys[1, :256]
    valid = np.ones((2, 512), bool)
    valid[:, 500:] = False
    valid[0, 100:140] = False
    coords = rng.standard_normal((2, 256, 3)).astype(np.float32)
    regions = rng.random((2, 3, 256)) > 0.6
    return dict(query=rng.standard_normal((2, 64, 3)).astype(np.float32), keys=keys,
                key_valid=valid, coords=coords, regions=regions, k=16)


def perturb(variables, seed=0):
    """Random biases and norms, so that no gradient is trivially zero."""
    rng = np.random.default_rng(seed)

    def leaf(a):
        a = np.array(a, np.float32)
        return a + 0.05 * rng.standard_normal(a.shape).astype(np.float32) if a.ndim == 1 else a

    return jax.tree_util.tree_map(leaf, variables)


def spawn(mode: str, d: Path) -> subprocess.Popen:
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + (os.pathsep + env["PYTHONPATH"]
                                     if env.get("PYTHONPATH") else "")
    return subprocess.Popen([sys.executable, str(WORKER), mode, str(d)], cwd=str(REPO), env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def wait(proc: subprocess.Popen) -> None:
    out, _ = proc.communicate(timeout=600)
    assert proc.returncode == 0, out[-8000:]


def torch_tree(d: dict) -> dict:
    return {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v for k, v in d.items()}


def jax_steps(jm, variables, batch) -> dict:
    """JAX's mesh train step over 2 devices at accum_steps 1 and 2: the
    loss and the post-step parameters by the port's names."""
    mesh = make_mesh(jax.devices()[:2])
    tx = j_make_optimizer(j_warmup(1e-3, [100], warmup_iters=5))
    params = variables["params"]
    buffers = {k: v for k, v in variables.items() if k != "params"}
    state = TrainState.create(params, buffers, tx)
    out = {}
    with mesh:
        b = shard_batch({k: jnp.asarray(v) for k, v in batch.items()}, mesh)
        rng = jax.device_put(jax.random.PRNGKey(0),
                             jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec()))
        for accum in (1, 2):
            step = make_train_step(jm, tx, mesh, accum_steps=accum, donate=False)
            s, m = step(replicate(state, mesh), b, rng)
            out[accum] = dict(loss=float(m["loss"]), params=state_dict_from_flax(
                {"params": jax.device_get(s.params), **buffers}))
    return out


def jax_geometry(g) -> dict:
    mesh = make_mesh(jax.devices()[:2])
    j = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v for k, v in g.items()}
    out = {"knn": JG.sharded_knn(j["query"], j["keys"], g["k"], mesh, method="exact"),
           "knn_valid": JG.sharded_knn(j["query"], j["keys"], g["k"], mesh, method="exact",
                                       key_valid=j["key_valid"]),
           "border": JG.sharded_min_sq_dist_to_complement(j["coords"], j["regions"],
                                                           j["coords"], j["regions"], mesh)}
    return jax.tree_util.tree_map(np.asarray, out)


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    """The 2-rank step job (spawned first), JAX's steps while it runs."""
    d = tmp_path_factory.mktemp("dist_steps")
    jm = J.PointCloudSAM(J.PointSAMConfig(vit="tiny", tokenizer=J.TokenizerConfig(16, 8),
                                          prompt_iters=2))
    v = perturb(jax.tree_util.tree_map(np.asarray, J.init_variables(jm, jax.random.PRNGKey(0))))
    batch, geom = make_batch(), make_geometry()
    torch.save(dict(state_dict=state_dict_from_flax(v), batch=torch_tree(batch),
                    geometry=torch_tree(geom)), d / "inputs.pt")
    proc = spawn("steps", d)
    try:
        want = jax_steps(jm, v, batch)
        want_geom = jax_geometry(geom)
    finally:
        wait(proc)
    ranks = [torch.load(d / f"rank{r}.pt", weights_only=True) for r in range(2)]
    return dict(jax=want, geom=want_geom, ranks=ranks)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    d = tmp_path_factory.mktemp("dist_trainer")
    wait(spawn("trainer", d))
    return dict(dir=d, one=torch.load(d / "trainer.pt", weights_only=True),
                ranks=[torch.load(d / f"trainer{r}.pt", weights_only=True) for r in range(2)])


def max_diff(a: dict, b: dict) -> float:
    """Over ``a``'s keys (parameters; ``b`` may hold buffers too)."""
    assert a and set(a) <= set(b)
    return max(float((a[k].float() - b[k].float()).abs().max()) for k in a)


def assert_grads_close(got: dict, want: dict) -> None:
    for name, w in want.items():
        rel = 5e-3 if name.startswith("mask_encoder.patch_encoder") else 1e-4
        err = float((got[name] - w).abs().max())
        assert err <= rel * float(w.abs().max()) + 1e-7, (name, err)


# ------------------------------------------------------------ batches
class Items:
    """A dataset whose examples name their index and draw from their rng."""

    def __len__(self):
        return 37

    def get(self, i, rng=None):
        return dict(idx=np.array([i]), x=rng.standard_normal(3).astype(np.float32))


@pytest.mark.parametrize("world", [2, 4])
def test_batch_iterator_shards_match_jax(world):
    """Each rank's slice of each global batch of 8 equals JAX's (the same
    order, the same per-example draws), and the slices concatenate to the
    global batch; the short last batch (37 = 4 x 8 + 5) is dropped. Also
    after ``skip_epoch`` (the port trains from the iterator's second
    epoch, JAX's first being its init batch's)."""
    ds = Items()
    whole = list(BatchIterator(ds, 8, seed=3, num_workers=0, drop_last=False))
    for skip in (False, True):
        per_rank = []
        for r in range(world):
            it = BatchIterator(ds, 8, seed=3, num_workers=2, drop_last=False, process_index=r,
                               process_count=world)
            jit = JBatchIterator(ds, 8, seed=3, num_workers=0, drop_last=False,
                                 process_index=r, process_count=world)
            if skip:
                it.skip_epoch()
                list(jit)
            got, want = list(it), list(jit)
            assert len(got) == len(want) == 4
            for g, w in zip(got, want):
                assert g.keys() == w.keys()
                for k in g:
                    np.testing.assert_array_equal(g[k], w[k])
            per_rank.append(got)
        if not skip:
            for i in range(4):
                for k in ("idx", "x"):
                    np.testing.assert_array_equal(
                        np.concatenate([per_rank[r][i][k] for r in range(world)]), whole[i][k])


def test_batch_iterator_rejects_uneven_batch():
    with pytest.raises(ValueError, match="not divisible"):
        BatchIterator(Items(), 6, process_index=0, process_count=4)
    with pytest.raises(ValueError, match="not divisible"):
        JBatchIterator(Items(), 6, process_index=0, process_count=4)


def test_random_sampler_rows_are_the_global_draw():
    """``rows=(start, total)``: a slice of the batch gets the clicks its
    rows get when the whole batch is drawn from the same seed."""
    b = {k: torch.from_numpy(v) for k, v in make_batch().items()}
    logits = torch.randn((16, 192), generator=torch.Generator().manual_seed(1))
    for prev in (None, logits):
        c, lab = sample_prompts_random(torch.Generator().manual_seed(9), b["coords"],
                                       b["gt_masks"], prev)
        for start, n in ((0, 8), (2, 3), (6, 2)):
            sl = slice(start, start + n)
            p = None if prev is None else prev.reshape(8, 2, 192)[sl].reshape(-1, 192)
            gc, gl = sample_prompts_random(torch.Generator().manual_seed(9), b["coords"][sl],
                                           b["gt_masks"][sl], p, rows=(start, 8))
            assert torch.equal(gc, c[2 * start:2 * (start + n)])
            assert torch.equal(gl, lab[2 * start:2 * (start + n)])


# ------------------------------------------------------------ train steps
@pytest.mark.parametrize("accum", [1, 2])
def test_ddp_step_matches_jax_mesh_step(steps, accum):
    want = steps["jax"][accum]
    r0, r1 = (r[f"ddp{accum}"] for r in steps["ranks"])
    one = steps["ranks"][0][f"one{accum}"]
    np.testing.assert_allclose(r0["metrics"]["loss"], want["loss"], rtol=RTOL)
    assert max_diff(r0["params"], want["params"]) < ATOL
    # Both ranks hold the same replica, bit for bit, and the same metrics.
    assert r0["metrics"] == r1["metrics"]
    assert max_diff(r0["params"], r1["params"]) == 0.0
    # The one-process step on the global batch.
    for k, v in one["metrics"].items():
        np.testing.assert_allclose(r0["metrics"][k], v, rtol=RTOL, atol=1e-6, err_msg=k)
    assert max_diff(r0["params"], one["params"]) < ATOL
    assert_grads_close(r0["grads"], one["grads"])
    assert r0["count"] == one["count"] == 1
    assert torch.equal(r0["generator"], one["generator"])


def test_fsdp_step_matches_jax_mesh_step(steps):
    want = steps["jax"][1]
    r0, r1 = (r["fsdp"] for r in steps["ranks"])
    one = steps["ranks"][0]["one1"]
    np.testing.assert_allclose(r0["metrics"]["loss"], want["loss"], rtol=RTOL)
    assert max_diff(r0["params"], want["params"]) < ATOL
    assert r0["metrics"] == r1["metrics"]
    assert max_diff(r0["params"], r1["params"]) == 0.0
    assert max_diff(r0["params"], one["params"]) < ATOL
    assert_grads_close(r0["grads"], one["grads"])
    blocks = 0
    for r in (r0, r1):
        for name, s in r["shards"].items():
            if ".blocks." not in name:
                continue
            blocks += 1
            half = math.ceil(s["numel"] / 2)
            assert max(s["local"], s["exp_avg"], s["exp_avg_sq"]) <= half, (name, s)
    assert blocks > 20
    # Every leaf is sharded (none kept whole, unlike JAX's small leaves).
    assert all(s["local"] < s["numel"] for s in r0["shards"].values() if s["numel"] > 1)


@pytest.mark.parametrize("kind", ["ddp", "fsdp"])
def test_hier_click_draws_do_not_depend_on_world_size(steps, kind):
    """The hier model's refinement draw and random sampler's noise at 2
    ranks x 2 micro-batches (each rank's rows of each global micro-batch)
    against one process on the global batch of 4; under FSDP also its
    ViT's remat inside the per-block units."""
    r0, r1 = (r[f"hier_{kind}"] for r in steps["ranks"])
    one = steps["ranks"][0]["hier_one"]
    for k, v in one["metrics"].items():
        np.testing.assert_allclose(r0["metrics"][k], v, rtol=RTOL, atol=1e-6, err_msg=k)
    assert r0["metrics"] == r1["metrics"]
    assert max_diff(r0["params"], one["params"]) < ATOL
    assert_grads_close(r0["grads"], one["grads"])
    assert torch.equal(r0["generator"], one["generator"])


def test_shard_dim_matches_jax_leaf_spec():
    """The FSDP split axis is JAX's ``_leaf_spec`` axis where JAX shards."""
    for shape in ((2048, 513), (513, 1024), (8, 8), (384, 128), (3, 6, 4), (1536,)):
        spec = _leaf_spec(np.zeros(shape), 2, 1)
        want = [i for i, a in enumerate(spec) if a is not None]
        assert [shard_dim(shape, 2)] == (want or [0]), shape
    assert shard_dim((513, 515), 8) == 0  # nothing divides: axis 0, padded


# ------------------------------------------------------------ geometry
@pytest.mark.parametrize("name", ["knn", "knn_valid"])
def test_sharded_knn_matches_jax(steps, name):
    wd, wi = steps["geom"][name]
    for r in steps["ranks"]:
        d, i = r[name]
        np.testing.assert_array_equal(i.numpy(), wi)
        np.testing.assert_allclose(d.numpy(), wd, atol=1e-6)
    d, i = steps["ranks"][0][name]
    if name == "knn":
        # Row 1 holds every key twice, once in each shard: the neighbours
        # come in pairs of equal distance, the smaller global index first.
        assert (i[1, :, 0::2] < 256).all()
        assert torch.equal(i[1, :, 1::2], i[1, :, 0::2] + 256)
    else:
        valid = make_geometry()["key_valid"]
        assert np.take_along_axis(valid[:, None, :], i.numpy().astype(np.int64), -1).all()


def test_sharded_border_distance_matches_jax(steps):
    for r in steps["ranks"]:
        np.testing.assert_allclose(r["border"].numpy(), steps["geom"]["border"], atol=1e-6)


# ------------------------------------------------------------ trainer
def test_trainer_two_ranks_match_one_process(trained):
    one = trained["one"]["one"]
    for name in ("ddp", "fsdp"):
        r0, r1 = (r[name] for r in trained["ranks"])
        np.testing.assert_allclose(r0["losses"], one["losses"], rtol=RTOL)
        assert r0["losses"] == r1["losses"] and r0["step"] == 2
        assert "train/loss=" in r0["stdout"] and "train/" not in r1["stdout"]
        assert r1["stdout"] == ""
    assert "2 processes, FSDP" in trained["ranks"][0]["fsdp"]["stdout"]
    # Validation on every rank over the whole set: the same metrics.
    v0, v1 = (r["fsdp"]["val"] for r in trained["ranks"])
    assert v0 == v1 and "iou(0)" in v0
    assert len(list((trained["dir"] / "fsdp" / "vis" / "ep1").glob("*.ply"))) == 8


def load_ckpt(run_dir: Path) -> dict:
    files = sorted((run_dir / "checkpoints").glob("ckpt_*.pt"))
    assert len(files) == 1
    return torch.load(files[0], weights_only=True)


def assert_same_layout(a: dict, b: dict, count: int) -> None:
    """Two checkpoints with the same optimizer layout, counts and shapes."""
    sa, sb = a["optimizer"]["opt"]["state"], b["optimizer"]["opt"]["state"]
    assert a["optimizer"]["count"] == b["optimizer"]["count"] == count
    assert sa.keys() == sb.keys() and len(sa) == len(a["model"]) - 1  # all but the PE buffer
    for i in sa:
        assert float(sa[i]["step"]) == float(sb[i]["step"]) == count
        for k in ("exp_avg", "exp_avg_sq"):
            assert sa[i][k].shape == sb[i][k].shape
    ga, gb = a["optimizer"]["opt"]["param_groups"], b["optimizer"]["opt"]["param_groups"]
    assert [g["params"] for g in ga] == [g["params"] for g in gb]


def test_checkpoint_written_at_two_ranks_resumes_in_one_process(trained):
    """The 2-rank FSDP run's checkpoint is in the one-process layout and
    holds what the one-process run holds after the same 2 steps; a
    one-process run resumes from it with the losses of a 2-rank resume."""
    d, one = trained["dir"], trained["one"]
    w2 = torch.load(d / "fsdp" / "checkpoints" / "ckpt_1.pt", weights_only=True)
    w1 = torch.load(d / "one_2steps" / "checkpoints" / "ckpt_1.pt", weights_only=True)
    assert w2.keys() == w1.keys() == {"model", "optimizer", "step"}
    assert w2["step"] == w1["step"] == 2
    assert w2["model"].keys() == w1["model"].keys()
    assert_same_layout(w2, w1, 2)
    # The file holds the two ranks' shards put together, bit for bit.
    shards = [r["fsdp"]["shards"] for r in trained["ranks"]]
    names = list(shards[0])
    opt = w2["optimizer"]["opt"]["state"]
    for i, n in enumerate(names):
        dim = shards[0][n]["dim"]
        for key, full in (("param", w2["model"][n]), ("exp_avg", opt[i]["exp_avg"]),
                          ("exp_avg_sq", opt[i]["exp_avg_sq"])):
            assert torch.equal(torch.cat([s[n][key] for s in shards], dim), full), (n, key)
    resumed = one["one_from_w2"]
    assert "resumed from epoch 1 (global step 2)" in resumed["stdout"]
    assert resumed["count"] == 4 and resumed["step"] == 4
    np.testing.assert_allclose(resumed["losses"],
                               trained["ranks"][0]["fsdp_from_w2"]["losses"], rtol=RTOL)


def test_checkpoint_written_in_one_process_resumes_at_two_ranks(trained):
    d, one = trained["dir"], trained["one"]
    r0, r1 = (r["fsdp_from_one"] for r in trained["ranks"])
    assert "resumed from epoch 1 (global step 2)" in r0["stdout"]
    assert r0["count"] == r1["count"] == one["one_resume"]["count"] == 4
    np.testing.assert_allclose(r0["losses"], one["one_resume"]["losses"], rtol=RTOL)
    assert r0["losses"] == r1["losses"]
    a = load_ckpt(d / "fsdp_from_one")
    b = load_ckpt(d / "one")
    assert a["step"] == b["step"] == 4
    assert_same_layout(a, b, 4)


def test_trainer_param_sharding_values(tmp_path):
    args = ["--config", "tiny", "--device", "cpu", f"project_dir={tmp_path}"]
    with pytest.raises(ValueError, match="takes replicated or fsdp"):
        trainer.main(args + ["param_sharding=tp"])
    with pytest.raises(ValueError, match="unknown param_sharding"):
        trainer.main(args + ["param_sharding=zero3"])
    with pytest.raises(ValueError, match="needs a process group"):
        trainer.main(args + ["param_sharding=fsdp"])


# ------------------------------------------------------------ process groups
def free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT", "LOCAL_RANK",
       "JAX_COORDINATOR_ADDRESS")


def test_maybe_initialize_reads_config_like_jax(monkeypatch):
    """The same ``distributed:`` values reach torch.distributed that reach
    jax.distributed; nothing triggers without a section or torchrun's
    variables."""
    for v in ENV:
        monkeypatch.delenv(v, raising=False)
    jax_calls, torch_calls = [], []
    monkeypatch.setattr(JD, "initialize", lambda **kw: jax_calls.append(kw))
    monkeypatch.setattr(torch.distributed, "init_process_group",
                        lambda backend, **kw: torch_calls.append(dict(kw, backend=backend)))
    assert not D.maybe_initialize({}, "cpu") and not JD.maybe_initialize({})
    assert not jax_calls and not torch_calls
    section = {"coordinator_address": "10.0.0.1:1234", "num_processes": 4, "process_id": 3}
    assert JD.maybe_initialize({"distributed": section})
    assert D.maybe_initialize({"distributed": section}, "cpu")
    assert jax_calls[-1] == dict(coordinator_address="10.0.0.1:1234", num_processes=4,
                                 process_id=3)
    assert torch_calls[-1] == dict(backend="gloo", init_method="tcp://10.0.0.1:1234",
                                   world_size=4, rank=3)
    for k, v in dict(RANK="1", WORLD_SIZE="2", MASTER_ADDR="h", MASTER_PORT="5").items():
        monkeypatch.setenv(k, v)
    for cfg in ({}, {"distributed": "auto"}):
        assert D.maybe_initialize(cfg, "cpu")
        assert torch_calls[-1] == dict(backend="gloo", init_method="env://", world_size=2,
                                       rank=1)
    monkeypatch.delenv("MASTER_PORT")
    with pytest.raises(RuntimeError, match="MASTER_PORT"):
        D.maybe_initialize({"distributed": "auto"}, "cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            D.initialize("tcp://localhost:1", 1, 0, device="cuda")


def test_world_one_group(monkeypatch):
    """A real world-1 gloo group from torchrun's variables: rank 0 of 1,
    main process; a second call is a no-op; a CUDA run would not join a
    gloo group; shutdown leaves no group."""
    for v in ENV:
        monkeypatch.delenv(v, raising=False)
    for k, v in dict(RANK="0", WORLD_SIZE="1", MASTER_ADDR="localhost",
                     MASTER_PORT=str(free_port())).items():
        monkeypatch.setenv(k, v)
    try:
        assert D.maybe_initialize({}, "cpu")
        assert torch.distributed.get_backend() == "gloo"
        assert D.initialize(device="cpu") == torch.device("cpu")
        assert (D.process_index(), D.process_count(), D.is_main_process()) == (0, 1, True)
        assert not D.maybe_initialize({"distributed": "auto"}, "cpu")
        with pytest.raises(RuntimeError, match="asks for nccl"):
            D.initialize(device="cuda")
    finally:
        D.shutdown()
    assert not torch.distributed.is_initialized() and D.process_count() == 1
