"""The port's tensor parallelism and point-sharded evaluation against the
JAX package, on the CPU.

Four gloo ranks (``tests/_torch_tp_worker.py``, one
``torch.multiprocessing.spawn`` job for the module, one intra-op thread a
rank) against JAX on ``tests/conftest.py``'s CPU devices, computed while
the job runs, on the tiny model (``vit="tiny"``: D=128 in 4 heads, SwiGLU
hidden 256; ``TokenizerConfig(32, 16)``, ``prompt_iters=2``) with random
biases and norms:

- the plan against ``tp_spec_tree``, leaf by leaf through the key table,
  at model axes 4 and 7 (tests/test_tensor_parallel.py), at the ViT-L
  width at 4 (MLPs whole: 2730 % 4 != 0; attention split), and on an
  EVA-giant-shaped block (fused qkv: the same leaves split, each third by
  heads where JAX cuts the kernel contiguously);
- the encode with the ViT split at (data 1, model 4) against JAX's
  ``tp_place`` encode on ``make_mesh_2d(1, 4)``: rtol and atol 2e-5; each
  rank holds a quarter of ``fc1_g``; the same for an EVA-giant-shaped ViT
  at the tiny width (fused qkv with q / v biases, GELU MLP), each rank
  one head of q, of k and of v;
- one train step at (data 2, model 2) against JAX's
  ``make_train_step(param_sharding="tp")`` on ``make_mesh_2d(2, 2)``, from
  the same weights, on the same batch (B=2, N=512, M=2), rate 1e-6 at
  count 0 with weight decay 0.1: the loss within 2e-5 relative, every
  gathered post-step parameter within 2e-5, the split leaves still split;
  also against the port's one-process step on the whole batch. One Adam
  step at that rate moves a parameter by about 1e-6 whatever its gradient,
  so the gradients the optimizer is handed (gathered, averaged over the
  data groups, before the clip) are held too: to ``jax.grad`` of the step's
  loss over the same mesh and shardings, and to one process's, within
  1e-4 of each tensor's largest + 1e-7, the PointNet patch encoders'
  within 5e-3, whose max-pool near-ties move a column's gradient
  (tests/test_torch_port_train.py's bound; against one process only the
  mask prompt's, tests/test_torch_port_distributed.py's);
- the evaluator with ``group`` over the 4 ranks against JAX's with
  ``mesh=make_mesh(jax.devices()[:4])`` (``generate_scene(5, 1500)``,
  bucket 2048; tests/test_sharded_geometry.py): IoUs within 2e-2, and
  against the port's evaluator without a group;
- ``for_sharded_eval``'s decode against JAX's at N=1024, at G=16 (the
  gather and K11's plain version on each shard) and G=128 (K4's), and at
  N=1001 (a short last shard; JAX's sharded decode needs N divisible by its
  mesh, so its unsharded decode is the reference there): masks and IoU
  predictions within 2e-5.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec

from point_sam_tpu import models as J
from point_sam_tpu.datasets.synthetic import generate_scene
from point_sam_tpu.evalsuite.eval_interactive import InteractiveEvaluator as JEvaluator
from point_sam_tpu.evalsuite.eval_interactive import normalize_scene
from point_sam_tpu.models.tokenizer import compute_geometry as j_compute_geometry
from point_sam_tpu.parallel import (
    TrainState,
    make_mesh,
    make_mesh_2d,
    make_train_step,
    tp_place,
    tp_sharding_tree,
    tp_spec_tree,
)
from point_sam_tpu.parallel import make_optimizer as j_make_optimizer
from point_sam_tpu.train import warmup_multistep as j_warmup

from point_sam_tpu_torch import models as P
from point_sam_tpu_torch.parallel import tp_plan
from point_sam_tpu_torch.parallel.tensor_parallel import _slice
from point_sam_tpu_torch.utils import state_dict_from_flax
from point_sam_tpu_torch.utils.convert import torch_key_for

WORKER = Path(__file__).parent / "_torch_tp_worker.py"
REPO = Path(__file__).parent.parent
RTOL, ATOL = 2e-5, 2e-5
EVAL_KW = dict(num_clicks=2, point_buckets=(2048,), masks_per_batch=2, knn_method="exact")
# The EVA-giant block's shape at the tiny width: fused qkv, GELU MLP.
FUSED_VIT = dict(embed_dim=128, depth=2, num_heads=4, mlp_hidden_dim=256, swiglu=False,
                 qkv_fused=True)


def perturb(variables, seed=0):
    """Random biases and norms, so that no split leaf is trivially zero (a
    fused qkv bias's k third stays zero: timm's layout has no k bias)."""
    rng = np.random.default_rng(seed)

    def leaf(path, a):
        a = np.array(a, np.float32)
        if a.ndim != 1 and not (a.ndim == 2 and "/blocks/block/" in _keys(path)):
            return a
        a = a + 0.05 * rng.standard_normal(a.shape).astype(np.float32)
        if _keys(path).endswith("/attn/qkv/bias"):
            d = a.shape[-1] // 3
            a[..., d:2 * d] = 0.0
        return a

    return jax.tree_util.tree_map_with_path(leaf, variables)


def _keys(path) -> str:
    return "/".join(str(getattr(p, "key", p)) for p in path)


def t(a):
    return torch.from_numpy(np.array(a))


def tree_t(d: dict) -> dict:
    return {k: t(v) for k, v in d.items()}


# ------------------------------------------------------------ the plan
def jax_modes(specs, depth: int) -> dict:
    """JAX's specs as the port's modes, by the port's keys: "col" / "row"
    where a matrix's output / input axis is split, "vec" for a vector,
    None where the leaf is whole (the scan layout's depth axis dropped)."""
    out = {}
    flat = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, PartitionSpec))[0]
    for path, spec in flat:
        keys = "/".join(str(getattr(p, "key", p)) for p in path)
        stacked = "/blocks/block/" in keys
        spec = tuple(spec)[1:] if stacked and len(spec) else tuple(spec)
        axes = [i for i, a in enumerate(spec) if a is not None]
        leaf = keys.rsplit("/", 1)[-1]
        mode = None
        if axes:
            if leaf in ("bias", "scale"):
                mode = "vec"
            else:
                mode = "col" if axes[0] == len(spec) - 1 else "row"
        paths = ([keys.replace("/blocks/block/", f"/blocks_{i}/") for i in range(depth)]
                 if stacked else [keys])
        for p in paths:
            if p.endswith("/label_embed"):  # one port key a row
                out["point_encoder.point_embeddings."] = mode
            elif p.endswith("/attn/qkv/bias"):  # the q and v thirds of a fused bias
                base = p[:-len("/bias")]
                for third in ("q_bias", "v_bias"):
                    out[torch_key_for(f"{base}/{third}")] = mode
            else:
                out[torch_key_for(p)] = mode
    return out


def plan_case(vit_j, vit_p, n_model):
    """(JAX's modes, the port's plan) for one ViT config."""
    jm = J.PointCloudSAM(J.PointSAMConfig(vit=vit_j, tokenizer=J.TokenizerConfig(32, 16)))
    shapes = jax.eval_shape(lambda: J.init_variables(jm, jax.random.PRNGKey(0)))
    depth = jm.cfg.vit_cfg.depth
    specs = tp_spec_tree(shapes, n_model)
    want = jax_modes(specs, depth)
    pm = P.PointCloudSAM(P.PointSAMConfig(vit=vit_p, tokenizer=P.TokenizerConfig(32, 16)),
                         device="meta")
    got = tp_plan(pm, n_model)
    rows = "point_encoder.point_embeddings."
    labels = {k: v for k, v in got.items() if k.startswith(rows)}
    assert labels and set(labels.values()) == {want[rows]}
    got = {k: v for k, v in got.items() if k not in labels}
    got[rows] = want[rows]
    assert got.keys() == want.keys()
    return want, got


@pytest.mark.parametrize("n_model", [4, 7])
def test_plan_matches_tp_spec_tree(n_model):
    """The tiny model: every leaf's mode is JAX's; at 4 the ViT's blocks
    split (LayerNorms over the embed axis and every non-ViT leaf whole, the
    decoder's ``mlp`` among them); at 7 nothing divides: all whole."""
    want, got = plan_case("tiny", "tiny", n_model)
    assert got == want
    split = {k for k, v in got.items() if v}
    if n_model == 7:
        assert not split
        return
    assert all(k.startswith("pc_encoder.transformer.blocks.") for k in split)
    assert got["pc_encoder.transformer.blocks.0.attn.q_proj.weight"] == "col"
    assert got["pc_encoder.transformer.blocks.1.attn.proj.weight"] == "row"
    assert got["pc_encoder.transformer.blocks.0.mlp.fc1_g.bias"] == "vec"
    assert got["pc_encoder.transformer.blocks.0.mlp.norm.weight"] == "vec"
    assert got["pc_encoder.transformer.blocks.0.mlp.fc2.weight"] == "row"
    assert got["pc_encoder.transformer.blocks.0.norm1.weight"] is None
    assert got["pc_encoder.transformer.blocks.0.attn.k_proj.weight"] == "col"
    assert got["mask_decoder.transformer.layers.0.mlp.lin1.weight"] is None


def test_plan_vit_large_width_keeps_the_mlp_whole_at_4():
    """EVA02-L: SwiGLU hidden 2730 is not divisible by 4, so fc1_g, fc1_x,
    the sub-LN and fc2 stay whole while the 16 heads split; at 2 all split
    (1365 a rank)."""
    want, got = plan_case("eva02_large", "eva02_large", 4)
    assert got == want
    blk = "pc_encoder.transformer.blocks.23."
    assert got[blk + "attn.q_proj.weight"] == "col" and got[blk + "attn.proj.weight"] == "row"
    for leaf in ("mlp.fc1_g.weight", "mlp.fc1_x.weight", "mlp.norm.weight", "mlp.fc2.weight"):
        assert got[blk + leaf] is None, leaf
    want, got = plan_case("eva02_large", "eva02_large", 2)
    assert got == want and got[blk + "mlp.fc2.weight"] == "row"


def test_plan_fused_qkv_splits_each_third_by_heads():
    """An EVA-giant-shaped block (fused qkv with q / v biases, GELU MLP):
    the same leaves split as JAX's, with JAX's qkv/bias on the port's q_bias
    and v_bias. The placement differs: JAX cuts the [D, 3D] kernel's last
    axis contiguously (at 2 ranks rank 0 holds all of q and half of k); the
    port gives each rank its heads of q, of k and of v."""
    vj = J.ViTConfig(176, 2, 4, 352, swiglu=False, mlp_norm=False, qkv_fused=True)
    vp = P.ViTConfig(176, 2, 4, 352, swiglu=False, qkv_fused=True)
    want, got = plan_case(vj, vp, 2)
    assert got == want
    assert got["pc_encoder.transformer.blocks.0.attn.qkv.weight"] == "col"
    assert got["pc_encoder.transformer.blocks.0.attn.q_bias"] == "vec"
    D = 176
    w = torch.arange(3 * D, dtype=torch.float32)[:, None].expand(3 * D, 3)
    rows = [_slice("attn.qkv.weight", w, "col", r, 2)[:, 0].long() for r in range(2)]
    half = D // 2
    assert rows[0].tolist() == [*range(0, half), *range(D, D + half), *range(2 * D, 2 * D + half)]
    jax_rank0 = list(range(0, 3 * D // 2))  # all of q, then half of k
    assert rows[0].tolist() != jax_rank0
    assert sorted(torch.cat(rows).tolist()) == list(range(3 * D))


# ------------------------------------------------------------ the job
def spawn(d: Path) -> subprocess.Popen:
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + (os.pathsep + env["PYTHONPATH"]
                                     if env.get("PYTHONPATH") else "")
    return subprocess.Popen([sys.executable, str(WORKER), str(d)], cwd=str(REPO), env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def jax_model(vit="tiny"):
    """(JAX model, its perturbed variables)."""
    jm = J.PointCloudSAM(J.PointSAMConfig(vit=vit, tokenizer=J.TokenizerConfig(32, 16),
                                          prompt_iters=2))
    return jm, perturb(jax.tree_util.tree_map(np.asarray,
                                              J.init_variables(jm, jax.random.PRNGKey(0))))


def fused_vit():
    """FUSED_VIT in JAX's ViTConfig (no sub-LN)."""
    kw = dict(FUSED_VIT)
    return J.ViTConfig(kw.pop("embed_dim"), kw.pop("depth"), kw.pop("num_heads"),
                       kw.pop("mlp_hidden_dim"), mlp_norm=False, **kw)


def inputs():
    """(JAX model, variables, everything the job and JAX compute on)."""
    jm, v = jax_model()
    rng = np.random.default_rng(0)
    coords = rng.standard_normal((2, 512, 3)).astype(np.float32)
    coords /= np.abs(coords).max() + 1e-3
    feats = rng.random((2, 512, 3)).astype(np.float32)
    geom = jax.tree_util.tree_map(
        np.asarray, j_compute_geometry(jnp.asarray(coords), jm.cfg.tokenizer))
    gt = rng.random((2, 2, 512)) < 0.3
    ex = generate_scene(5, num_points=1500)
    xyz, rgb = normalize_scene(ex["coords"], ex["features"])
    scene = dict(xyz=xyz, rgb=rgb, gt=ex["gt_masks"][:2])
    drng = np.random.default_rng(1)
    dc = (drng.standard_normal((1, 1024, 3)) / 3).astype(np.float32)
    df = drng.random((1, 1024, 3)).astype(np.float32)
    decode = {}
    encode = jax.jit(lambda c, f, g: jm.apply(v, c, f, g, method=jm.encode))
    for name, n, g in (("G16", 1024, 16), ("G128", 1024, 128), ("G16-N1001", 1001, 16)):
        c, f = dc[:, :n], df[:, :n]
        dg = jax.tree_util.tree_map(
            np.asarray, j_compute_geometry(jnp.asarray(c), J.TokenizerConfig(g, 8)))
        emb, pe = encode(jnp.asarray(c), jnp.asarray(f), dg)
        decode[name] = dict(emb=np.asarray(emb), pe=np.asarray(pe), coords=c, geom=dg,
                            pc=c[:, :1], pl=np.ones((1, 1), bool))
    return jm, v, dict(encode=dict(coords=coords, features=feats, geom=geom),
                       batch=dict(coords=coords, features=feats, gt_masks=gt),
                       scene=scene, decode=decode, fused=jax_model(fused_vit()))


def jax_outputs(jm, v, x) -> dict:
    out = {}
    e = x["encode"]
    mesh = make_mesh_2d(1, 4, jax.devices()[:4])

    def encode(var, c, f, g):
        return jm.apply(var, c, f, g, method=jm.encode)

    emb, pe = jax.jit(encode)(tp_place(v, mesh), jnp.asarray(e["coords"]),
                              jnp.asarray(e["features"]), e["geom"])
    out["encode"] = (np.asarray(emb), np.asarray(pe))
    fm, fv = x["fused"]
    emb, pe = jax.jit(lambda var, c, f, g: fm.apply(var, c, f, g, method=fm.encode))(
        tp_place(fv, mesh), jnp.asarray(e["coords"]), jnp.asarray(e["features"]), e["geom"])
    out["encode_fused"] = (np.asarray(emb), np.asarray(pe))

    mesh = make_mesh_2d(2, 2, jax.devices()[:4])
    tx = j_make_optimizer(j_warmup(1e-3, [100], warmup_iters=5))
    buffers = {k: val for k, val in v.items() if k != "params"}
    state = TrainState.create(v["params"], buffers, tx)
    state = jax.tree_util.tree_map(jax.device_put, state, tp_sharding_tree(state, mesh))
    step = make_train_step(jm, tx, mesh, donate=False, param_sharding="tp",
                           state_example=state)
    batch = {k: jnp.asarray(val) for k, val in x["batch"].items()}
    s, m = step(state, batch, jax.random.PRNGKey(3))

    def loss_fn(params, batch, rng):  # make_train_step's, without the metrics
        outputs = jm.apply({"params": params, **buffers}, batch["coords"], batch["features"],
                           batch["gt_masks"], rngs={"sampler": rng})
        B, M, N = batch["gt_masks"].shape
        return J.criterion(outputs, batch["gt_masks"].reshape(B * M, N))[0]

    grad_fn = jax.jit(jax.value_and_grad(loss_fn), in_shardings=(
        tp_sharding_tree(v["params"], mesh), NamedSharding(mesh, PartitionSpec("data")),
        NamedSharding(mesh, PartitionSpec())))
    loss, grads = grad_fn(v["params"], batch, jax.random.PRNGKey(3))
    out["step"] = dict(loss=float(m["loss"]), grad_loss=float(loss), params=state_dict_from_flax(
        {"params": jax.device_get(s.params), **buffers}), grads=state_dict_from_flax(
        {"params": jax.device_get(grads), **buffers}))

    sc = x["scene"]
    ev = JEvaluator(jm, v, mesh=make_mesh(jax.devices()[:4]), **EVAL_KW)
    assert ev._use_sharded(2048, ev._tokenizer_for(len(sc["xyz"])))
    out["eval"] = ev.evaluate_scene(sc["xyz"], sc["rgb"], sc["gt"])

    smodel = J.for_sharded_eval(jm, make_mesh(jax.devices()[:4]))
    out["decode"] = {}
    for name, c in x["decode"].items():
        # JAX's point-sharded decode needs N divisible by the mesh: at N=1001
        # its unsharded decode is the reference.
        m = smodel if c["coords"].shape[1] % 4 == 0 else jm
        masks, iou = m.apply(v, jnp.asarray(c["emb"]), jnp.asarray(c["pe"]),
                             jnp.asarray(c["coords"]), c["geom"], jnp.asarray(c["pc"]),
                             jnp.asarray(c["pl"]), None, method=m.decode)
        out["decode"][name] = (np.asarray(masks), np.asarray(iou))
    return out


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    """The 4-rank job (spawned first), JAX's outputs while it runs."""
    d = tmp_path_factory.mktemp("tp_job")
    jm, v, x = inputs()
    torch.save(dict(state_dict=state_dict_from_flax(v),
                    fused_state_dict=state_dict_from_flax(x["fused"][1]), fused_vit=FUSED_VIT,
                    encode=dict(coords=t(x["encode"]["coords"]),
                                features=t(x["encode"]["features"]),
                                geom=tree_t(x["encode"]["geom"])),
                    batch=tree_t(x["batch"]), scene=tree_t(x["scene"]),
                    decode={k: dict(tree_t({n: c[n] for n in c if n != "geom"}),
                                    geom=tree_t(c["geom"]))
                            for k, c in x["decode"].items()}),
               d / "inputs.pt")
    proc = spawn(d)
    try:
        want = jax_outputs(jm, v, x)
    finally:
        out, _ = proc.communicate(timeout=600)
    assert proc.returncode == 0, out[-8000:]
    ranks = [torch.load(d / f"rank{r}.pt", weights_only=True) for r in range(4)]
    return dict(jax=want, ranks=ranks, x=x)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def max_diff(a: dict, b: dict) -> float:
    assert a.keys() <= b.keys()
    return max(float((a[k].float() - b[k].float()).abs().max()) for k in a)


def test_tp_encode_matches_jax_tp_place(job):
    want_emb, want_pe = job["jax"]["encode"]
    for r in job["ranks"]:
        emb, pe = r["encode"]
        np.testing.assert_allclose(emb.numpy(), want_emb, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(pe.numpy(), want_pe, rtol=RTOL, atol=ATOL)
        assert r["fc1_g_local"] == (256 // 4, 128)  # a quarter of the hidden axis


MASK_POINTNET = ("mask_encoder.patch_encoder.",)
POINTNETS = (*MASK_POINTNET, "pc_encoder.patch_embed.patch_encoder.")


def assert_grads_close(got: dict, want: dict, loose: tuple = MASK_POINTNET) -> None:
    """``got`` within 1e-4 of each tensor's largest ``want`` + 1e-7, the
    ``loose`` PointNets' within 5e-3; a parameter ``got`` lacks took no
    gradient, so ``want``'s must be zero."""
    assert set(got) <= set(want)
    for name, w in want.items():
        rel = 5e-3 if name.startswith(loose) else 1e-4
        g = got.get(name, torch.zeros_like(w))
        err = float((g.float() - w.float()).abs().max())
        assert err <= rel * float(w.abs().max()) + 1e-7, (name, err)


def test_tp_encode_fused_qkv_matches_jax_tp_place(job):
    """An EVA-giant-shaped ViT (fused qkv, GELU MLP) split over 4 ranks,
    each third of qkv by heads where JAX's rule cuts the kernel
    contiguously: the same numbers."""
    want_emb, want_pe = job["jax"]["encode_fused"]
    for r in job["ranks"]:
        emb, pe = r["encode_fused"]
        np.testing.assert_allclose(emb.numpy(), want_emb, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(pe.numpy(), want_pe, rtol=RTOL, atol=ATOL)
        assert r["fused_local"] == ((3 * 32, 128), (32,), 1)  # one head of 32 a rank


def test_tp_train_step_matches_jax(job):
    want = job["jax"]["step"]
    r0 = job["ranks"][0]["tp_step"]
    np.testing.assert_allclose(r0["metrics"]["loss"], want["loss"], rtol=RTOL)
    assert max_diff(r0["params"], want["params"]) < ATOL
    # The gradients: JAX's value_and_grad of the same loss over the same
    # mesh; its loss is the step's. Both PointNets' within 5e-3: a max-pool
    # near-tie within the packages' ~1e-6 forward difference sends a
    # column's gradient to another point (on this batch the cloud
    # encoder's PointNet is 4.3e-3 of its largest from JAX's, and the
    # port's one-process step the same; to one process below at 1e-4, the
    # mask prompt's PointNet, whose input is the previous click's logits,
    # at 5e-3 as in tests/test_torch_port_distributed.py).
    np.testing.assert_allclose(want["grad_loss"], want["loss"], rtol=1e-6)
    params = dict(job["ranks"][0]["one_step"]["params"])
    jax_grads = {k: g for k, g in want["grads"].items() if k in params}
    assert len(r0["grads"]) > 50
    assert_grads_close(r0["grads"], jax_grads, loose=POINTNETS)
    # Every rank: the same metrics and the same whole parameters; each holds
    # its slices after the step.
    for r in job["ranks"]:
        s = r["tp_step"]
        assert s["metrics"] == r0["metrics"] and s["count"] == 1
        assert max_diff(s["params"], r0["params"]) == 0.0
        assert s["local"]["pc_encoder.transformer.blocks.0.mlp.fc1_g.weight"] == (128, 128)
        assert s["local"]["pc_encoder.transformer.blocks.1.attn.proj.weight"] == (128, 64)
        assert s["local"]["pc_encoder.transformer.blocks.0.norm1.weight"] == (128,)
    assert {(r["tp_step"]["data_rank"], r["tp_step"]["model_rank"])
            for r in job["ranks"]} == {(0, 0), (0, 1), (1, 0), (1, 1)}
    # One process's step on the whole batch.
    one = job["ranks"][0]["one_step"]
    np.testing.assert_allclose(r0["metrics"]["loss"], one["metrics"]["loss"], rtol=RTOL)
    assert max_diff(one["params"], r0["params"]) < ATOL
    assert r0["grads"].keys() == one["grads"].keys()
    assert_grads_close(r0["grads"], one["grads"])
    for r in job["ranks"][1:]:
        assert max_diff(r["tp_step"]["grads"], r0["grads"]) == 0.0


def test_sharded_evaluator_matches_jax(job):
    ranks = job["ranks"]
    assert all(r["use_sharded"] for r in ranks)
    got = ranks[0]["eval"].numpy()
    assert got.shape == (2, 2) and np.isfinite(got).all()
    for r in ranks[1:]:
        assert torch.equal(r["eval"], ranks[0]["eval"])
    np.testing.assert_allclose(got, job["jax"]["eval"], atol=2e-2)
    np.testing.assert_allclose(got, ranks[0]["eval_one"].numpy(), atol=2e-2)


@pytest.mark.parametrize("name", ["G16", "G128", "G16-N1001"])
def test_point_sharded_decode_matches_jax(job, name):
    """At N=1001 the shards are 251 rows and rank 3's holds 248 real ones
    (padded, its extra logits dropped)."""
    want_masks, want_iou = job["jax"]["decode"][name]
    n = int(name.rsplit("N", 1)[-1]) if "-N" in name else 1024
    for r in job["ranks"]:
        masks, iou = r["decode"][name]
        assert masks.shape == want_masks.shape == (1, 3, n)
        np.testing.assert_allclose(masks.numpy(), want_masks, atol=ATOL)
        np.testing.assert_allclose(iou.numpy(), want_iou, atol=ATOL)
    one_masks, one_iou = job["ranks"][0]["decode_one"][name]
    np.testing.assert_allclose(job["ranks"][0]["decode"][name][0].numpy(), one_masks.numpy(),
                               atol=ATOL)
