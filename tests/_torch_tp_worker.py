"""Worker of tests/test_torch_port_tensor_parallel.py: the port's tensor
parallelism and point-sharded evaluation on the CPU, four gloo ranks under
one ``torch.multiprocessing.spawn``.

    python tests/_torch_tp_worker.py <dir>

Reads ``<dir>/inputs.pt`` (the tiny model's weights, an EVA-giant-shaped
ViT's config and weights, the encode's cloud and geometry, the train
batch, the evaluator's scene, the decode's embeddings and geometries) and
writes ``<dir>/rank<r>.pt``:

- ``encode``: the ViT split over a model group of 4 (data 1, model 4);
  ``encode_fused`` the same for an EVA-giant-shaped ViT (fused qkv with
  q / v biases, GELU MLP);
- ``tp_step``: one train step at data 2 x model 2, each data group on its
  cloud of the batch: metrics, the gathered gradients the optimizer was
  handed (before the clip), the gathered post-step parameters, the local
  shapes after the step; rank 0 also ``one_step``, one process's step on
  the whole batch, with its gradients;
- ``eval``: the evaluator with ``group`` (the 4 ranks) on a scene at its
  top bucket; rank 0 also ``eval_one``, the evaluator without a group;
- ``decode``: ``for_sharded_eval``'s decode at each geometry; rank 0 also
  the unsharded decode.

Imports no JAX. A rank that raises makes the spawn raise with that rank's
traceback, and this script exit non-zero.
"""

from __future__ import annotations

import socket
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402

WORLD = 4
EVAL_KW = dict(num_clicks=2, point_buckets=(2048,), masks_per_batch=2, knn_method="exact")


def free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def tiny_model(state_dict, tokenizer=(32, 16), vit="tiny"):
    from point_sam_tpu_torch import models as P

    m = P.PointCloudSAM(P.PointSAMConfig(vit=vit, tokenizer=P.TokenizerConfig(*tokenizer),
                                         prompt_iters=2),
                        generator=torch.Generator().manual_seed(0))
    m.load_state_dict(state_dict, strict=True)
    return m


def optimizer(params):
    """tests/_torch_dist_worker.py's schedule: rate 1e-3 * 0.001 at count 0,
    weight decay 0.1, clip 1.0."""
    from point_sam_tpu_torch.parallel import make_optimizer
    from point_sam_tpu_torch.train import warmup_multistep

    return make_optimizer(params, warmup_multistep(1e-3, [100], warmup_iters=5),
                          weight_decay=0.1, max_grad_value=1.0)


def keep_grads(model, tx, gather=None) -> dict:
    """The gradients ``train_step`` hands ``tx`` (averaged over the data
    group, before the clip), filled in when it steps; ``gather`` maps them
    to the one-process layout."""
    grads, step = {}, tx.step

    def kept_step():
        g = {n: p.grad.detach().clone() for n, p in model.named_parameters()
             if p.grad is not None}
        grads.update(g if gather is None else gather(model, g))
        step()

    tx.step = kept_step
    return grads


def rank_main(rank: int, d: Path, port: int) -> None:
    from point_sam_tpu_torch.evalsuite.eval_interactive import InteractiveEvaluator
    from point_sam_tpu_torch.models import ViTConfig, for_sharded_eval
    from point_sam_tpu_torch.parallel import (
        initialize,
        shutdown,
        tp_gather_state_dict,
        tp_groups,
        tp_shard_model,
        train_step,
    )

    torch.set_num_threads(1)
    initialize(f"tcp://localhost:{port}", WORLD, rank, device="cpu")
    inp = torch.load(d / "inputs.pt", weights_only=True)
    sd = inp["state_dict"]
    out = {}

    # The encode over a model group of 4.
    model = tp_shard_model(tiny_model(sd), tp_groups(1, 4))
    e = inp["encode"]
    with torch.no_grad():
        out["encode"] = model.encode(e["coords"], e["features"], e["geom"])
    w = model.pc_encoder.transformer.blocks[0].mlp.fc1_g.weight
    out["fc1_g_local"] = tuple(w.shape)
    model = tp_shard_model(tiny_model(inp["fused_state_dict"], vit=ViTConfig(**inp["fused_vit"])),
                           tp_groups(1, 4))
    with torch.no_grad():
        out["encode_fused"] = model.encode(e["coords"], e["features"], e["geom"])
    attn = model.pc_encoder.transformer.blocks[0].attn
    out["fused_local"] = (tuple(attn.qkv.weight.shape), tuple(attn.q_bias.shape),
                          attn.num_heads)

    # One train step at data 2 x model 2.
    groups = tp_groups(2, 2)
    model = tp_shard_model(tiny_model(sd), groups)
    tx = optimizer(model.parameters())
    grads = keep_grads(model, tx, tp_gather_state_dict)
    batch = inp["batch"]
    mine = {k: v[groups.data_rank:groups.data_rank + 1] for k, v in batch.items()}
    m = train_step(model, tx, mine, torch.Generator().manual_seed(0))
    out["tp_step"] = dict(
        metrics={k: float(v) for k, v in m.items()}, grads=grads,
        params=tp_gather_state_dict(model),
        local={n: tuple(p.shape) for n, p in model.named_parameters()}, count=tx.count,
        plan=model.tp_plan, data_rank=groups.data_rank, model_rank=groups.model_rank)
    if rank == 0:
        ref = tiny_model(sd)
        tx = optimizer(ref.parameters())
        grads = keep_grads(ref, tx)
        m = train_step(ref, tx, batch, torch.Generator().manual_seed(0))
        out["one_step"] = dict(metrics={k: float(v) for k, v in m.items()}, grads=grads,
                               params={n: p.detach().clone() for n, p in ref.named_parameters()})

    # The evaluator, point-sharded over the 4 ranks at its top bucket.
    s = {k: v.numpy() for k, v in inp["scene"].items()}
    ev = InteractiveEvaluator(tiny_model(sd), device="cpu", group=dist.group.WORLD, **EVAL_KW)
    out["use_sharded"] = ev._use_sharded(2048, ev._tokenizer_for(len(s["xyz"])))
    out["eval"] = torch.from_numpy(ev.evaluate_scene(s["xyz"], s["rgb"], s["gt"]))
    if rank == 0:
        ev = InteractiveEvaluator(tiny_model(sd), device="cpu", **EVAL_KW)
        out["eval_one"] = torch.from_numpy(ev.evaluate_scene(s["xyz"], s["rgb"], s["gt"]))

    # The point-sharded decode at each geometry.
    out["decode"], out["decode_one"] = {}, {}
    for name, c in inp["decode"].items():
        model = tiny_model(sd)
        args = (c["emb"], c["pe"], c["coords"], c["geom"], c["pc"], c["pl"], None)
        with torch.no_grad():
            smodel = for_sharded_eval(model, dist.group.WORLD)
            out["decode"][name] = smodel.decode(*args)
            assert model.mask_decoder.point_group is None
            if rank == 0:
                out["decode_one"][name] = model.decode(*args)
    torch.save(out, d / f"rank{rank}.pt")
    shutdown()


def main() -> None:
    d = Path(sys.argv[1])
    mp.spawn(rank_main, args=(d, free_port()), nprocs=WORLD)


if __name__ == "__main__":
    main()
