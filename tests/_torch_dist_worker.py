"""Worker of tests/test_torch_port_distributed.py: the port's multi-process
cases on the CPU, two gloo ranks under one ``torch.multiprocessing.spawn``.

    python tests/_torch_dist_worker.py steps <dir>
    python tests/_torch_dist_worker.py trainer <dir>

``steps`` reads ``<dir>/inputs.pt`` (the tiny model's weights, the global
batch, the geometry's clouds) and writes ``<dir>/rank<r>.pt``: the DDP
step at accum_steps 1 and 2, the FSDP step with each rank's shard sizes,
a tiny hier step with accum_steps 2 under DDP and under FSDP (its ViT
recomputed in the backward), and the sharded geometry; rank 0
also runs the one-process steps on the global batch. ``trainer`` runs
``trainer.main`` (tiny config): one-process runs in this process, the
2-rank DDP and FSDP runs and resumes in the spawned ranks, and writes
``<dir>/trainer.pt``. Imports no JAX. A rank that raises makes the spawn
raise with that rank's traceback, and this script exit non-zero.
"""

from __future__ import annotations

import io
import os
import shutil
import socket
import sys
from contextlib import redirect_stdout
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import torch  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402

WORLD = 2
BATCH = 8  # the global batch of the step cases (tests/test_fsdp.py's)


def free_ports(n: int) -> list[int]:
    socks = [socket.socket() for _ in range(n)]
    for s in socks:
        s.bind(("localhost", 0))
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


def tiny_model(state_dict):
    from point_sam_tpu_torch import models as P

    m = P.PointCloudSAM(P.PointSAMConfig(vit="tiny", tokenizer=P.TokenizerConfig(16, 8),
                                         prompt_iters=2),
                        generator=torch.Generator().manual_seed(0))
    m.load_state_dict(state_dict, strict=True)
    return m


def tiny_hier(seed=0):
    from point_sam_tpu_torch import models as P

    return P.PointCloudSAMHier(
        P.HierConfig(vit="tiny", tokenizer=P.HierTokenizerConfig((32, 8), (8, 4), (0.05, 0.1)),
                     prompt_iters=3),
        generator=torch.Generator().manual_seed(seed))


def optimizer(params):
    """A real schedule: the rate at count 0 is 1e-3 * 0.001, weight decay
    0.1, clip 1.0 (the JAX tests' make_optimizer(warmup_multistep(1e-3,
    [100], warmup_iters=5)))."""
    from point_sam_tpu_torch.parallel import make_optimizer
    from point_sam_tpu_torch.train import warmup_multistep

    return make_optimizer(params, warmup_multistep(1e-3, [100], warmup_iters=5),
                          weight_decay=0.1, max_grad_value=1.0)


def step_record(net, tx, metrics, gen) -> dict:
    from torch.distributed.tensor import DTensor

    def full(t):
        return t.full_tensor() if isinstance(t, DTensor) else t

    return dict(metrics={k: float(v) for k, v in metrics.items()},
                params={n: full(p.detach()).clone() for n, p in net.named_parameters()},
                grads={n: full(p.grad).clone() for n, p in net.named_parameters()},
                count=tx.count, generator=gen.get_state())


def steps_rank(rank: int, d: Path, port: int) -> None:
    from point_sam_tpu_torch.parallel import (
        initialize,
        shard_model,
        sharded_knn,
        sharded_min_sq_dist_to_complement,
        shutdown,
        train_step,
        wrap_ddp,
    )

    torch.set_num_threads(1)
    initialize(f"tcp://localhost:{port}", WORLD, rank, device="cpu")
    inp = torch.load(d / "inputs.pt", weights_only=True)
    sd, batch = inp["state_dict"], inp["batch"]
    loc = BATCH // WORLD
    mine = {k: v[rank * loc:(rank + 1) * loc] for k, v in batch.items()}
    out = {}

    for accum in (1, 2):
        model = wrap_ddp(tiny_model(sd), "cpu")
        tx = optimizer(model.parameters())
        gen = torch.Generator().manual_seed(0)
        m = train_step(model, tx, mine, gen, accum_steps=accum)
        out[f"ddp{accum}"] = step_record(model.module, tx, m, gen)
        if rank == 0:  # the one-process step on the global batch
            ref = tiny_model(sd)
            tx = optimizer(ref.parameters())
            gen = torch.Generator().manual_seed(0)
            m = train_step(ref, tx, batch, gen, accum_steps=accum)
            out[f"one{accum}"] = step_record(ref, tx, m, gen)

    model = shard_model(tiny_model(sd), "cpu")
    tx = optimizer(model.parameters())
    gen = torch.Generator().manual_seed(0)
    m = train_step(model, tx, mine, gen)
    shards = {}
    for n, p in model.named_parameters():
        st = tx.opt.state[p]
        shards[n] = dict(numel=p.numel(), local=p.to_local().numel(),
                         exp_avg=st["exp_avg"].to_local().numel(),
                         exp_avg_sq=st["exp_avg_sq"].to_local().numel(),
                         placements=str(p.placements))
    out["fsdp"] = dict(step_record(model, tx, m, gen), shards=shards)

    # The hier model: refinement draws in 3 iterations and the random
    # sampler's noise, 2 ranks x 2 micro-batches against one process.
    hb = {k: v[:4] for k, v in batch.items()}
    model = wrap_ddp(tiny_hier(), "cpu")
    tx = optimizer(model.parameters())
    gen = torch.Generator().manual_seed(5)
    m = train_step(model, tx, {k: v[rank * 2:(rank + 1) * 2] for k, v in hb.items()}, gen,
                   accum_steps=2)
    out["hier_ddp"] = step_record(model.module, tx, m, gen)
    # The same under FSDP: the hier ViT recomputes each block in the
    # backward (non-reentrant checkpoint) inside its FSDP unit.
    model = shard_model(tiny_hier(), "cpu")
    assert model.pc_encoder.transformer.remat
    tx = optimizer(model.parameters())
    gen = torch.Generator().manual_seed(5)
    m = train_step(model, tx, {k: v[rank * 2:(rank + 1) * 2] for k, v in hb.items()}, gen,
                   accum_steps=2)
    out["hier_fsdp"] = step_record(model, tx, m, gen)
    if rank == 0:
        ref = tiny_hier()
        tx = optimizer(ref.parameters())
        gen = torch.Generator().manual_seed(5)
        m = train_step(ref, tx, hb, gen, accum_steps=2)
        out["hier_one"] = step_record(ref, tx, m, gen)

    g = inp["geometry"]
    n = g["keys"].shape[1] // WORLD
    part = slice(rank * n, (rank + 1) * n)
    for name, valid in (("knn", None), ("knn_valid", g["key_valid"][:, part])):
        out[name] = sharded_knn(g["query"], g["keys"][:, part], g["k"], method="exact",
                                key_valid=valid)
    n = g["coords"].shape[1] // WORLD
    part = slice(rank * n, (rank + 1) * n)
    out["border"] = sharded_min_sq_dist_to_complement(
        g["coords"][:, part], g["regions"][..., part], g["coords"], g["regions"])
    torch.save(out, d / f"rank{rank}.pt")
    shutdown()


def trainer_args(run_dir: Path, *extra) -> list:
    return ["--config", "tiny", "--device", "cpu", f"project_dir={run_dir}",
            "num_samples=256", "train_dataset.dataset.num_scenes=8",
            "train_dataset.dataset.points_per_scene=512", "val_dataset.dataset.num_scenes=2",
            "val_dataset.dataset.points_per_scene=512", "train_dataloader.batch_size=4",
            "scheduler.warmup_iters=2", "log_freq=1", "val_freq=0", "max_steps=2", *extra]


def run_trainer(run_dir: Path, *extra) -> dict:
    from point_sam_tpu_torch.train import trainer

    from torch.distributed.tensor import DTensor

    buf = io.StringIO()
    with redirect_stdout(buf):
        r = trainer.main(trainer_args(run_dir, *extra))
    shards = {}  # an FSDP rank's shards of each parameter and its moments
    state = r["optimizer"].opt.state
    for n, p in r["model"].named_parameters():
        if isinstance(p, DTensor):
            shards[n] = dict(dim=p.placements[0].dim, param=p.to_local().detach().clone(),
                             **{k: state[p][k].to_local().clone()
                                for k in ("exp_avg", "exp_avg_sq")})
    return dict(losses=[h["loss"] for h in r["history"]], step=r["step"],
                count=r["optimizer"].count, val=r["val"], stdout=buf.getvalue(), shards=shards)


# The 2-rank trainer runs, in order: (name, overrides).
TRAINER_RUNS = (
    ("ddp", ()),
    ("fsdp", ("param_sharding=fsdp", "val_freq=1", "vis_freq=1")),
    ("fsdp_from_one", ("param_sharding=fsdp", "max_steps=4")),
    ("fsdp_from_w2", ("param_sharding=fsdp", "max_steps=4")),
)


def trainer_rank(rank: int, d: Path, ports: list) -> None:
    torch.set_num_threads(1)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(WORLD), LOCAL_RANK=str(rank),
                      MASTER_ADDR="localhost")
    out = {}
    for (name, extra), port in zip(TRAINER_RUNS, ports):
        os.environ["MASTER_PORT"] = str(port)
        out[name] = run_trainer(d / name, *extra)
        if name == "fsdp" and rank == 0:  # the resume below starts from a copy
            shutil.copytree(d / "fsdp", d / "fsdp_from_w2")
    torch.save(out, d / f"trainer{rank}.pt")


def main() -> None:
    mode, d = sys.argv[1], Path(sys.argv[2])
    if mode == "steps":
        mp.spawn(steps_rank, args=(d, free_ports(1)[0]), nprocs=WORLD)
        return
    torch.set_num_threads(1)
    one = {"one": run_trainer(d / "one")}
    shutil.copytree(d / "one", d / "one_2steps")
    shutil.copytree(d / "one", d / "fsdp_from_one")
    mp.spawn(trainer_rank, args=(d, free_ports(len(TRAINER_RUNS))), nprocs=WORLD)
    # One process resuming the 2-rank FSDP checkpoint, and its own.
    shutil.copytree(d / "fsdp", d / "one_from_w2")
    one["one_from_w2"] = run_trainer(d / "one_from_w2", "max_steps=4")
    one["one_resume"] = run_trainer(d / "one", "max_steps=4")
    torch.save(one, d / "trainer.pt")


if __name__ == "__main__":
    main()
