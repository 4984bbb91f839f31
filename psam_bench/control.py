"""Readings for the comparison's limits: the program's numbers over many
seeds, and the control's, the plain reference put in the program's place
one precision below what the configuration states (float8 e4m3 products in
the network, bfloat16 geometry), on the same requests.

    python3 -m psam_bench.control --workload <cell> --seeds 1 2 3 ... \\
        --control-seeds 1 2 3 --seconds 5 [--fault <fault>] [--out chiprun_out/control.jsonl]

Each seed runs the cell's set-up and a short window at the cell's load
(the comparison then covers what that window served), then the program's
numbers (with ``--fault``, the program with that fault planted: a reading
the limits must fail); on the control seeds also the control's (the
loop's ``control``). One JSON line a reading. The benchmark's own runs
never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from . import run, spec
from .reference import model as ref

LOWER = {"control": ref.Prec("fp8", "bf16"), "fp8_net_only": ref.Prec("fp8", "fp32"),
         "bf16_geometry_only": ref.Prec("fp32", "bf16")}


def readings(bench, name, seed, seconds, control: bool, device, config=None, traffic=None,
             faults=()):
    """[(what, numbers, detail)] of one seed: the program's, and with
    ``control`` the control's and each of its two parts alone."""
    out = run.run_cell(bench, name, seed, seconds, False, device, limits={}, config=config,
                       traffic=traffic, faults=faults)
    rows = [("program", out["numbers"], None)]
    if control:
        ctx, loop = out["ctx"], out["loop"]
        for what, prec in LOWER.items():
            rows.append((what, *loop.control(ctx, out["state"], prec)))
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m psam_bench.control", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--fault", action="append", default=[])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("psam_bench.control: no CUDA card", file=sys.stderr)
        return 2
    bench = spec.load()
    out = open(args.out, "a") if args.out else None
    try:
        for seed in args.seeds:
            t0 = time.perf_counter()
            for what, numbers, detail in readings(bench, args.workload, seed, args.seconds,
                                                  seed in args.control_seeds,
                                                  torch.device("cuda"), faults=tuple(args.fault)):
                row = dict(workload=args.workload, seed=seed, what=what, faults=args.fault,
                           numbers=numbers, detail=detail, seconds=time.perf_counter() - t0)
                print(json.dumps(row), flush=True)
                if out:
                    out.write(json.dumps(row) + "\n")
                    out.flush()
            torch.cuda.empty_cache()
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
