"""Run one cell of the benchmark once.

    python3 -m psam_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the CUDA cards the cell asks
for. With ``--trace 0`` the last line of standard output is the JSON
result with the cell's end-to-end metrics; with ``--trace 1`` the same run
is followed by a profiled part and the line carries the cell's per-layer
metrics, the device's busy and window seconds and a breakdown. Either way
the run ends with the comparison against the plain reference (``correct``),
whose numbers and limits are the last lines of standard error and the last
key of the result. Without the cards, or if a module of JAX or of the JAX
package was loaded, it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

from . import check, drive, spec

FORBIDDEN = ("jax", "jaxlib", "flax", "point_sam_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's
    (compared whole: ``point_sam_tpu_torch`` is the program)."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def run_cell(bench: dict, name: str, seed: int, seconds: float, traced: bool, device,
             faults: tuple = (), limits: dict | None = None, config: dict | None = None,
             traffic: dict | None = None) -> dict:
    """One run of cell ``name``; returns the result line's dict and what
    the comparison read. ``limits`` / ``config`` / ``traffic`` replace the
    cell's files (the harness's own tests run tiny sizes on the CPU)."""
    import torch

    cell = spec.cell(bench, name)
    cfg = config or cell["config_data"]
    traffic = traffic or cell["traffic_data"]
    loop = spec.loop(bench, traffic)
    ctx = drive.Ctx(torch=torch, config=cfg, traffic=traffic, seed=seed, seconds=seconds,
                    traced=traced, device=device,
                    tmpdir=os.environ.get("TMPDIR") or tempfile.gettempdir(),
                    kind=spec.kind(bench, cfg), faults=tuple(faults))
    if device.type == "cuda":
        from point_sam_tpu_torch.ops import _cuda

        _cuda.library()  # the kernels, built on a checkout's first run
    res = loop.run(ctx)
    correct, shown = check.judge(res["numbers"], limits if limits is not None else cell["limits"])

    metrics = {}
    if traced:
        rec = dict(res["records"] or {}, cell=name, config=cfg)
        for m in spec.per_layer(bench, name):
            value = spec.reader(bench, m["name"])(rec)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in spec.end_to_end(bench, name):
            metrics[m["name"]] = {"value": res["metrics"][m["name"]], "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": cell["chips"], "memory_peak_bytes": res["peak"]}
    line = {"correct": correct, "attempted": res["done"], "failed": 0, "metrics": metrics,
            "device": dev}
    if traced:
        rec = res["records"] or {}
        dev["busy_s"] = rec.get("busy_s", 0.0)
        dev["window_s"] = rec.get("window_s", 0.0)
        line["breakdown"] = {"device_ops": rec.get("device_ops", []),
                             "idle_gaps": rec.get("idle_gaps", [])}
    line["checks"] = shown
    return dict(line=line, numbers=res["numbers"], state=res["state"], ctx=ctx, loop=loop)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m psam_bench.run", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = spec.load()
    chips = spec.cell(bench, args.workload)["chips"]

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"psam_bench: the cell needs {chips} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    out = run_cell(bench, args.workload, args.seed, args.seconds, bool(args.trace),
                   torch.device("cuda"))
    bad = forbidden_modules()
    if bad:
        print(f"psam_bench: modules of JAX or of the JAX package were loaded: {bad}",
              file=sys.stderr)
        return 3
    for k, v in sorted(out["numbers"].items()):
        if k not in out["line"]["checks"]:
            print(f"reading {k} {v!r} (not compared)", file=sys.stderr)
    for k, v in out["line"]["checks"].items():
        verdict = "ok" if v["value"] is not None and v["value"] <= v["limit"] else "FAILED"
        print(f"check {k} {v['value']!r} limit {v['limit']!r} {verdict}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out["line"]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
