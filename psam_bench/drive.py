"""What the loops (``psam_bench/loops/<loop>.py``) share: the run's
context, seeds, the program's model with its seeded weights, the measured
window, the program's kernel counters, the run's log.

A loop's ``run(ctx)`` does a cell's set-up, calls ``window`` with its
request (a session, a step), adds a traced part when ``ctx.traced``, frees
the program and has the plain reference recompute what the window served.
It returns ``metrics`` (the end-to-end values), ``numbers`` (what the
comparison reads), ``records`` (what the per-layer readers take, or
None), ``peak`` (device bytes), ``done`` (requests completed) and
``state`` (what its ``control(ctx, state, prec)`` needs to put the
reference, at a lower precision, in the program's place).

Nothing is compiled inside the window: set-up runs every shape the window
runs. A request that starts before the window's end completes, and the
window ends with it.
"""

from __future__ import annotations

import dataclasses
import gc
import os
import sys
import time

import numpy as np

from . import weights, work


@dataclasses.dataclass
class Ctx:
    torch: object
    config: dict
    traffic: dict
    seed: int
    seconds: float
    traced: bool
    device: object
    tmpdir: str
    kind: object  # the configuration's model kind: ``reference/<kind>.py``
    faults: tuple = ()


def seeds(seed: int, n: int) -> list:
    """n independent 62-bit seeds from ``seed``."""
    return [int(x) for x in np.random.default_rng([seed, 0x5EED]).integers(0, 1 << 62, n)]


def build_model(ctx: Ctx, seed: int):
    """The program's model of the configuration, its weights made on the
    device from ``seed``; the parameters' shapes by name."""
    torch = ctx.torch
    from point_sam_tpu_torch.models.vit import ViTConfig
    from point_sam_tpu_torch.utils.config import build_model as program_build

    mc = dict(ctx.config["model"])
    mc["vit"] = ViTConfig(**mc["vit"])
    dtype = torch.bfloat16 if ctx.device.type == "cuda" else torch.float32
    model = program_build(mc, dtype=dtype, device="meta").to_empty(device=ctx.device)
    weights.fill(model, seed)
    return model, weights.shapes_of(model)


def reference_params(ctx: Ctx, shapes: dict, seed: int) -> dict:
    """The same seeded weights in fp32, for the reference."""
    return weights.seeded_state(shapes, seed, ctx.device)


def ref_config(cfg: dict) -> dict:
    """What the reference reads of a configuration."""
    m = cfg["model"]
    return dict(vit=m["vit"], decoder=m["decoder"], embed_dim=m["embed_dim"],
                patch_embed_channels=m["patch_embed_channels"],
                num_multimask_outputs=m["num_multimask_outputs"], in_channels=cfg["in_channels"],
                tokenizer=m["tokenizer"], mask_hidden_dim=cfg.get("mask_hidden_dim"))


def synchronize(ctx: Ctx) -> None:
    if ctx.device.type == "cuda":
        ctx.torch.cuda.synchronize()


def log(msg: str) -> None:
    """A line on standard error, with the process's age."""
    print(f"psam_bench [{process_age():.1f} s] {msg}", file=sys.stderr, flush=True)


def p95(values) -> float:
    return float(np.percentile(np.asarray(values, np.float64), 95))


def free(ctx: Ctx) -> None:
    """Give the device's cached blocks back once the program's objects are
    dropped, before the reference runs."""
    gc.collect()
    if ctx.device.type == "cuda":
        ctx.torch.cuda.empty_cache()


def process_age() -> float:
    """Seconds since this process started (from /proc), or since the
    harness was imported where /proc cannot say."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return up - start / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _IMPORTED


_IMPORTED = time.perf_counter()


def window(ctx: Ctx, fn, keep: int, res_seed: int) -> dict:
    """Run ``fn(i, keep_it)`` until ``ctx.seconds`` have passed (the last
    call completes). Keeps a uniform sample of ``keep`` calls' returns,
    drawn from ``res_seed`` (reservoir sampling). Returns the set-up
    seconds (the process's age at the window's start), the window's
    seconds, the calls done, the peak device memory and the kept returns."""
    torch = ctx.torch
    synchronize(ctx)
    if ctx.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    rng = np.random.default_rng(res_seed)
    kept = []
    setup_s = process_age()
    t0 = time.perf_counter()
    i = 0
    while True:
        slot = i if i < keep else int(rng.integers(0, i + 1))
        item = fn(i, slot < keep)
        if slot < keep:
            if slot < len(kept):
                kept[slot] = item
            else:
                kept.append(item)
        i += 1
        if time.perf_counter() - t0 >= ctx.seconds:
            break
    synchronize(ctx)
    window_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() if ctx.device.type == "cuda" else 0
    return dict(setup_s=setup_s, window_s=window_s, done=i, peak=peak, kept=kept)


def counters() -> dict:
    """The program's counted kernel wrappers by ``module:function``."""
    import importlib

    out = {}
    for _, wrappers in work.FAMILIES.values():
        for w in wrappers:
            mod, fn = w.split(":")
            out[w] = getattr(importlib.import_module(mod), fn)
    return out


def snapshot(counters: dict) -> dict:
    return {w: dict(fn.shapes) for w, fn in counters.items()}


def diff(after: dict, before: dict) -> dict:
    out = {}
    for w, shapes in after.items():
        d = {k: n - before[w].get(k, 0) for k, n in shapes.items() if n - before[w].get(k, 0)}
        if d:
            out[w] = d
    return out


def add(total: dict, part: dict) -> None:
    for w, shapes in part.items():
        t = total.setdefault(w, {})
        for k, n in shapes.items():
            t[k] = t.get(k, 0) + n

