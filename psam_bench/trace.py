"""The traced part of a run: a torch.profiler session over a few sessions or
steps, read back from its Chrome trace into what the per-layer readers
take.

Kernels are tied to the host ranges that launched them by the profiler's
correlation ids (a launch call on the host, made while a range ran, and its
kernel on the device share one). The ranges are ``torch.profiler.record_function``
ranges that the benchmark puts around its own calls and, in traced runs
only, around the model's methods (``instrument``). The device's busy time
is the union of its kernels', copies' and fills' intervals; an idle gap is
labelled by the benchmark range and the host operation that were running
when it began.
"""

from __future__ import annotations

import bisect
import json
import os
import re
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
RANGE_PREFIX = "psam."
MIN_GAP_US = 2.0


def instrument(torch, obj, names: dict) -> None:
    """Wrap methods of ``obj`` (an instance) in record_function ranges:
    ``names`` maps a method name to its range name. The wrapper lives on
    the instance only, and only for the traced part of a run."""
    for method, label in names.items():
        fn = getattr(obj, method)

        def wrapped(*a, _fn=fn, _label=label, **k):
            with torch.profiler.record_function(_label):
                return _fn(*a, **k)

        setattr(obj, method, wrapped)


def uninstrument(obj, names: dict) -> None:
    for method in names:
        if method in vars(obj):
            delattr(obj, method)


def profile(torch, fn, warmup: int, active: int, path: str, cuda: bool = True) -> None:
    """Run ``fn(i)`` for ``warmup + active`` iterations under the profiler,
    recording only the ``active`` ones, to a Chrome trace at ``path``. The
    warm-up iterations run traced and are dropped: after earlier sessions
    the profiler lost a session's first kernel unless it warmed up on the
    same work."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    sched = torch.profiler.schedule(wait=0, warmup=warmup, active=active, repeat=1)
    with torch.profiler.profile(activities=acts, schedule=sched,
                                on_trace_ready=lambda p: p.export_chrome_trace(path)) as prof:
        for i in range(warmup + active):
            fn(i)
            if cuda:
                torch.cuda.synchronize()
            prof.step()


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1][1] = b
        else:
            out.append([a, b])
    return out


def short_name(name: str) -> str:
    name = re.sub(r"^void |at::native::|at::|\(anonymous namespace\)::", "", name)
    return re.sub(r"\(.*$", "", name)[:100]


def read(path: str, scopes: tuple) -> dict:
    """The trace at ``path`` (deleted after) -> records: per benchmark
    range its instances with their device time and kernels by name; the
    window (from the first ``scopes`` range to the last device operation),
    the device's busy seconds in it, the top device operations and the idle
    gaps by what the host was doing."""
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    os.remove(path)
    dev, launches, ranges, ops = [], {}, [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        ts, dur = float(e.get("ts", 0)), float(e.get("dur", 0))
        args = e.get("args") or {}
        if cat in DEVICE_CATS:
            dev.append((ts, ts + dur, e.get("name", ""), args.get("correlation")))
        elif cat in ("cuda_runtime", "cuda_driver"):
            if args.get("correlation") is not None:
                launches[args["correlation"]] = (ts,)
        elif cat == "user_annotation" and e.get("name", "").startswith(RANGE_PREFIX):
            ranges.append((ts, ts + dur, e["name"], e.get("tid")))
        elif cat == "cpu_op":
            ops.append((ts, ts + dur, e.get("name", ""), e.get("tid")))
    dev.sort()
    ranges.sort()
    ops.sort()

    # Each device operation's launch time on the host. A range owns what
    # any thread launched while it ran: autograd's backward launches from
    # its own thread while the range's thread waits.
    by_launch = sorted((launches[c][0], i) for i, (_, _, _, c) in enumerate(dev) if c in launches)
    launch_ts = [x[0] for x in by_launch]
    out_ranges = defaultdict(list)
    kernels_in = defaultdict(lambda: defaultdict(float))
    for a, b, name, _ in ranges:
        lo, hi = bisect.bisect_left(launch_ts, a), bisect.bisect_right(launch_ts, b)
        us, first, last = 0.0, None, None
        for _, i in by_launch[lo:hi]:
            s, t, kname, _ = dev[i]
            us += t - s
            kernels_in[name][kname] += t - s
            first = s if first is None else min(first, s)
            last = t if last is None else max(last, t)
        out_ranges[name].append(dict(ts=a, end=b, device_us=us, dev_first=first, dev_last=last))

    scoped = [r for r in ranges if r[2] in scopes]
    if not scoped or not dev:
        return dict(ranges=dict(out_ranges), kernels_in={}, busy_s=0.0, window_s=0.0,
                    device_ops=[], idle_gaps=[])
    w0 = scoped[0][0]
    w1 = max(max(r[1] for r in scoped), max(d[1] for d in dev))
    busy = _merge((max(s, w0), min(t, w1)) for s, t, _, _ in dev if t > w0 and s < w1)
    busy_us = sum(b - a for a, b in busy)

    per_op = defaultdict(float)
    for s, t, name, _ in dev:
        if t > w0 and s < w1:
            per_op[short_name(name)] += t - s
    device_ops = sorted(per_op.items(), key=lambda kv: -kv[1])[:10]

    main_tid = scoped[0][3]
    host_ops = [o for o in ops if o[3] == main_tid]
    op_starts = [o[0] for o in host_ops]
    rng_starts = [r[0] for r in ranges]
    gaps = defaultdict(float)
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    for a, b in zip(edges[::2], edges[1::2]):
        if b - a < MIN_GAP_US:
            continue
        gaps[_host_label(a, ranges, rng_starts) + " / " + _host_label(a, host_ops, op_starts)] += b - a
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:10]
    return dict(ranges=dict(out_ranges), kernels_in={k: dict(v) for k, v in kernels_in.items()},
                busy_s=busy_us / 1e6, window_s=(w1 - w0) / 1e6,
                device_ops=[[n, us / 1e6] for n, us in device_ops],
                idle_gaps=[[n, us / 1e6] for n, us in idle])


def _host_label(t: float, spans: list, starts: list, look: int = 4000) -> str:
    """The innermost span (the latest to start) running at ``t``; "python"
    where none is (the host runs the interpreter between operations)."""
    i = bisect.bisect_right(starts, t)
    for j in range(i - 1, max(-1, i - 1 - look), -1):
        if spans[j][1] >= t:
            return spans[j][2]
    return "python"
