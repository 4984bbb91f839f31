"""What the per-layer readers (``psam_bench/metrics/<metric>.py``) share:
device time by benchmark range, the kernels' roofline share, the share of
the card's peak, the idle share. Each takes the records of a traced run
(``trace.read`` and what the run adds) and returns None where they hold
nothing to read."""

from __future__ import annotations

from collections import defaultdict

from . import work


def device_ms_per(rec: dict, *ranges: str, per: str) -> float | None:
    """Device ms launched inside the ``ranges`` over the count of ``per``."""
    got = rec.get("ranges", {})
    n = len(got.get(per, []))
    us = sum(x["device_us"] for r in ranges for x in got.get(r, []))
    return us / n / 1e3 if n and us > 0 else None


def roofline_pct(rec: dict, scope: str, launches: dict) -> float | None:
    """The least time of the hand-written kernels launched inside ``scope``
    (``work.kernel_work`` at each launch shape the program's counters
    recorded, ``work.bound``) over those kernels' device time, in %. A
    family whose work a launch key cannot give is left out of both sums."""
    dev_us = defaultdict(float)
    for name, us in rec.get("kernels_in", {}).get(scope, {}).items():
        fam = work.family_of(name)
        if fam:
            dev_us[fam] += us
    owner = {w: fam for fam, (_, ws) in work.FAMILIES.items() for w in ws}
    least, skip = defaultdict(float), set()
    for wrapper, shapes in launches.items():
        fam = owner[wrapper]
        for key, n in shapes.items():
            w = work.kernel_work(fam, dict(key), rec.get("n_real"))
            if w is None:
                skip.add(fam)
            else:
                least[fam] += n * work.bound(*w)[0]
    fams = [f for f in dev_us if f in least and f not in skip and dev_us[f] > 0]
    if not fams:
        return None
    return 100.0 * sum(least[f] for f in fams) / (sum(dev_us[f] for f in fams) / 1e6)


def mfu_pct(rec: dict, scope: str, flops_each: float | None) -> float | None:
    """FLOPs of the ``scope`` calls over their wall time (each from its
    host start to the later of its host end and its last device
    operation), over the card's bf16 peak, in %."""
    calls = rec.get("ranges", {}).get(scope, [])
    if not calls or not flops_each or not rec.get("busy_s"):
        return None
    wall_us = sum(max(c["end"], c["dev_last"] or c["end"]) - c["ts"] for c in calls)
    return 100.0 * flops_each * len(calls) / (wall_us / 1e6) / work.MFU_PEAK


def idle_pct(rec: dict) -> float | None:
    if not rec.get("window_s"):
        return None
    return 100.0 * (1.0 - rec["busy_s"] / rec["window_s"])
