"""The share of the traced annotation sessions' span in which no kernel,
copy or fill ran on the device."""

from psam_bench.readers import idle_pct


def read(rec):
    return idle_pct(rec) if rec.get("loop") == "annotate" else None
