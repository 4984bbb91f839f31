"""The encodes' model FLOPs (``work.encode_flops``) over their wall time,
as a share of the card's bf16 peak."""

from psam_bench.readers import mfu_pct


def read(rec):
    if rec.get("loop") != "annotate":
        return None
    return mfu_pct(rec, "psam.set_pointcloud", rec.get("encode_flops"))
