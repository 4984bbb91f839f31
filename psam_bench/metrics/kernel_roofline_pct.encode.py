"""The roofline share of the hand-written kernels that launch in the
encodes (``Predictor.set_pointcloud``)."""

from psam_bench.readers import roofline_pct


def read(rec):
    if rec.get("loop") != "annotate":
        return None
    return roofline_pct(rec, "psam.set_pointcloud", rec["launches"]["encode"])
