"""Device ms an encode inside the model's ``encode`` (patch encoder, ViT,
projections)."""

from psam_bench.readers import device_ms_per


def read(rec):
    if rec.get("loop") != "annotate":
        return None
    return device_ms_per(rec, "psam.encode", per="psam.set_pointcloud")
