"""Device ms a click inside the model's ``decode`` (prompt encoder and mask
decoder: the decode tail K4 / K11, the mask encoder's K2)."""

from psam_bench.readers import device_ms_per


def read(rec):
    if rec.get("loop") != "annotate":
        return None
    return device_ms_per(rec, "psam.decode", per="psam.decode")
