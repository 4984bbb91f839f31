"""Device ms an encode inside the model's ``make_geometry`` and
``prompt_cache`` (FPS, kNN or the voronoi assignment, the 3-NN weights,
the mask prompt's cached offsets)."""

from psam_bench.readers import device_ms_per


def read(rec):
    if rec.get("loop") != "annotate":
        return None
    return device_ms_per(rec, "psam.geometry", "psam.prompt_cache", per="psam.set_pointcloud")
