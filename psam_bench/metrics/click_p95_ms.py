"""95th percentile of the host's time a click (``Predictor.predict_masks``,
logits to the host) over the window's clicks."""

import numpy as np


def read(rec):
    clicks = rec.get("host", {}).get("click_ms")
    return float(np.percentile(clicks, 95)) if clicks else None
