"""The median, over every frame due in an open-loop window, of the time
from when the frame was due to the moment its payload was in hand (host
clock); a frame still unfinished when the window closed counts with the
time it took.  It reads the same latencies as ``encode_p95_ms.sensor``."""

import numpy as np


def read(r):
    lat = r.record.latencies_s
    if not lat:
        return None
    return float(np.percentile(np.asarray(lat) * 1e3, 50))
