"""The 95th percentile of the sensor cell's latencies, read per layer in its
traced runs: over every frame due in the untraced part of an open-loop
window, the time from when the frame was due to the moment its payload was
in hand (host clock); a frame still unfinished when the window closed
counts with the time it took.  Runs of this cell spread too widely between
processes for an end-to-end bound on the tail; ``encode_p50_ms`` holds it."""

import numpy as np


def read(r):
    lat = r.record.latencies_s
    if not lat:
        return None
    return float(np.percentile(np.asarray(lat) * 1e3, 95))
