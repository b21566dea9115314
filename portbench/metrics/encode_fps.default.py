"""``encode_fps`` of the 64E archive cell, read per layer in its traced
runs: frames a closed-loop encode completed over the untraced part of the
window, over that part's seconds (host clock).  Runs of this cell spread
too widely between processes for an end-to-end bound."""


def read(r):
    rec = r.record
    if rec.loop != "closed":
        return None
    return rec.frames_done / rec.window_s
