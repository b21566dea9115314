"""Frames a closed-loop encode completed in the window, over the window's
seconds (host clock)."""


def read(r):
    rec = r.record
    if rec.loop != "closed":
        return None
    return rec.frames_done / rec.window_s
