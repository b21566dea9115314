"""Seconds from process start to the window's start: imports, the card's
context, the frames, the program's set-up and the warm-up pass (host
clock)."""


def read(r):
    return r.record.setup_s
