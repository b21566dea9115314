"""The share of the traced window in which no operation (kernel, copy or
set) ran on the card, in % (the profiler's device trace)."""


def read(r):
    t = r.record.trace
    if t is None or r.record.loop != "open":
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
