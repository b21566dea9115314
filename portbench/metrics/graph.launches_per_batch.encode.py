"""Kernel launches on the card in the traced window (the profiler's
kernels, not copies or sets) per engine batch dispatched in it."""


def read(r):
    t = r.record.trace
    if t is None or r.record.loop != "closed":
        return None
    batches = t.spans_started("dispatch")
    return t.launches / batches if batches else None
