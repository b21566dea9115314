"""``RPCCCodec.compress``'s ``entropy`` (the containers, coded on the
card) in ms, the mean over the frames of the untraced part of the
window."""


def read(r):
    t = r.record.timings
    if not t:
        return None
    return 1e3 * sum(x["entropy"] for x in t) / len(t)
