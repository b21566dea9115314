"""``RPCCCodec.compress``'s ``device_encode`` (host projection, upload,
the encoder graph to its synchronise) in ms, the mean over the frames of
the untraced part of the window."""


def read(r):
    t = r.record.timings
    if not t:
        return None
    return 1e3 * sum(x["device_encode"] for x in t) / len(t)
