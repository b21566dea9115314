"""The engine's dispatch stage (upload, then the encoder graph queued on
the card) in ms per batch, from ``BatchEngine``'s ``stats`` over the
untraced part of the window."""


def read(r):
    st = r.record.stats
    if not st or not st.get("batches"):
        return None
    return 1e3 * st["dispatch_s"] / st["batches"]
