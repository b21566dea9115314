"""The engine's finish stage (container assembly and framing on the host
pool) in ms per batch, from ``BatchEngine``'s ``stats`` over the untraced
part of the window."""


def read(r):
    st = r.record.stats
    if not st or not st.get("batches"):
        return None
    return 1e3 * st["finish_s"] / st["batches"]
