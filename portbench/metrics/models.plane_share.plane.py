"""The share of the cluster model rows that carry a plane, in %: of the
non-empty rows of ids 2 and up, those whose ``a + b + c`` is not 0 (the
decoder's test), over every batch of the untraced part of the window.
Read from ``BatchEngine``'s ``stats`` (``plane_rows`` over ``model_rows``,
counted from the model tables the engine downloads).  A program that
keeps no such counts is read from the payloads instead: each distinct
frame's first payload's model table, as the reference unpacks it."""

import bz2

import numpy as np


def _from_payloads(r):
    from portbench import reference

    first = {}
    for k, blob in r.record.outputs:
        first.setdefault(k, blob)
    uniform = r.config["codec"]["compress_framework"] == "uniform"
    rows = planes = 0
    for blob in first.values():
        try:
            field = reference.unpack_payload(blob, uniform)["plane_param"]
        except reference.Undecodable:
            return None
        if not field or field[0] != 0x42:  # a bzip2 container: the rans coder's for a float field
            return None
        t = np.frombuffer(bz2.decompress(field[1:]), np.float32).reshape(-1, 4)[2:]
        rows += int((t != 0).any(-1).sum())
        planes += int((t[:, 0] + t[:, 1] + t[:, 2] != 0).sum())
    return 100.0 * planes / rows if rows else None


def read(r):
    st = r.record.stats or {}
    if st.get("model_rows"):
        return 100.0 * st.get("plane_rows", 0) / st["model_rows"]
    return _from_payloads(r)
