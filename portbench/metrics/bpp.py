"""Bits per point: the payloads' bits over the points they return, each
distinct frame counted once (its first payload in the run); the points
are the reference's projection of the input, not the program's count."""


def read(r):
    first = {}
    for k, blob in r.record.outputs:
        first.setdefault(k, len(blob))
    if not first:
        return None
    return 8.0 * sum(first.values()) / sum(r.valid_points[k] for k in first)
