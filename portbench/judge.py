"""What decides ``correct``: the window's answers held to the plain
reference (``portbench/reference.py``), after the window has closed and
the program's state is freed.

Each distinct payload the window produced for a frame (the first
MAX_DISTINCT of them; a deterministic coder makes one, and any answer
past those counts as failed) is decoded by the reference and held to the
input's projection: the same pixels occupied, and each depth within the
configuration's guarantee, step / 2 + delta / 2, with the step that the
reference allows the pixel (``reference.allowed_step``: the uniform step,
or the step of the salience level that the cluster's key points earn).
Every frame due in the window must come back (``missing``), every
payload must be one the format allows (``undecodable``), and no answer
may fail (``correct`` needs ``failed`` to be 0).
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Tuple

import numpy as np

from portbench import reference

MAX_DISTINCT = 4  # payloads of one frame that are decoded, the first distinct ones the window produced


class Verdict(NamedTuple):
    correct: bool
    checks: Dict[str, Tuple[float, float]]  # name -> (number, limit)
    attempted: int  # answers the run produced and frames that never came back
    failed: int  # of those, the ones that failed a check, were not checked, or never came back
    valid_points: List[int]  # each distinct frame's returned points (the reference's projection)


def judge(record, clouds: List[np.ndarray], config: dict, limits: Dict[str, float]) -> Verdict:
    lidar, codec = config["lidar"], config["codec"]
    refs = [reference.project(c, lidar) for c in clouds]
    distinct: Dict[int, List[bytes]] = {}
    for k, blob in record.outputs:
        seen = distinct.setdefault(k, [])
        if blob not in seen and len(seen) < MAX_DISTINCT:
            seen.append(blob)
    keys = [(k, b) for k, blobs in distinct.items() for b in blobs]
    decoded = reference.decode_payloads([b for _, b in keys], lidar, codec)
    undecodable = occupancy = 0
    worst = 0.0
    bad = set()
    for key, d in zip(keys, decoded):
        if d is None:
            undecodable += 1
            bad.add(key)
            continue
        ref = refs[key[0]]
        chk = reference.depth_check(d.range_image, reference.allowed_step(ref, d.seg, codec), ref, codec)
        occupancy += chk.occupancy_mismatch
        worst = max(worst, chk.err_over_bound)
        if chk.occupancy_mismatch > 0 or chk.err_over_bound > limits["depth_err_over_bound"]:
            bad.add(key)
    checked = set(keys)
    failed = sum(1 for key in record.outputs if key in bad or key not in checked) + record.missing
    checks = {
        "missing": (float(record.missing), limits["missing"]),
        "undecodable": (float(undecodable), limits["undecodable"]),
        "occupancy_px": (float(occupancy), limits["occupancy_px"]),
        "depth_err_over_bound": (worst, limits["depth_err_over_bound"]),
    }
    answers = len(record.outputs)
    correct = answers > 0 and failed == 0 and all(v <= lim for v, lim in checks.values())
    return Verdict(correct, checks, answers + record.missing, failed, [int((r != 0).sum()) for r in refs])
