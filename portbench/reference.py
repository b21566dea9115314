"""The plain reference that decides ``correct``: numpy only, nothing of the
program.

* :func:`project` works a point cloud's range image out from the
  configuration's geometry: each point's pixel from its azimuth and
  elevation (evenly spaced rows by rounding, or the nearest angle of a
  channel table), its depth the point's norm, the nearest point kept.
* :func:`decode_payloads` reads ``.rpcc`` payloads: the framing (a 4-byte
  length before each field), every container the ``rans`` coder writes
  ('C' and 'D' interleaved-lane rANS, 'Z' bzip2 of the zigzag-delta
  stream, 'N' the contour's wavefront rANS, '8' zlib bytes, 'B' bzip2),
  and the reconstruction: the segment map run-length filled from the
  contour, residuals in cluster order (0, then 2, 3, ...; 1 is the empty
  class), each pixel's prediction from its cluster's model row, depth =
  prediction + residual x step (the uniform step, or the step of the
  cluster's salience level).  The rANS decode follows the format
  (``PROB_BITS`` 14, 32-bit state, 16-bit words read from the back of a
  lane, four zigzag-magnitude contexts, the wavefront's 2 x above + left
  contexts), all lanes of all payloads stepped together.
* :func:`allowed_step` works out, from the input alone, the step the
  configuration allows each pixel: the uniform step, or in non-uniform
  mode the step of the salience level that each cluster's LOAM key points
  earn it (R-PCC's rule: per row and sector of the non-ground pixels, the
  sharpest and flattest curvatures; levels by key points per cluster,
  ``level_key_point_num``).  The clusters are the payload's segment map;
  the levels and key points are the reference's own.
* :func:`depth_check` holds a decoded range image to the configuration's
  guarantee against the input's projection.
"""

from __future__ import annotations

import bz2
import math
import struct
import zlib
from typing import Dict, List, NamedTuple, Optional, Sequence

import numpy as np

PROB_BITS = 14
M = 1 << PROB_BITS
RANS_L = 1 << 16
ALPHABET = 512
ESCAPE = ALPHABET - 1
NUM_CTX = 4
FIELDS = ("salience_level", "contour_map", "idx_sequence", "plane_param", "residual_quantized")
_DTYPES = {0: np.int16, 1: np.uint16, 2: np.int32}
_U32 = 0xFFFFFFFF


class Undecodable(ValueError):
    """A payload the format does not allow."""


# ------------------------------------------------------------------ projection
def project(points: np.ndarray, lidar: dict) -> np.ndarray:
    """(N, >=3) cloud -> (H, W) f32 range image, 0 where no point falls."""
    H, W = int(lidar["height"]), int(lidar["width"])
    p = np.asarray(points, np.float64)[:, :3]
    depth = np.sqrt((p * p).sum(1))
    az = np.arctan2(p[:, 1], p[:, 0])
    az = np.where(az < 0, az + 2 * math.pi, az)
    col = np.rint(az / math.radians(lidar["horizontal_fov_deg"]) * W).astype(np.int64) % W
    elev = np.arctan2(p[:, 2], np.hypot(p[:, 0], p[:, 1]))
    table = lidar.get("vertical_angles_deg")
    if table is None:
        vmax, vmin = math.radians(lidar["vertical_angle_max_deg"]), math.radians(lidar["vertical_angle_min_deg"])
        row = np.clip(np.rint((elev - vmin) / ((vmax - vmin) / (H - 1))), 0, H - 1).astype(np.int64)
    else:
        ang = np.radians(np.asarray(table, np.float64))
        row = np.abs(elev[:, None] - ang[None, :]).argmin(1)
    keep = depth > 0
    pix, depth = (row * W + col)[keep], depth[keep]
    ri = np.full(H * W, np.inf)
    np.minimum.at(ri, pix, depth)
    return np.where(np.isfinite(ri), ri, 0.0).astype(np.float32).reshape(H, W)


# ------------------------------------------------------------------ containers
def unpack_payload(blob: bytes, uniform: bool) -> Dict[str, bytes]:
    out, off = {}, 0
    for name in FIELDS[1:] if uniform else FIELDS:
        if off + 4 > len(blob):
            raise Undecodable("payload ends inside a field length")
        (n,) = struct.unpack_from("<i", blob, off)
        off += 4
        if n < 0 or off + n > len(blob):
            raise Undecodable(f"field {name} overruns the payload")
        out[name] = blob[off: off + n]
        off += n
    if off != len(blob):
        raise Undecodable("trailing bytes after the last field")
    return out


def _table(blob: bytes, off: int):
    (max_id,) = struct.unpack_from("<H", blob, off)
    off += 2
    freq = np.zeros(ALPHABET, np.int64)
    if max_id == 0xFFFF:
        return freq, off
    if max_id >= ALPHABET:
        raise Undecodable("table symbol past the alphabet")
    nbytes = (max_id + 8) // 8
    present = np.flatnonzero(np.unpackbits(np.frombuffer(blob, np.uint8, nbytes, off))[: max_id + 1])
    off += nbytes
    vals = np.frombuffer(blob, np.uint8, present.size, off).astype(np.int64)
    off += present.size
    wide = vals == 255
    vals[wide] = np.frombuffer(blob, "<u2", int(wide.sum()), off)
    off += 2 * int(wide.sum())
    freq[present] = vals
    return freq, off


def _lane_words(blob: bytes, off: int, counts: np.ndarray, T: int) -> np.ndarray:
    words = np.zeros((counts.size, T), np.int64)
    total = int(counts.sum())
    if (counts > T).any():
        raise Undecodable("a lane holds more words than steps")
    flat = np.frombuffer(blob, "<u2", total, off)
    lane = np.repeat(np.arange(counts.size), counts)
    pos = np.arange(total) - np.repeat(np.cumsum(counts) - counts, counts)
    words[lane, pos] = flat
    return words


class _Lanes(NamedTuple):
    words: np.ndarray  # (L, T) int64 u16 values
    counts: np.ndarray  # (L,) words per lane
    states: np.ndarray  # (L,) u32 as int64
    lives: np.ndarray  # (L,) symbols to decode per lane
    freqs: np.ndarray  # (C, A) int64, each row summing to M


class _Delta(NamedTuple):
    lanes: _Lanes
    T: int
    n: int
    q0: int
    escapes: np.ndarray
    dtype: type
    zigzag_ctx: bool


def _parse_delta(blob: bytes) -> _Delta:
    magic, log_l, T, n, q0 = struct.unpack_from("<BBHIi", blob, 0)
    L = 1 << log_l
    if L > 32 or n > L * T:
        raise Undecodable("delta container geometry")
    (n_esc,) = struct.unpack_from("<I", blob, 12)
    off = 16
    escapes = np.frombuffer(blob, "<u4", n_esc, off).astype(np.int64)
    off += 4 * n_esc
    C = NUM_CTX if magic == 0x43 else 1
    freqs = np.zeros((C, ALPHABET), np.int64)
    for c in range(C):
        freqs[c], off = _table(blob, off)
    states = np.frombuffer(blob, "<u4", L, off).astype(np.int64)
    off += 4 * L
    counts = np.frombuffer(blob, "<u2", L, off).astype(np.int64)
    off += 2 * L
    words = _lane_words(blob, off, counts, T)
    off += 2 * int(counts.sum())
    (dt,) = struct.unpack_from("<B", blob, off)
    if off + 1 != len(blob) or dt not in _DTYPES:
        raise Undecodable("delta container tail")
    lives = np.clip(n - np.arange(L) * T, 0, T)
    return _Delta(_Lanes(words, counts, states, lives, freqs), T, n, q0, escapes, _DTYPES[dt], magic == 0x43)


def _unzigzag_sum(zz: np.ndarray, q0: int, escapes: np.ndarray, dtype) -> np.ndarray:
    zz = zz.astype(np.int64)
    esc = zz == ESCAPE
    if int(esc.sum()) != escapes.size:
        raise Undecodable("escape count differs from the escape list")
    zz[esc] = escapes
    d = np.where(zz % 2 == 0, zz // 2, -(zz + 1) // 2)
    if d.size:
        d[0] = 0
    return (q0 + np.cumsum(d)).astype(dtype)


def _bzd(blob: bytes) -> np.ndarray:
    _, dt, n, q0 = struct.unpack_from("<BBIi", blob, 0)
    (n_esc,) = struct.unpack_from("<I", blob, 10)
    escapes = np.frombuffer(blob, "<u4", n_esc, 14).astype(np.int64)
    if dt not in _DTYPES:
        raise Undecodable("Z container dtype")
    sym = np.frombuffer(bz2.decompress(blob[14 + 4 * n_esc:]), "<u2")[:n]
    if sym.size != n:
        raise Undecodable("Z container short")
    return _unzigzag_sum(sym, q0, escapes, _DTYPES[dt])


def _rans_steps(groups: Sequence[_Lanes], ctx_kind: Sequence[int], wavefront: bool) -> List[np.ndarray]:
    """Decode every lane of ``groups`` in lockstep -> each group's (L, T)
    int64 symbols.  ``ctx_kind`` per group: 1 zigzag-magnitude contexts,
    0 context 0; ``wavefront``: every group is a contour (2 x above + left,
    lane l's above being lane l - 1 of its own group)."""
    if not groups:
        return []
    Ls = [g.states.size for g in groups]
    T = max(g.words.shape[1] for g in groups)
    G = sum(Ls)
    lane_grp = np.repeat(np.arange(len(groups)), Ls)
    C = max(g.freqs.shape[0] for g in groups)
    freqs = np.zeros((len(groups), C, ALPHABET), np.int64)
    for i, g in enumerate(groups):
        if (g.freqs.sum(1) != M).any():
            raise Undecodable("a frequency table does not sum to M")
        freqs[i, : g.freqs.shape[0]] = g.freqs
    cums = np.cumsum(freqs, -1) - freqs
    s2s = np.zeros((len(groups), C, M), np.int64)
    for i in range(len(groups)):
        for c in range(C):
            if freqs[i, c].sum() == M:
                s2s[i, c] = np.repeat(np.arange(ALPHABET), freqs[i, c])
    f_flat, c_flat, s_flat = freqs.reshape(-1), cums.reshape(-1), s2s.reshape(-1)
    words = np.zeros((G, T), np.int64)
    row = 0
    for g in groups:
        words[row: row + g.states.size, : g.words.shape[1]] = g.words
        row += g.states.size
    w_flat = words.reshape(-1)
    w_base = np.arange(G) * T
    t_base = lane_grp * (C * ALPHABET)
    s_base = lane_grp * (C * M)
    x = np.concatenate([g.states for g in groups]) & _U32
    cur = np.concatenate([g.counts for g in groups])
    last = np.concatenate([np.full(g.states.size, g.words.shape[1] - 1) for g in groups])
    lives = np.concatenate([g.lives for g in groups])
    zig = np.repeat(np.asarray(ctx_kind, np.int64), Ls) if not wavefront else None
    first_lane = np.concatenate([[True] + [False] * (n - 1) for n in Ls]) if wavefront else None
    prev = np.zeros(G, np.int64)
    out = np.zeros((G, T), np.int64)
    for t in range(T):
        active = t < lives
        if t == 0:
            ctx = np.zeros(G, np.int64)
        elif wavefront:
            above = np.concatenate([[0], prev[:-1]])
            above[first_lane] = 0
            ctx = 2 * above + prev
        else:
            mag = (prev + 1) // 2
            ctx = ((mag >= 1).astype(np.int64) + (mag >= 3) + (mag >= 8)) * zig
        slot = x & (M - 1)
        s = s_flat[s_base + ctx * M + slot]
        key = t_base + ctx * ALPHABET + s
        xn = (f_flat[key] * (x >> PROB_BITS) + slot - c_flat[key]) & _U32
        need = active & (xn < RANS_L)
        cur = cur - need
        wv = w_flat[w_base + np.clip(cur, 0, last)]
        xn = np.where(need, ((xn << 16) | wv) & _U32, xn)
        x = np.where(active, xn, x)
        prev = np.where(active, s, 0)
        out[:, t] = prev
    res, row = [], 0
    for g in groups:
        res.append(out[row: row + g.states.size, : g.words.shape[1]])
        row += g.states.size
    return res


def _parse_contour(blob: bytes):
    _, T, H, W = struct.unpack_from("<BHHH", blob, 0)
    if T < H + W - 1:
        raise Undecodable("contour lanes shorter than the wavefront")
    off = 7
    freqs = np.zeros((1, ALPHABET), np.int64)
    tab = np.frombuffer(blob, "<u2", 8, off).astype(np.int64).reshape(4, 2)
    off += 16
    states = np.frombuffer(blob, "<u4", H, off).astype(np.int64)
    off += 4 * H
    counts = np.frombuffer(blob, "<u2", H, off).astype(np.int64)
    off += 2 * H
    words = _lane_words(blob, off, counts, T)
    if off + 2 * int(counts.sum()) != len(blob):
        raise Undecodable("contour container length")
    freqs = np.zeros((4, ALPHABET), np.int64)
    freqs[:, :2] = tab
    return _Lanes(words, counts, states, np.full(H, T), freqs), H, W


class Decoded(NamedTuple):
    range_image: np.ndarray  # (H, W) f32
    step: np.ndarray  # (H, W) f32: the step the payload states for each pixel (0 where empty)
    seg: np.ndarray  # (H, W) int64: each pixel's cluster id as the payload states it (1: empty)


def decode_payloads(blobs: Sequence[bytes], lidar: dict, codec: dict) -> List[Optional[Decoded]]:
    """Each payload's range image, or None where the payload is not one the
    format allows."""
    H, W = int(lidar["height"]), int(lidar["width"])
    uniform = codec["compress_framework"] == "uniform"
    fields: List[Optional[dict]] = []
    for b in blobs:
        try:
            fields.append(unpack_payload(b, uniform))
        except (Undecodable, struct.error):
            fields.append(None)
    plain: Dict[tuple, np.ndarray] = {}
    deltas: Dict[tuple, _Delta] = {}
    contours: Dict[int, _Lanes] = {}
    for i, f in enumerate(fields):
        if f is None:
            continue
        try:
            for name, blob in f.items():
                if not blob:
                    raise Undecodable(f"empty {name}")
                tag = blob[0]
                if tag == 0x42:
                    plain[i, name] = np.frombuffer(bz2.decompress(blob[1:]), np.uint8)
                elif tag == 0x38:
                    plain[i, name] = np.frombuffer(zlib.decompress(blob[1:]), np.uint8).astype(np.uint16)
                elif tag == 0x5A:
                    plain[i, name] = _bzd(blob)
                elif tag in (0x43, 0x44):
                    deltas[i, name] = _parse_delta(blob)
                elif tag == 0x4E and name == "contour_map":
                    lanes, h, w = _parse_contour(blob)
                    if (h, w) != (H, W):
                        raise Undecodable("contour geometry")
                    contours[i] = lanes
                else:
                    raise Undecodable(f"{name}: container tag {tag:#x}")
        except (Undecodable, struct.error, OSError, ValueError, IndexError):
            fields[i] = None
    dkeys = [k for k in deltas if fields[k[0]] is not None]
    dsyms = _rans_steps([deltas[k].lanes for k in dkeys], [int(deltas[k].zigzag_ctx) for k in dkeys], False)
    ckeys = [k for k in contours if fields[k] is not None]
    csyms = _rans_steps([contours[k] for k in ckeys], [0] * len(ckeys), True)
    for k, sym in zip(dkeys, dsyms):
        d = deltas[k]
        try:
            plain[k] = _unzigzag_sum(sym.reshape(-1)[: d.n], d.q0, d.escapes, d.dtype)
        except Undecodable:
            fields[k[0]] = None
    for k, sym in zip(ckeys, csyms):
        bits = np.stack([sym[r, r: r + W] for r in range(H)])
        plain[k, "contour_map"] = np.packbits(bits.reshape(-1).astype(np.uint8))
    out: List[Optional[Decoded]] = []
    for i, f in enumerate(fields):
        if f is None:
            out.append(None)
            continue
        try:
            out.append(_reconstruct({name: plain[i, name] for name in f}, lidar, codec))
        except (Undecodable, KeyError, ValueError, IndexError):
            out.append(None)
    return out


def _as(arr: np.ndarray, dtype) -> np.ndarray:
    """A decoded field's values viewed as ``dtype`` (byte fields are
    reinterpreted, typed streams converted)."""
    if arr.dtype == np.uint8:
        return arr.view(dtype) if np.dtype(dtype).itemsize > 1 else arr
    return arr.astype(dtype)


def _reconstruct(f: Dict[str, np.ndarray], lidar: dict, codec: dict) -> Decoded:
    H, W = int(lidar["height"]), int(lidar["width"])
    hw = H * W
    contour = np.unpackbits(_as(f["contour_map"], np.uint8))
    if contour.size < hw:
        raise Undecodable("contour shorter than the grid")
    seq = _as(f["idx_sequence"], np.uint16).astype(np.int64)
    stream = _as(f["residual_quantized"], np.int16).astype(np.float32)
    models = _as(f["plane_param"], np.uint8).view(np.float32).reshape(-1, 4)
    n_models = models.shape[0]
    if n_models == 0:
        raise Undecodable("no model rows")
    bits = contour[:hw].astype(bool)
    taken = np.minimum(np.cumsum(bits), seq.size)
    seg = np.where(taken > 0, seq[np.maximum(taken - 1, 0)] if seq.size else 0, 0)
    live = (seg != 1) & (seg >= 0) & (seg < n_models)
    rank = np.where(seg == 0, 0, seg - 1)
    pix = np.flatnonzero(live)
    pix = pix[np.argsort(rank[pix], kind="stable")]
    q = np.zeros(hw, np.float32)
    n = min(pix.size, stream.size)
    q[pix[:n]] = stream[:n]
    tm = _rays(lidar)
    m = models[np.clip(seg, 0, n_models - 1)]
    a, b, c, d = (m[:, j] for j in range(4))
    with np.errstate(divide="ignore", invalid="ignore"):
        denom = a * tm[0] + b * tm[1] + c * tm[2]
        plane = np.where(denom == 0, np.float32(0), -d / denom).astype(np.float32)
    pred = np.where(a + b + c == 0, d, plane).astype(np.float32)
    if codec["compress_framework"] == "uniform":
        step = np.full(hw, np.float32(2 * codec["accuracy"]), np.float32)
    else:
        steps = np.asarray([np.float32(2 * codec["accuracy"] + x) for x in codec["level_delta_acc"]], np.float32)
        level = _as(f["salience_level"], np.uint8).astype(np.int64)
        if level.size < n_models:
            raise Undecodable("fewer salience levels than model rows")
        step = steps[np.minimum(level[np.clip(seg, 0, n_models - 1)], steps.size - 1)]
    ri = np.where(live, pred + q * step, np.float32(0)).astype(np.float32)
    return Decoded(ri.reshape(H, W), np.where(live, step, 0).astype(np.float32).reshape(H, W),
                   np.where(live, seg, 1).reshape(H, W))


_RAYS: Dict[str, np.ndarray] = {}


def _rays(lidar: dict) -> np.ndarray:
    """(3, HW) unit rays of the configuration (frames.transform_map)."""
    from portbench.frames import transform_map

    key = repr(sorted(lidar.items()))
    if key not in _RAYS:
        _RAYS[key] = np.ascontiguousarray(transform_map(lidar).reshape(-1, 3).T)
    return _RAYS[key]


# ------------------------------------------------------------------ salience
GAP_THRESHOLD = np.float32(0.3)  # R-PCC cpp_modules.cpp: a point more than 0.3 m behind a neighbour is occluded
SCAN_BLOCK = 16


def _cumsum_f32(x: np.ndarray) -> np.ndarray:
    """Inclusive f32 cumsum of a 1-D array in 16-element blocks, each added
    left to right, plus the same scan of the block totals: the summation
    order the format's curvature is defined in (its window sums cancel to
    centimetres of sums of thousands of metres, so the order decides
    near-ties)."""
    x = np.asarray(x, np.float32)
    if x.size <= SCAN_BLOCK:
        return np.cumsum(x, dtype=np.float32)
    nb = -(-x.size // SCAN_BLOCK)
    inner = np.cumsum(np.pad(x, (0, nb * SCAN_BLOCK - x.size)).reshape(nb, SCAN_BLOCK), axis=1, dtype=np.float32)
    totals = _cumsum_f32(inner[:, -1])
    carry = np.concatenate([np.zeros(1, np.float32), totals[:-1]])
    return (carry[:, None] + inner).reshape(-1)[: x.size]


def key_points(ri: np.ndarray, valid: np.ndarray, codec: dict) -> np.ndarray:
    """(H, W) bool LOAM key points of a range image over its ``valid``
    pixels (R-PCC's feature extraction): per row, the valid pixels in column
    order, each with curvature ``(sum_{|k|<=r} v[s+k] - v[s])^2 / (2r v[s])``;
    per row sector (``segments`` equal runs, the ``r`` slots at each end
    left out), in curvature-descending order (ties: later entry first), the
    entries that pass the occlusion check ranked 1 .. less_sharp - 1 are
    sharp or less sharp; of the entries after the less_sharp-th passing
    one, those with nonzero curvature that pass, in ascending order, ranked
    1 .. flat - 1 are flat.  A pixel fails the occlusion check when it lies
    more than 0.3 m behind a pixel within +-r of it in the row-major
    buffer."""
    r, segments = int(codec["feature_region"]), int(codec["segments"])
    less_sharp, flat = int(codec["less_sharp_num"]), int(codec["flat_num"])  # sharp_num splits key points, not counts
    H, W = ri.shape
    buf = ri.reshape(-1).astype(np.float32)
    pos = np.arange(buf.size)
    gap = np.ones(buf.size, bool)
    for i in range(-r, r + 1):
        gap &= (buf - buf[np.clip(pos + i, 0, buf.size - 1)]) <= GAP_THRESHOLD
    gap = gap.reshape(H, W)
    kp = np.zeros((H, W), bool)
    for h in range(H):
        cols = np.flatnonzero(valid[h])
        L = cols.size
        if L < segments + 2 * r + 1:
            continue
        v = ri[h, cols].astype(np.float32)
        csum = np.concatenate([np.zeros(1, np.float32), _cumsum_f32(np.pad(v, (r, r)))])
        win = csum[2 * r + 1: 2 * r + 1 + L] - csum[:L]
        diff = win - np.float32(2 * r + 1) * v
        feat = diff * diff / np.float32(2 * r) / np.where(v != 0, v, np.float32(1))  # 0: a pixel the input lacks
        sw = (L - 2 * r) // segments
        m = sw * segments
        t = np.arange(m)
        f, ok, col = feat[r: r + m], gap[h, cols[r: r + m]], cols[r: r + m]
        o = np.lexsort((-t, -f, t // sw))  # by sector, curvature descending, entry descending
        P, F = ok[o].reshape(segments, sw), f[o].reshape(segments, sw)
        cum = np.cumsum(P, axis=1)
        ranked = P & (cum <= less_sharp - 1)
        fc = ((cum - P) >= less_sharp) & (F != 0) & P
        csf = np.cumsum(fc, axis=1)
        ranked |= fc & (csf[:, -1:] - csf + fc <= flat - 1)
        kp[h, col[o][ranked.reshape(-1)]] = True
    return kp


def salience_levels(ref: np.ndarray, seg: np.ndarray, n_models: int, codec: dict) -> np.ndarray:
    """(n_models,) salience level of each cluster id of ``seg``: the ground
    (id 0) ``ground_salience_level``; the empty class (id 1) and clusters
    under 30 pixels the last level; otherwise the first level whose
    ``level_key_point_num`` its key points meet.  The key points are
    :func:`key_points` of the input's projection ``ref`` on the u16 snap
    grid (the range image the format codes: rint(depth x (1 / delta)) in
    f32, times delta) over the clusters."""
    delta = snap_delta(ref, codec)
    ri = ref
    if delta != 0:
        ri = np.rint(ref.astype(np.float32) * (np.float32(1) / delta)).clip(0, 65535).astype(np.float32) * delta
    ids = np.clip(seg, 0, n_models - 1)
    kp = key_points(ri, (seg != 0) & (seg != 1), codec)
    kp_count = np.bincount(ids[kp], minlength=n_models)
    pixels = np.bincount(ids.reshape(-1), minlength=n_models)
    thresholds = np.asarray(codec["level_key_point_num"])
    last = thresholds.size - 1
    level = np.argmax(kp_count[:, None] >= thresholds[None, :], axis=1)
    level = np.where(pixels < 30, last, level)
    level[0] = int(codec["ground_salience_level"])
    level[1] = last
    return level


def allowed_step(ref: np.ndarray, seg: np.ndarray, codec: dict) -> np.ndarray:
    """(H, W) f32 step the configuration allows each pixel of a frame whose
    input projects to ``ref`` and whose payload states the clusters
    ``seg``: the uniform step, or the step of the cluster's salience level
    as :func:`salience_levels` works it out."""
    acc = codec["accuracy"]
    if codec["compress_framework"] == "uniform":
        return np.full(ref.shape, np.float32(2 * acc), np.float32)
    steps = np.asarray([np.float32(2 * acc + x) for x in codec["level_delta_acc"]], np.float32)
    n_models = int(seg.max()) + 1 if seg.size else 2
    return steps[salience_levels(ref, seg, max(n_models, 2), codec)[np.clip(seg, 0, None)]]


# ------------------------------------------------------------------ the check
def snap_delta(ref: np.ndarray, codec: dict) -> np.float32:
    """The u16 snap grid of a frame: max(step / 16, max depth / 65535)."""
    if codec["transfer_precision"] == "f32":
        return np.float32(0.0)
    return np.float32(max(np.float64(np.float32(2 * codec["accuracy"] / 16.0)), float(ref.max()) / 65535.0))


class DepthCheck(NamedTuple):
    occupancy_mismatch: int  # pixels occupied on one side only
    err_over_bound: float  # max over occupied pixels of |depth - reference| / bound


def depth_check(decoded: np.ndarray, step: np.ndarray, ref: np.ndarray, codec: dict) -> DepthCheck:
    """``decoded`` (H, W) against the input's projection ``ref``: the
    pixels occupied on one side only, and the largest depth error over
    the guarantee's bound, step / 2 + delta / 2, ``step`` the (H, W)
    quantization step of each pixel as the payload states it."""
    occ_d, occ_r = decoded != 0, ref != 0
    mismatch = int((occ_d != occ_r).sum())
    both = occ_d & occ_r
    if not both.any():
        return DepthCheck(mismatch, 0.0)
    bound = step[both].astype(np.float64) / 2 + float(snap_delta(ref, codec)) / 2
    err = np.abs(decoded[both].astype(np.float64) - ref[both].astype(np.float64))
    return DepthCheck(mismatch, float((err / bound).max()))

