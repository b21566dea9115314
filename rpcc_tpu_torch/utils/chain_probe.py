"""Latencies of dependent operations on the card, and the rANS kernels'
chain floors built from them.

A diagnostic, run on a machine with a CUDA card:

    python -m rpcc_tpu_torch.utils.chain_probe

It builds ``csrc/chain_probe.cu`` (into ``_build/``, as the kernels build),
runs its probes in one block (each a chain of ``STEPS`` operations that
each read the one before's result, timed with ``clock64()``), and prints
the cycles and nanoseconds per operation at the SM clock the probe ran at
(``clock64()`` over ``%globaltimer``), then one JSON line.  The floors
multiply those measured latencies by chains counted from the kernels'
source (``CHAINS``): a count, not a measurement.
"""

from __future__ import annotations

import ctypes
import functools
import json

import numpy as np

PROBES = ("lds16", "lds64", "ldg16", "imad", "imad_hi", "alu", "shf", "shfl", "bar2", "lds16_w")
STEPS = 4096  # dependent operations a probe
L2_WORDS = 65536  # the L2 table: 128 KB of u16 indices, one cycle through all of them

# A step's loop-carried chain of dependent operations, counted in the source:
#  * decode_residual (csrc/rans_decode.cu, residual_block): the slot table's
#    u16 entry, the {f, c} record at it, slot - c, f * (x >> 14) + that, the
#    kept candidate's shift and mask-or, and its select against the other
#    by the compare with 2^16 (the compare, the other candidate and the mask
#    of f run beside the chain);
#  * decode_contour (contour_block): two recurrences, the larger bounds it:
#    the state (mask, compare with f0, select f, multiply-add, - c, compare,
#    select) and the row above's symbol (select the live symbol, shuffle,
#    select f0 by it, compare);
#  * encode (csrc/rans.cu's step, python -m rpcc_tpu_torch.utils.rans_sass):
#    multiply-high, subtract, shift, add, shift, multiply-add.
CHAINS = {
    "decode_residual": [{"lds16": 1, "lds64": 1, "imad": 1, "alu": 4}],
    "decode_contour": [{"imad": 1, "alu": 6}, {"shfl": 1, "alu": 3}],
    "encode": [{"imad_hi": 1, "alu": 2, "shf": 2, "imad": 1}],
}


@functools.lru_cache(maxsize=None)
def _library():
    from rpcc_tpu_torch.ops.cuda_build import load_cuda_library

    lib = load_cuda_library("chain_probe.cu")
    lib.rpcc_chain_probe_launch.restype = ctypes.c_int
    lib.rpcc_chain_probe_launch.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                                            ctypes.c_uint, ctypes.c_void_p]
    return lib


def l2_table(n: int = L2_WORDS, seed: int = 0) -> np.ndarray:
    """A u16 table whose entries form one cycle through all n indices in a
    random order (Sattolo's shuffle), so a chase visits every entry."""
    rng = np.random.default_rng(seed)
    order = rng.permutation(n)
    table = np.empty(n, np.uint16)
    table[order] = np.roll(order, -1)
    return table


def chain_floor_cycles(cycles: dict, chain: str) -> float:
    """The larger of ``chain``'s recurrences, each the sum of its operations'
    measured cycles."""
    return max(sum(k * cycles[op] for op, k in rec.items()) for rec in CHAINS[chain])


def measure() -> dict:
    """Runs the probes on the current CUDA device -> {"cycles": {probe:
    cycles per op}, "ns": {probe: ns per op}, "mhz": SM clock, "steps",
    "floor_cycles" and "floor_ns_per_step": {chain: ...}}."""
    import torch

    l2 = torch.from_numpy(l2_table().view(np.int16)).cuda()
    out = torch.zeros(len(PROBES) + 8, dtype=torch.int64, device=l2.device)
    err = _library().rpcc_chain_probe_launch(l2.data_ptr(), l2.numel(), STEPS, out.data_ptr(), 0x2545F491,
                                             torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"chain probe launch failed: cudaError_t {err}")
    torch.cuda.synchronize()
    o = out.cpu().tolist()
    if o[0] < 0:
        raise RuntimeError("chain probe: the shared tables' addresses do not fit u16 entries")
    n = o[len(PROBES)]
    mhz = (o[len(PROBES) + 2] - o[len(PROBES) + 1]) / (o[len(PROBES) + 4] - o[len(PROBES) + 3]) * 1e3
    cycles = {p: o[i] / n for i, p in enumerate(PROBES)}
    floors = {c: chain_floor_cycles(cycles, c) for c in CHAINS}
    return {"steps": n, "mhz": mhz, "cycles": cycles, "ns": {p: c / mhz * 1e3 for p, c in cycles.items()},
            "floor_cycles": floors, "floor_ns_per_step": {c: f / mhz * 1e3 for c, f in floors.items()}}


def main() -> int:
    r = measure()
    print(f"chain probe: {r['steps']} dependent operations a probe at {r['mhz']:.1f} MHz (clock64 over %globaltimer)")
    for p in PROBES:
        print(f"  {p:8s} {r['cycles'][p]:8.2f} cycles  {r['ns'][p]:8.3f} ns")
    for c in CHAINS:
        print(f"  chain floor {c}: {r['floor_cycles'][c]:.2f} cycles = {r['floor_ns_per_step'][c]:.3f} ns a step "
              f"(measured latencies x the chain counted in the source)")
    print(json.dumps({"chain_probe": r}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
