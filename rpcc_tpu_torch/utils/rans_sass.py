"""The rANS walk's step length in the SASS of ``csrc/rans.cu``.

A diagnostic, run on a machine with the CUDA toolkit when ``rans.cu``
changes:

    python -m rpcc_tpu_torch.utils.rans_sass [--steps 4000] [--dump FILE]

It builds the kernel's library (as the wrapper does, into ``_build/``),
disassembles it with ``cuobjdump -sass`` and finds the walk's loops: each
innermost back-edge loop whose body holds a multiple of 8 multiply-highs (a
step's division each; the walk runs its steps in groups of eight).  For
each it prints the body's instructions and its longest chain of dependent
instructions (a register or predicate written, then read) per step, and a
modelled chain floor: ``steps`` x that chain x ``CYCLES_PER_DEPENDENT``
cycles at the card's maximum SM clock (``nvidia-smi``).  The cycles are
assumed for every dependent instruction, multiply-high included, not
measured.
"""

from __future__ import annotations

import argparse
import os
import re
import shutil
import subprocess
from typing import List, Optional

# Cycles from issuing an integer instruction to issuing one that reads its
# result: assumed for every dependent instruction of the step.
CYCLES_PER_DEPENDENT = 4


def _operands(text: str):
    """(guard, opcode, operands) of one SASS instruction's text."""
    text = text.split(";")[0].strip()
    guard = None
    if text.startswith("@"):
        guard, text = text.split(None, 1)
        guard = guard.lstrip("@!")
    op, _, rest = text.partition(" ")
    return guard, op, [o.strip() for o in rest.split(",") if o.strip()]


def _regs(operand: str) -> List[str]:
    """Registers and predicates an operand names (R4.64 -> R4, R5; [R2+0x4] -> R2)."""
    regs = []
    for name, wide in re.findall(r"!?\b(U?R\d+|U?P\d+)\b(\.64)?", operand):
        regs.append(name)
        if wide and name[0] == "R":
            regs.append(f"R{int(name[1:]) + 1}")
    return regs


def walk_loops(sass: str) -> List[dict]:
    """The walk's loops in the text of ``cuobjdump -sass``: dicts of the
    body's ``instructions``, ``steps`` (its multiply-highs), longest
    dependent ``chain``, the per-step ratios, and the ``body``."""
    body = sass[sass.index("rans_encode_kernel"):]
    insts, labels = [], {}
    for line in body.splitlines():
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?);", line)
        lab = re.match(r"\s*(\.L_x_\d+):", line)
        if lab:
            labels[lab.group(1)] = len(insts)
        elif m:
            insts.append((int(m.group(1), 16), m.group(2)))
    addr_index = {a: i for i, (a, _) in enumerate(insts)}
    edges = []  # (first, last) instruction of each back-edge loop
    for i, (_, text) in enumerate(insts):
        tgt = re.search(r"BRA\s+(?:`\()?(\.L_x_\d+|0x[0-9a-f]+)", text)
        if tgt:
            t = tgt.group(1)
            start = labels.get(t) if t.startswith(".L") else addr_index.get(int(t, 16))
            if start is not None and start <= i:
                edges.append((start, i))
    loops = []
    for start, i in edges:
        if any(start <= s2 and i2 < i for s2, i2 in edges if (s2, i2) != (start, i)):
            continue  # not innermost
        loop = [txt for _, txt in insts[start : i + 1]]
        steps = sum(1 for x in loop if "IMAD.HI" in x)
        if steps < 8 or steps % 8:
            continue
        depth, writer = [], {}
        for txt in loop:
            guard, op, ops = _operands(txt)
            if op.startswith(("ST", "BRA", "BAR", "NOP", "EXIT", "RET")):
                dst, src = [], ops
            elif op.startswith(("ISETP", "FSETP", "PLOP3")) or (op.startswith(("IADD3", "LEA", "IMAD")) and len(ops) > 1
                                                                  and re.fullmatch(r"P\d", ops[1] or "")):
                dst, src = ops[:2], ops[2:]
            else:
                dst, src = ops[:1], ops[1:]
            width = 4 if ".128" in op else 2 if (".64" in op or ".WIDE" in op) else 1
            if width > 1 and dst and re.fullmatch(r"R\d+", dst[0]):
                dst = [f"R{int(dst[0][1:]) + k}" for k in range(width)]
            srcs = [r for o in src for r in _regs(o)] + ([guard] if guard else [])
            d = 1 + max((depth[writer[r]] for r in srcs if r in writer), default=0)
            depth.append(d)
            for o in dst:
                for r in _regs(o):
                    if r not in ("RZ", "PT"):
                        writer[r] = len(depth) - 1
        loops.append({"instructions": len(loop), "steps": steps, "chain": max(depth),
                      "chain_per_step": max(depth) / steps, "instructions_per_step": len(loop) / steps, "body": loop})
    return loops


def _cuobjdump() -> Optional[str]:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    for tool in (os.path.join(cuda_home, "bin", "cuobjdump"), shutil.which("cuobjdump") or ""):
        if tool and os.path.exists(tool):
            return tool
    return None


def max_sm_clock_mhz() -> float:
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True, timeout=60)
    return float(out.stdout.strip().splitlines()[0])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=4000, help="steps of the lane the floor is modelled for "
                    "(4000: the 64E residual)")
    ap.add_argument("--dump", default=None, help="write the loops' bodies here (default _build/rans_walk.sass)")
    args = ap.parse_args(argv)
    from rpcc_tpu_torch.ops import rans_device as rd

    tool = _cuobjdump()
    if tool is None:
        raise SystemExit("cuobjdump not found (set CUDA_HOME)")
    lib = rd._library()._name
    sass = subprocess.run([tool, "-sass", lib], capture_output=True, text=True, check=True, timeout=120).stdout
    loops = walk_loops(sass)
    if not loops:
        raise SystemExit("no walk loop found in the SASS of rans.cu")
    dump = args.dump or os.path.join(os.path.dirname(lib), "rans_walk.sass")
    with open(dump, "w") as f:
        for k, lp in enumerate(loops):
            f.write(f"# loop {k}: {lp['instructions']} instructions, {lp['steps']} steps, longest dependent chain "
                    f"{lp['chain']}\n" + "\n".join(lp["body"]) + "\n\n")
    for lp in loops:
        print(f"walk loop: {lp['instructions']} instructions for {lp['steps']} steps "
              f"({lp['instructions_per_step']:.2f} a step), longest dependent chain {lp['chain']} "
              f"({lp['chain_per_step']:.3f} a step)")
    chain = max(lp["chain_per_step"] for lp in loops)
    mhz = max_sm_clock_mhz()
    print(f"chain floor (a model, {CYCLES_PER_DEPENDENT} cycles assumed a dependent instruction): {args.steps} steps "
          f"x {chain:.3f} x {CYCLES_PER_DEPENDENT} cycles at the {mhz:.0f} MHz max SM clock = "
          f"{args.steps * chain * CYCLES_PER_DEPENDENT / mhz:.3f} us; loop bodies in {dump}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
