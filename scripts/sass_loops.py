#!/usr/bin/env python3
"""Instruction counts of a built CUDA kernel's loops, from its SASS.

    python3 scripts/sass_loops.py mamba_scan_bwd.cu [--kernel NAME]

Builds ``csrc/<source>`` as the port does (``kernels/_build.py``),
disassembles it with ``cuobjdump -sass`` and, for each
kernel whose name contains ``--kernel`` (all when empty), prints its
instruction count and one JSON line per loop: a loop is the span from a
backward branch's target to the branch, so an outer loop's count includes
its inner loops'.  Each line counts the span's instructions by class
(shuffles, selects, special-function unit, fp32 and fp64 arithmetic,
shared and global memory, barriers) and by opcode, which is how an instruction count per
token is read off a kernel: divide the count of the loop that runs once per
sub-chunk by the tokens it covers.  Needs the CUDA toolkit (``nvcc``,
``cuobjdump``), not a card.
"""
from __future__ import annotations

import argparse
import json
import re
import shutil
import subprocess
import sys
from collections import Counter
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

# opcode (before the first dot) -> class
CLASSES = {
    "SHFL": "shfl", "SEL": "select", "FSEL": "select", "MUFU": "mufu",
    "FFMA": "fp32", "FMUL": "fp32", "FADD": "fp32", "FMNMX": "fp32", "FSETP": "fp32",
    "DADD": "fp64", "DFMA": "fp64", "DMUL": "fp64", "F2F": "convert", "F2I": "convert",
    "I2F": "convert", "PRMT": "convert", "LDS": "lds", "STS": "sts", "LDG": "ldg",
    "STG": "stg", "LDGSTS": "ldgsts", "LDGDEPBAR": "ldgsts", "DEPBAR": "ldgsts",
    "UTMALDG": "tma", "UTMASTG": "tma", "SYNCS": "mbarrier", "BAR": "barrier",
    "WARPSYNC": "barrier", "NOP": "nop", "LDL": "local", "STL": "local",
}
_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9]*)([.\w]*)\s*(.*?);")
_LABEL = re.compile(r"^\s*(\.L_x_\d+):")


def parse(sass: str) -> dict[str, dict]:
    """kernel -> {"insns": [(address, opcode, operands)], "labels": {label: address}}."""
    sys.path[:0] = [str(REPO)]
    from chip_smoke import kernel_name

    kernels, name, pending = {}, None, []
    for line in sass.splitlines():
        if "Function :" in line:
            name, pending = kernel_name(line.split("Function :")[1].strip()), []
            kernels[name] = {"insns": [], "labels": {}}
            continue
        if name is None:
            continue
        m = _LABEL.match(line)
        if m:
            pending.append(m.group(1))
            continue
        m = _INSN.search(line)
        if m:
            addr = int(m.group(1), 16)
            for lab in pending:
                kernels[name]["labels"][lab] = addr
            pending = []
            kernels[name]["insns"].append((addr, m.group(2), m.group(4)))
    return kernels


def loops(kernel: dict) -> list[tuple[int, int]]:
    """(start, end) addresses of every backward branch's span."""
    out = []
    for addr, op, operands in kernel["insns"]:
        if op != "BRA":
            continue
        lab = re.search(r"\.L_x_\d+", operands)
        if lab:
            target = kernel["labels"].get(lab.group())
        else:
            hexa = re.search(r"0x([0-9a-f]+)", operands)
            target = int(hexa.group(1), 16) if hexa else None
        if target is not None and target <= addr:
            out.append((target, addr))
    return sorted(set(out))


def classify(insns) -> dict[str, int]:
    c = Counter(CLASSES.get(op, "other") for _, op, _ in insns)
    return dict(sorted(c.items()))


def opcodes(insns) -> dict[str, int]:
    return dict(Counter(op for _, op, _ in insns).most_common())


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("source")
    ap.add_argument("--kernel", default="")
    args = ap.parse_args()
    sys.path.insert(0, str(REPO / "src"))
    from repro_torch.kernels import _build

    _build.build(args.source)
    lib = _build.library_path(args.source)
    tool = shutil.which("cuobjdump") or str(Path(_build._nvcc()).parent / "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True, check=True,
                          timeout=300).stdout
    for name, k in parse(sass).items():
        if args.kernel not in name:
            continue
        insns = k["insns"]
        print(json.dumps({"kernel": name, "library": lib.name, "instructions": len(insns),
                          "by_class": classify(insns)}))
        for start, end in loops(k):
            span = [i for i in insns if start <= i[0] <= end]
            print(json.dumps({"kernel": name, "loop": [hex(start), hex(end)],
                              "instructions": len(span), "by_class": classify(span),
                              "by_opcode": opcodes(span)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
