"""Counts the SASS instructions of the built kernel library's loops: the
static issue cost of a kernel's inner work, from which its issue floor
follows (instructions / (SMs x 4 warp instructions per clock x the clock)).

    python -m u2pl_tpu_torch.kernels.sass_count [--lib LIBRARY]

It builds the library (as `kernels.load` does), disassembles it with the
CUDA toolkit's `cuobjdump -sass`, and prints one JSON line: the card's
name, power limit and maximum SM clock (nvidia-smi), and for every
instance of the stats kernels of upsample_ce.cu and of K6's forward its
instruction count, and each loop (a backward branch and its target) that holds a
special-function exp2 (MUFU.EX2), a shared-memory load or a shuffle: its
instructions, MUFU.EX2, MUFU.LG2, MUFU.RCP, SHFL, LDS and STS counts.  A
loop's body is counted once, as written: both sides of a branch in it are
counted, a subroutine it calls (the slow path of an IEEE division) is not.
--lib counts another checkout's built library.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys

INSTR = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
LABEL = re.compile(r"^\s*(\.L_x_\d+):")
BRANCH = re.compile(r"\bBRA\b.*?(?:0x([0-9a-f]+)|`\((\.L_x_\d+)\))")
MATCH = ("upsample_softmax_stats", "stats_ring", "infonce_fwd")


def functions(sass: str):
    """{mangled name: [(address, instruction text)], labels {name: address}}."""
    out, name, body, labels, pending = {}, None, [], {}, []
    for line in sass.splitlines():
        if "Function :" in line:
            if name:
                out[name] = (body, labels)
            name, body, labels, pending = line.split("Function :")[1].strip(), [], {}, []
            continue
        if name is None:
            continue
        m = LABEL.match(line)
        if m:
            pending.append(m.group(1))
            continue
        m = INSTR.search(line)
        if m:
            addr = int(m.group(1), 16)
            for lab in pending:
                labels[lab] = addr
            pending = []
            body.append((addr, m.group(2)))
    if name:
        out[name] = (body, labels)
    return out


def loops(body, labels):
    """Each loop [target, branch] with its counts, innermost first."""
    found = []
    for i, (addr, text) in enumerate(body):
        m = BRANCH.search(text)
        if not m:
            continue
        target = int(m.group(1), 16) if m.group(1) else labels.get(m.group(2), -1)
        if 0 <= target < addr:
            seg = [t for a, t in body if target <= a <= addr]
            count = lambda op: sum(1 for t in seg if op in t)  # noqa: E731
            found.append({"start": hex(target), "end": hex(addr), "instructions": len(seg),
                          "ex2": count("MUFU.EX2"), "lg2": count("MUFU.LG2"),
                          "rcp": count("MUFU.RCP"), "shfl": count("SHFL"),
                          "lds": count("LDS"), "sts": count("STS")})
    found = [lp for lp in found if lp["ex2"] or lp["lds"] or lp["shfl"]]
    return sorted(found, key=lambda lp: lp["instructions"])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--lib", default=None, help="a built library (default: build the sources)")
    args = ap.parse_args()
    if args.lib:
        lib = args.lib
    else:
        from u2pl_tpu_torch.kernels.build import build

        lib = build()[0]
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", lib], capture_output=True, text=True,
                          check=True).stdout
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout
    out = {"card": smi.strip(), "library": os.path.basename(lib), "kernels": {}}
    for name, (body, labels) in functions(sass).items():
        if any(m in name for m in MATCH):
            out["kernels"][name] = {"instructions": len(body), "loops": loops(body, labels)}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
