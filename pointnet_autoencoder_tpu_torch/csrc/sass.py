"""Counts the SASS instructions of the kernels' innermost loops in a built
kernel library, to explain a kernel's time by what it issues per pair.

    python -m pointnet_autoencoder_tpu_torch.csrc.sass LIB.so [LIB.so ...]
        [--points KERNEL_SUBSTRING=N ...]

For every kernel in each library (``cuobjdump -sass``), finds the
innermost loops (a backward branch whose range holds no other backward
branch) that issue an SFU instruction (``MUFU``) or a tensor-core
instruction (``HMMA``, ``HGMMA``), and every innermost loop of a kernel
that ``--points`` names. Prints per loop its instruction count,
``MUFU.EX2``, ``MUFU.RSQ``, ``HMMA``, ``HGMMA``, ``SHFL``, shared-memory
loads (``LDS``) and, where the loop streams points, per pair its
instructions and MUFU. A pair is one point of the streamed cloud against
one owned point: the loop's ``LDS.128`` count (one float4 per streamed
point) times the owned points per thread, 1 unless ``--points`` names the
kernel (e.g. ``--points emd_step=2``; ``--points nn_distance_kernel=8``
for the Chamfer forward, whose lanes own 8 queries); ``--ops N`` adds each
loop's N most frequent opcodes. Needs ``cuobjdump`` from the CUDA toolkit
(next to ``nvcc``).

    python -m pointnet_autoencoder_tpu_torch.csrc.sass \
        csrc/_build/chamfer-*.so csrc/_build/fused_head-*.so \
        --points nn_distance_kernel=8
"""

from __future__ import annotations

import argparse
import os
import re
import subprocess
import sys
from collections import Counter
from typing import Dict, List, Tuple

from pointnet_autoencoder_tpu_torch.csrc.build import find_nvcc

_FUNC = re.compile(r"^\s*Function : (\S+)")
_INSTR = re.compile(r"^\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_LABEL = re.compile(r"^\s*(\.L_x_\d+):")
_TARGET = re.compile(r"BRA\s+(?:`\((\.L_x_\d+)\)|(0x[0-9a-f]+))")


def disassemble(lib: str) -> Dict[str, List[Tuple[int, str]]]:
    """Kernel (mangled) name -> [(address, instruction text)], with each
    label's address recorded as the next instruction's."""
    cuobjdump = os.path.join(os.path.dirname(find_nvcc()), "cuobjdump")
    out = subprocess.run([cuobjdump, "-sass", lib], capture_output=True,
                         text=True, check=True).stdout
    funcs: Dict[str, List[Tuple[int, str]]] = {}
    labels: Dict[str, Dict[str, int]] = {}
    name, pending = None, []
    for line in out.splitlines():
        m = _FUNC.match(line)
        if m:
            name, pending = m.group(1), []
            funcs[name], labels[name] = [], {}
            continue
        if name is None:
            continue
        m = _LABEL.match(line)
        if m:
            pending.append(m.group(1))
            continue
        m = _INSTR.match(line)
        if m:
            addr = int(m.group(1), 16)
            for label in pending:
                labels[name][label] = addr
            pending = []
            funcs[name].append((addr, m.group(2)))
    # Resolve label targets into addresses inside the text.
    for fname, instrs in funcs.items():
        resolved = []
        for addr, text in instrs:
            t = _TARGET.search(text)
            if t and t.group(1):
                text = text.replace(t.group(1),
                                    hex(labels[fname].get(t.group(1), -1)))
            resolved.append((addr, text))
        funcs[fname] = resolved
    return funcs


def innermost_loops(instrs: List[Tuple[int, str]]):
    """[(start, end)] address ranges of the innermost backward branches."""
    loops = []
    for addr, text in instrs:
        m = re.search(r"BRA\s+(?:`\()?(0x[0-9a-f]+)", text)
        if m:
            target = int(m.group(1), 16)
            if 0 <= target <= addr:
                loops.append((target, addr))
    return [(a, b) for a, b in loops
            if not any(a <= c and d <= b and (c, d) != (a, b)
                       for c, d in loops)]


def loop_ops(instrs, start, end) -> List[str]:
    """Opcodes (predicate stripped) of the instructions in [start, end]."""
    return [re.sub(r"^@!?U?P\w+\s+", "", text).split()[0]
            for addr, text in instrs if start <= addr <= end]


def loop_counts(instrs, start, end) -> Dict[str, int]:
    ops = loop_ops(instrs, start, end)
    return {"instructions": len(ops),
            "MUFU.EX2": ops.count("MUFU.EX2"),
            "MUFU.RSQ": ops.count("MUFU.RSQ"),
            "HMMA": sum(o.startswith("HMMA") for o in ops),
            "HGMMA": sum(o.startswith("HGMMA") for o in ops),
            "SHFL": sum(o.startswith("SHFL") for o in ops),
            "LDS": sum(o.startswith("LDS") for o in ops),
            "LDS.128": ops.count("LDS.128")}


def demangled(name: str) -> str:
    """'void (anonymous namespace)::k<true, 1>(Args)' -> 'k<true, 1>'."""
    try:
        name = subprocess.run(["c++filt", name], capture_output=True,
                              text=True, check=True).stdout.strip()
    except (OSError, subprocess.CalledProcessError):
        return name
    name = name.replace("(anonymous namespace)::", "")
    return name.removeprefix("void ").split("(")[0]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("libs", nargs="+")
    p.add_argument("--points", action="append", default=[],
                   help="KERNEL_SUBSTRING=N owned points per thread")
    p.add_argument("--ops", type=int, default=0,
                   help="print each loop's N most frequent opcodes")
    args = p.parse_args(argv)
    points = dict((k, int(v)) for k, v in
                  (s.split("=", 1) for s in args.points))
    for lib in args.libs:
        print(f"== {lib}")
        for name, instrs in sorted(disassemble(lib).items()):
            pretty = demangled(name)
            named = [v for k, v in points.items() if k in pretty]
            per_thread = named[0] if named else 1
            for start, end in innermost_loops(instrs):
                c = loop_counts(instrs, start, end)
                if not (named or c["MUFU.EX2"] or c["MUFU.RSQ"] or c["HMMA"]
                        or c["HGMMA"]):
                    continue
                pairs = c["LDS.128"] * per_thread
                per_pair = (f"; per pair {c['instructions'] / pairs:.2f} "
                            f"instructions, "
                            f"{(c['MUFU.EX2'] + c['MUFU.RSQ']) / pairs:.2f} "
                            f"MUFU ({pairs} pairs)" if pairs else "")
                print(f"{pretty[:90]} loop "
                      f"{start:#x}-{end:#x}: {c}{per_pair}")
                if args.ops:
                    top = Counter(loop_ops(instrs, start, end)).most_common(
                        args.ops)
                    print("    " + ", ".join(f"{o} {k}" for o, k in top))
    return 0


if __name__ == "__main__":
    sys.exit(main())
