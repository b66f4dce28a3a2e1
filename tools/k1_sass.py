#!/usr/bin/env python3
"""K1's compiled code, tree against tree: each source tree's
``csrc/tilted_fusion.cu`` built with the package's nvcc flags, and for every
K1 instance its registers, stack and spills (``cuobjdump
--dump-resource-usage``) and its SASS opcode counts (``cuobjdump -sass``).

Run from the root of a checkout, on a machine with nvcc (no card needed):

    python3 tools/k1_sass.py [--out DIR] [--match REGEX] LABEL=SRC_DIR ...

Each ``SRC_DIR`` is a ``src`` directory (this checkout's, or another
commit's unpacked with ``git archive`` into a directory ``.gitignore``
lists).  The whole SASS of each build goes to ``DIR/<label>.sass``
(default ``build/k1_sass``, beside the libraries).  For the instances
whose mangled name matches ``--match`` (default: the narrow fp32 Chp 32
instance, with or without the mixed-launch flag; each instance is known by
the text the regex matches, e.g. ``--match
'tilted_fusion_wide_kernelI(f|13__nv_bfloat16)Li[0-9]+E'`` for every wide
one) it prints, per tree, the instruction count of each opcode and, per
instance, the opcodes whose counts differ between the trees.
"""

import argparse
import collections
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))


def functions(sass: str):
    """Mangled function name -> its SASS instruction lines."""
    out, name = {}, None
    for line in sass.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            out[name] = []
        elif name and re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+\S", line):
            out[name].append(line)
    return out


def opcodes(lines):
    """Instruction counts by opcode (predicates dropped, modifiers kept)."""
    count = collections.Counter()
    for line in lines:
        body = re.sub(r"^\s*/\*[0-9a-f]{4,}\*/\s+", "", line)
        body = re.sub(r"^@!?U?P\w+\s+", "", body)
        count[body.split(" ")[0].rstrip(";")] += 1
    return count


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="+", metavar="LABEL=SRC_DIR")
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "k1_sass"))
    ap.add_argument("--match", default=r"tilted_fusion_kernelIfLi32E(Lb0E)?E")
    args = ap.parse_args(argv)
    import repro_torch.kernels._build as b

    os.makedirs(args.out, exist_ok=True)
    cuobjdump = os.path.join(os.path.dirname(b.nvcc_path()), "cuobjdump")
    procs = {}
    for spec in args.trees:
        label, src = spec.split("=", 1)
        lib = os.path.join(args.out, f"lib{label}.so")
        cu = os.path.join(src, "repro_torch", "kernels", "csrc", "tilted_fusion.cu")
        procs[label] = (subprocess.Popen([b.nvcc_path(), *b.NVCC_FLAGS, "-o", lib, cu],
                                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                         text=True), lib)
    counts = {}  # label -> instance -> opcode counts
    for label, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {label}:\n{log[-4000:]}")
        usage = subprocess.run([cuobjdump, "--dump-resource-usage", lib], capture_output=True,
                               text=True, check=True).stdout
        sass = subprocess.run([cuobjdump, "-sass", lib], capture_output=True, text=True,
                              check=True).stdout
        with open(os.path.join(args.out, f"{label}.sass"), "w") as f:
            f.write(sass)
        name = None
        for line in usage.splitlines():
            m = re.search(r"Function (\S+):", line)
            if m:
                name = m.group(1)
            res = re.search(r"REG:\d+ STACK:\d+ SHARED:\d+ LOCAL:\d+", line)
            if res and name and re.search(args.match, name):
                print(f"{label} {name}: {res.group(0)}")
        counts[label] = {}
        for fn, lines in functions(sass).items():
            m = re.search(args.match, fn)
            if m:
                counts[label][m.group(0)] = ops = opcodes(lines)
                print(f"{label} {fn}: {len(lines)} instructions; " + ", ".join(
                    f"{op} {n}" for op, n in ops.most_common()), flush=True)
    labels = list(counts)
    for a, c in zip(labels, labels[1:]):
        for inst in sorted(set(counts[a]) | set(counts[c])):
            ca, cc = counts[a].get(inst), counts[c].get(inst)
            if ca is None or cc is None:
                print(f"{a} -> {c} {inst}: only in {a if cc is None else c}")
                continue
            diff = [f"{op} {ca[op]} -> {cc[op]}" for op in sorted(set(ca) | set(cc))
                    if ca[op] != cc[op]]
            print(f"{a} -> {c} {inst}: " + ("; ".join(diff) if diff
                                            else "the same opcode counts"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
