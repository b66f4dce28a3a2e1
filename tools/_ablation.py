"""What the kernel-variant tools share (``tools/k1_ablation.py``,
``tools/k2_ablation.py``, ``tools/k1_bf16_rounding.py``): a kernel's source
edited as text, every variant compiled at once with the package's own nvcc
flags, the card's name and power limit, and device time of launches queued
behind a device sleep.

Not a script: the tools import it from their own directory.
"""

import ctypes
import os
import re
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))


def edits(*pairs):
    """A source transform: each ``(old, new)`` replaces every occurrence of
    the text ``old``, or calls ``old(src, new) -> (src, count)`` where ``old``
    is a function; it raises where nothing was replaced, so a variant cannot
    silently build the unedited source."""
    def apply(src):
        for old, new in pairs:
            if callable(old):
                src, n = old(src, new)
            else:
                n = src.count(old)
                src = src.replace(old, new)
            if n < 1:
                raise RuntimeError(f"the source no longer holds the text this variant "
                                   f"edits: {old!r}")
        return src
    return apply


def build(src_path, out_dir, variants, entry, label):
    """Compile ``variants`` (name -> source transform) of ``src_path`` into
    ``out_dir/lib<name>.so``, all nvcc processes at once, and print each
    instance's registers and spills from ``ptxas -v``.  ``entry`` is a regex
    on the mangled name of a kernel function; ``label(match)`` names the
    instance.  Returns name -> library path."""
    import repro_torch.kernels._build as b

    os.makedirs(out_dir, exist_ok=True)
    src = open(src_path).read()
    procs = {}
    for name, transform in variants.items():
        path = os.path.join(out_dir, f"{name}.cu")
        with open(path, "w") as f:
            f.write(transform(src))
        lib = os.path.join(out_dir, f"lib{name}.so")
        procs[name] = (subprocess.Popen(
            [b.nvcc_path(), *b.NVCC_FLAGS, "-Xptxas", "-v", "-o", lib, path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{out[-4000:]}")
        # ptxas -v: "Compiling entry function <name>", then its spills, then
        # "Used N registers", for each instance in turn
        usage, inst, spilled = [], None, "?"
        for line in out.splitlines():
            m = re.search(r"Compiling entry function .*" + entry, line)
            if m:
                inst = label(m)
            m = re.search(r"(\d+) bytes spill stores", line)
            if m:
                spilled = m.group(1)
            m = re.search(r"Used (\d+) registers", line)
            if m and inst:
                usage.append(f"{inst} {m.group(1)} registers, {spilled} B spilled")
                inst = None
        print(f"{name}: {', '.join(usage)}", flush=True)
        for line in sorted({l.strip() for l in out.splitlines() if "arning" in l}):
            print(f"{name}: {line}", flush=True)
        libs[name] = lib
    return libs


def nvidia_smi() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()


def device_ms(fn, calls=5, rounds=3):
    """Median over ``rounds`` of the device time of ``calls`` calls of
    ``fn``, in ms a call, queued behind a device sleep so that the host's
    launch time does not show."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(40_000_000)  # the launches queue up behind ~20 ms
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def use_k1_library(path):
    """Swap the library behind ``tilted_fusion_call`` for the one at
    ``path`` (a build of a K1 variant)."""
    from repro_torch.kernels import tilted_fusion as ttf

    ttf._lib_handle = None
    ttf._blocks_per_sm.cache_clear()
    real = ttf._build.load
    ttf._build.load = lambda name: ctypes.CDLL(path)
    try:
        ttf._lib()
    finally:
        ttf._build.load = real


K1_SRC = os.path.join(ROOT, "src/repro_torch/kernels/csrc/tilted_fusion.cu")
# the narrow kernels: the on-chip route's (wgmma, or mma.sync) and the
# device-memory route's
K1_ENTRY = r"tilted_fusion_(wgmma_)?kernel(_onchip)?I(f|13__nv_bfloat16)Li(\d+)ELb([01])E"


def k1_label(m):
    route = "on chip, wgmma" if m.group(1) else "on chip" if m.group(2) else "device"
    return (f"<{'fp32' if m.group(3) == 'f' else 'bf16'}, chp {m.group(4)}"
            f"{', mixed' if m.group(5) == '1' else ''}> {route}")
