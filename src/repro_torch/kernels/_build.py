"""Build the package's CUDA kernels with ``nvcc`` and load them with ctypes.

Each source under ``kernels/csrc/`` compiles on first use into one shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds), in ``build/repro_torch/`` at the root of the checkout — a
directory ``.gitignore`` lists.  The library name carries a digest of the
source and the flags, so an edited source rebuilds and a stale library is
never loaded.  A failed build raises with the compiler's output; nothing
falls back to another implementation.

``build_all()`` starts one ``nvcc`` per source, all at once, and waits for
them — what a cold start (``chip_smoke.py``) calls before the first launch.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Tuple

__all__ = ["SOURCES", "BUILD_DIR", "NVCC_FLAGS", "build_all", "library_path", "load", "load_log",
           "nvcc_path"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)
# kernel name -> source file under csrc/
SOURCES: Dict[str, str] = {"tilted_fusion": "tilted_fusion.cu", "conv3x3": "conv3x3.cu",
                           "sr_epilogue": "sr_epilogue.cu", "esa": "esa.cu"}

_loaded: Dict[str, ctypes.CDLL] = {}
_log: List[Tuple[str, bool]] = []  # (kernel, compiled by nvcc) per first load, in order
_lock = threading.Lock()


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH,
    else the toolkit's default install location."""
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH); the CUDA "
        "kernels are built from source on first use"
    )


def library_path(name: str) -> Path:
    """Where kernel ``name``'s library is (or will be) built."""
    src = CSRC / SOURCES[name]
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build_all(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Compile every kernel in ``names`` (default: all) that has no library
    yet, one ``nvcc`` per source, all started together.  Returns the
    seconds each build took (0.0 for a library already built); raises
    ``RuntimeError`` carrying the compiler output if any build fails."""
    names = list(SOURCES if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    times = {}
    t0 = time.perf_counter()
    for name in names:
        lib = library_path(name)
        if lib.exists():
            times[name] = 0.0
            continue
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[name])]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ), tmp, lib)
    errors = []
    for name, (proc, tmp, lib) in procs.items():
        output, _ = proc.communicate()
        times[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {SOURCES[name]} "
                          f"(exit {proc.returncode}):\n{output}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, lib)
    if errors:
        raise RuntimeError("\n".join(errors))
    return times


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            path = library_path(name)
            compiled = not path.exists()
            if compiled:
                build_all([name])
            lib = ctypes.CDLL(str(path))
            _loaded[name] = lib
            _log.append((name, compiled))
        return lib


def load_log() -> List[Tuple[str, bool]]:
    """Every first load of a kernel library in this process, in order:
    ``(kernel, compiled)``, ``compiled`` when ``nvcc`` ran for it then.
    ``engine.executor.executor_artifacts`` reads it to find builds that a
    serving call triggered."""
    with _lock:
        return list(_log)
