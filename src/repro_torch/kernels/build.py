"""Build and load the hand-written CUDA kernels (the role ``compat.py``
plays for the Pallas kernels in the reference package).

Each ``csrc/<name>.cu`` has a plain C interface.  On first use it is compiled
with ``nvcc`` for ``sm_90a`` into a shared library under ``_build/`` beside
this file (listed in ``.gitignore``) and loaded with ``ctypes``.  A library's
file name carries a hash of its source, the ``csrc`` headers it includes
and the flags, so an edited source or header is rebuilt and a stale library
is never loaded.  Sources are compiled in parallel, one ``nvcc`` each.
Nothing is downloaded; a failed build raises.

Nothing here runs at import: the CPU tests import every module of the
package on a machine without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Iterable, List, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
KERNELS = ("flash_attention", "flash_decode", "selective_scan", "moe_gmm",
           "scenario_scan")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_loaded: Dict[str, ctypes.CDLL] = {}
# wall seconds of each kernel's nvcc in this process's last build (its
# sources compiled beside the others', all at once)
build_seconds: Dict[str, float] = {}


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, ``nvcc`` on PATH, or
    ``/usr/local/cuda/bin/nvcc``."""
    candidates: List[Optional[str]] = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    candidates += [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for c in candidates:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def sources(name: str) -> List[Path]:
    """``csrc/<name>.cu`` and the headers of ``csrc`` it includes by
    ``#include "..."``."""
    src = CSRC / f"{name}.cu"
    headers = re.findall(r'^#include "([^"]+)"', src.read_text(), re.M)
    return [src] + [CSRC / h for h in headers]


def library_path(name: str) -> Path:
    digest = hashlib.sha256()
    for path in sources(name):
        digest.update(path.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def log_path(name: str) -> Path:
    return BUILD_DIR / f"{name}.log"


def build(names: Iterable[str] = KERNELS) -> Dict[str, Path]:
    """Compile every named kernel that is not built yet, all ``nvcc``
    processes at once; return each library's path.  Raises on a failed
    build, with the compiler's output."""
    names = list(names)
    for n in names:
        if n not in KERNELS:
            raise KeyError(f"unknown kernel {n!r}; have {KERNELS}")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = [n for n in names if not library_path(n).exists()]
    if todo:
        nvcc = nvcc_path()
        procs = []
        t0 = time.perf_counter()
        for n in todo:
            tmp = library_path(n).with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
            procs.append((n, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True,
            )))

        def finish(proc):       # its output, and when it ended
            out, _ = proc.communicate()
            return out, time.perf_counter() - t0

        with ThreadPoolExecutor(len(procs)) as pool:
            done = list(pool.map(finish, [proc for _, _, proc in procs]))
        failed = []
        for (n, tmp, proc), (out, seconds) in zip(procs, done):
            build_seconds[n] = seconds
            log_path(n).write_text(out)
            if proc.returncode != 0:
                failed.append(f"{n} (exit {proc.returncode}):\n{out}")
            else:
                os.replace(tmp, library_path(n))
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return {n: library_path(n) for n in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if need be."""
    if name not in _loaded:
        path = build([name])[name]
        _loaded[name] = ctypes.CDLL(str(path))
    return _loaded[name]
