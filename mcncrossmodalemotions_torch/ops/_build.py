"""Build the native sources in ``csrc/`` at first use and load them.

Each ``csrc/<name>.cu`` exposes a plain C interface (no PyTorch headers)
and is compiled by ``nvcc`` for Hopper (``sm_90a``); each
``csrc/<name>.cc`` (the host-side wav reader) is compiled by the host's
C++ compiler (``g++``, or ``$CXX``). Either becomes a shared library under
``build/kernels/`` at the repository root, loaded with ``ctypes``. A
build of one such file takes seconds; no ``ninja`` and no
``torch.utils.cpp_extension`` are involved. The library's file name
carries a hash of its source, so an edited source is rebuilt and a stale
library is never loaded. A failed compile raises with the compiler's
output.

Nothing here runs at import: the CPU tests import every module of the
package on a machine without ``nvcc``.
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
from typing import Dict

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")
# the native/Makefile's flags without -march=native: the library may be
# built on one host and run on another of the same architecture
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-Wall")
CXX_LIBS = ("-lpthread",)

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()
build_seconds: Dict[str, float] = {}
"""Wall seconds each library's compile took in this process (0 when a
library built earlier was loaded)."""


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME", ""), "/usr/local/cuda"):
        path = Path(cand) / "bin" / "nvcc"
        if cand and path.exists():
            return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return found


def _cxx() -> str:
    found = shutil.which(os.environ.get("CXX", "g++"))
    if found is None:
        raise RuntimeError("no host C++ compiler (g++ or $CXX) found: the "
                           "wav reader library is built with one")
    return found


def source_path(name: str) -> Path:
    """``csrc/<name>.cu`` (a CUDA kernel) or ``csrc/<name>.cc`` (host code)."""
    cu = CSRC / f"{name}.cu"
    return cu if cu.exists() else CSRC / f"{name}.cc"


def library_path(name: str) -> Path:
    """Where the library built from ``source_path(name)`` lives."""
    digest = hashlib.sha1(source_path(name).read_bytes()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:12]}.so"


def _command(name: str, out: Path) -> list:
    src = source_path(name)
    if src.suffix == ".cu":
        return [_nvcc(), *NVCC_FLAGS, "-o", str(out), str(src)]
    return [_cxx(), *CXX_FLAGS, "-o", str(out), str(src), *CXX_LIBS]


def load(*names: str) -> ctypes.CDLL:
    """Build each ``csrc/<name>.cu`` or ``.cc`` whose library is missing,
    then load them; returns the last one's library.

    The missing libraries are compiled at once, one compiler process each.
    The compiler's output (for a kernel, ``-Xptxas=-v``: registers, shared
    memory and spills per kernel) is kept beside the library as
    ``<lib>.log``.
    """
    with _lock:
        todo = [n for n in names if n not in _libs]
        procs = {}
        for name in todo:
            so = library_path(name)
            build_seconds[name] = 0.0
            if not so.exists():
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                tmp = so.with_suffix(f".{os.getpid()}.tmp")
                procs[name] = (tmp, time.perf_counter(), subprocess.Popen(
                    _command(name, tmp), stdout=subprocess.PIPE,
                    stderr=subprocess.STDOUT, text=True))
        failed = []
        for name, (tmp, t0, proc) in procs.items():
            out, _ = proc.communicate()
            build_seconds[name] = time.perf_counter() - t0
            so = library_path(name)
            so.with_suffix(".log").write_text(out)
            if proc.returncode != 0:
                failed.append(f"{Path(proc.args[0]).name} failed for "
                              f"{source_path(name).name}:\n{out}")
            else:
                os.replace(tmp, so)  # atomic: concurrent builds never race
        if failed:
            raise RuntimeError("\n".join(failed))
        for name in todo:
            _libs[name] = ctypes.CDLL(str(library_path(name)))
        return _libs[names[-1]]
