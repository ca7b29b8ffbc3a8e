"""Build the CUDA kernels in ``csrc/`` at first use and load them.

Each ``csrc/<name>.cu`` exposes a plain C interface (no PyTorch headers)
and is compiled by ``nvcc`` for Hopper (``sm_90a``) into a shared
library under ``build/kernels/`` at the repository root, then loaded with
``ctypes``. A build of one such file takes seconds; no ``ninja`` and no
``torch.utils.cpp_extension`` are involved. The library's file name
carries a hash of its source, so an edited kernel is rebuilt and a stale
library is never loaded.

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


def library_path(name: str) -> Path:
    """Where the library built from ``csrc/<name>.cu`` lives."""
    digest = hashlib.sha1((CSRC / f"{name}.cu").read_bytes()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:12]}.so"


def load(name: str) -> ctypes.CDLL:
    """Build ``csrc/<name>.cu`` if its library is missing, then load it.

    The compiler's output (``-Xptxas=-v``: registers, shared memory and
    spills per kernel) is kept beside the library as ``<lib>.log``.
    """
    with _lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        so = library_path(name)
        build_seconds[name] = 0.0
        if not so.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                   str(CSRC / f"{name}.cu")]
            t0 = time.perf_counter()
            proc = subprocess.run(cmd, capture_output=True, text=True)
            build_seconds[name] = time.perf_counter() - t0
            so.with_suffix(".log").write_text(proc.stdout + proc.stderr)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {name}.cu:\n"
                                   f"{proc.stdout}{proc.stderr}")
            os.replace(tmp, so)  # atomic: concurrent builds never race
        lib = ctypes.CDLL(str(so))
        _libs[name] = lib
        return lib
