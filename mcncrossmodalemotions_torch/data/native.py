"""ctypes bindings to the C++ data service (``native/libdataservice.so``).

The port's copy of the wav-crop entry points of
``mcncrossmodalemotions_tpu/data/native.py``: the same library at the
repository root, the same ``MCNCME_DISABLE_NATIVE`` kill-switch, and the
same contract that the Python reads in ``data/audio.py`` are the fallback
with identical results (``tests/test_torch_host_copies.py``). Loading a
shared library imports nothing of the JAX package. Build: ``make -C
native``.
"""

from __future__ import annotations

import ctypes
import os
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

_LIB_PATH = Path(__file__).resolve().parents[2] / "native" / "libdataservice.so"
_lib: Optional[ctypes.CDLL] = None


def _load() -> Optional[ctypes.CDLL]:
    """The loaded library, or None when it is switched off or not built."""
    global _lib
    if _lib is not None:
        return _lib
    if os.environ.get("MCNCME_DISABLE_NATIVE") or not _LIB_PATH.exists():
        return None
    lib = ctypes.CDLL(str(_LIB_PATH))
    lib.ds_read_crops.restype = ctypes.c_int
    lib.ds_read_crops.argtypes = [ctypes.POINTER(ctypes.c_char_p),
                                  ctypes.POINTER(ctypes.c_int64),
                                  ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                                  ctypes.POINTER(ctypes.c_float)]
    if hasattr(lib, "ds_read_crops_packed"):  # newer native builds
        lib.ds_read_crops_packed.restype = ctypes.c_int
        lib.ds_read_crops_packed.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p]
    _lib = lib
    return lib


def available() -> bool:
    return _load() is not None


def _c_args(paths: Sequence[str], starts: Sequence[int]):
    count = len(paths)
    return (count, (ctypes.c_char_p * count)(*[str(p).encode() for p in paths]),
            (ctypes.c_int64 * count)(*[int(s) for s in starts]))


def read_crops(paths: Sequence[str], starts: Sequence[int],
               num_samples: int, num_threads: int = 8) -> np.ndarray:
    """Threaded batched segment reads -> [count, num_samples] float32;
    short files are zero-padded (getBatchEmoVoxCeleb.m:115-119)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native data service not built")
    count, c_paths, c_starts = _c_args(paths, starts)
    out = np.zeros((count, num_samples), np.float32)
    failures = lib.ds_read_crops(
        c_paths, c_starts, num_samples, count, num_threads,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    if failures:
        raise IOError(f"ds_read_crops: {failures}/{count} files failed")
    return out


def packed_reads_available() -> bool:
    """True when the built library has the fused read+quantise entry."""
    lib = _load()
    return lib is not None and hasattr(lib, "ds_read_crops_packed")


def read_crops_packed(paths: Sequence[str], starts: Sequence[int],
                      num_samples: int, num_threads: int = 8) -> np.ndarray:
    """Threaded segment reads fused with the device-feed quantisation ->
    [count, n] int16 (``data.audio.pack_pcm16`` of the float read, bit for
    bit). The library's mu-law mode is not bound: the port feeds PCM16."""
    lib = _load()
    if lib is None or not hasattr(lib, "ds_read_crops_packed"):
        raise RuntimeError("native packed reads not built (make -C native)")
    count, c_paths, c_starts = _c_args(paths, starts)
    out = np.zeros((count, num_samples), np.int16)
    failures = lib.ds_read_crops_packed(
        c_paths, c_starts, num_samples, count, num_threads, 0,  # mode 0: int16
        out.ctypes.data_as(ctypes.c_void_p))
    if failures:
        raise IOError(f"ds_read_crops_packed: {failures}/{count} files failed")
    return out
