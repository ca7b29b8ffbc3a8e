"""ctypes bindings to the port's own wav reader library.

``csrc/dataservice_audio.cc`` is the audio half of the JAX package's C++
data service (``native/dataservice.cc``) without its JPEG decode, so it
needs no libjpeg: ``ops/_build.py`` compiles it with the host's ``g++`` at
first use into ``build/kernels/``. The entry points and their ctypes
signatures are those of ``data/native.py`` (the committed
``native/libdataservice.so``), but for ``ds_read_crops_packed``'s count of
the rows it copied (16-bit PCM) and decoded, and so are the results: bit
for bit the committed library's and the Python reads'
(``tests/test_torch_native_audio.py``).
``MCNCME_DISABLE_NATIVE`` switches it off as it does the committed one. A
failed build raises with the compiler's output.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional, Sequence, Tuple

import numpy as np

from mcncrossmodalemotions_torch.data.native import _c_args
from mcncrossmodalemotions_torch.ops import _ffi

LIBRARY = "dataservice_audio"
_PATHS = ctypes.POINTER(ctypes.c_char_p)
_I64P = ctypes.POINTER(ctypes.c_int64)
LIB = _ffi.Library(LIBRARY, {
    "ds_wav_info": (ctypes.c_int, [ctypes.c_char_p, _I64P]),
    "ds_wav_infos": (ctypes.c_int, [_PATHS, ctypes.c_int, ctypes.c_int,
                                    _I64P]),
    "ds_read_wav": (ctypes.c_int64, [ctypes.c_char_p, ctypes.c_int64,
                                     ctypes.c_int64,
                                     ctypes.POINTER(ctypes.c_float),
                                     ctypes.POINTER(ctypes.c_int32)]),
    "ds_read_crops": (ctypes.c_int, [_PATHS, _I64P, ctypes.c_int64,
                                     ctypes.c_int, ctypes.c_int,
                                     ctypes.POINTER(ctypes.c_float)]),
    "ds_read_crops_packed": (ctypes.c_int, [
        _PATHS, _I64P, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p, _I64P])})


def _load() -> Optional[ctypes.CDLL]:
    """The library, built here at first use; None while switched off."""
    if os.environ.get("MCNCME_DISABLE_NATIVE"):
        return None
    return LIB.load()


def _need() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError("the port's wav reader is switched off "
                           "(MCNCME_DISABLE_NATIVE)")
    return lib


def available() -> bool:
    """True unless switched off; builds the library if it is not built."""
    return _load() is not None


def wav_info(path: str) -> Tuple[int, int, int, int]:
    """(num_samples, sample_rate, channels, bits) from the header."""
    out = (ctypes.c_int64 * 4)()
    rc = _need().ds_wav_info(str(path).encode(), out)
    if rc != 0:
        raise IOError(f"ds_wav_info({path}) failed: {rc}")
    return tuple(int(v) for v in out)  # type: ignore[return-value]


def wav_infos(paths: Sequence[str], num_threads: int = 8) -> np.ndarray:
    """[count, 4] int64, each row ``wav_info`` of its file, the headers read
    in one threaded library call: a batch's reads release the interpreter
    lock once, not once a file, so a producer thread does not wait for the
    lock at every file while another thread issues work."""
    lib = _need()
    count = len(paths)
    c_paths = (ctypes.c_char_p * count)(*[str(p).encode() for p in paths])
    out = np.zeros((count, 4), np.int64)
    failures = lib.ds_wav_infos(
        c_paths, count, num_threads,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    if failures:
        bad = [str(p) for p, row in zip(paths, out) if row[0] < 0]
        raise IOError(f"ds_wav_infos: {failures}/{count} headers failed, "
                      f"first {bad[0]}")
    return out


def read_wav(path: str, start: int = 0, num_samples: int = -1):
    """Segment read -> (float32 mono [n], sample_rate); zero-padded past
    the end of the file."""
    lib = _need()
    if num_samples < 0:
        num_samples = wav_info(path)[0] - start
    out = np.zeros(num_samples, np.float32)
    rate = ctypes.c_int32(0)
    got = lib.ds_read_wav(str(path).encode(), start, num_samples,
                          out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                          ctypes.byref(rate))
    if got < 0:
        raise IOError(f"ds_read_wav({path}) failed")
    return out, int(rate.value)


def read_crops(paths: Sequence[str], starts: Sequence[int],
               num_samples: int, num_threads: int = 8) -> np.ndarray:
    """Threaded batched segment reads -> [count, num_samples] float32;
    short files are zero-padded (getBatchEmoVoxCeleb.m:115-119)."""
    lib = _need()
    count, c_paths, c_starts = _c_args(paths, starts)
    out = np.zeros((count, num_samples), np.float32)
    failures = lib.ds_read_crops(
        c_paths, c_starts, num_samples, count, num_threads,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    if failures:
        raise IOError(f"ds_read_crops: {failures}/{count} files failed")
    return out


PACKED_FORMATS = {"int16": (0, np.int16), "mulaw8": (1, np.uint8)}


def read_crops_packed(paths: Sequence[str], starts: Sequence[int],
                      num_samples: int, num_threads: int = 8, *,
                      fmt: str = "int16") -> np.ndarray:
    """Threaded segment reads fused with the device-feed quantisation ->
    [count, n] int16 (``fmt="int16"``: ``data.audio.pack_pcm16`` of the
    float read) or uint8 mu-law (``fmt="mulaw8"``: ``pack_mulaw8``), bit
    for bit. A 16-bit PCM file's samples are copied, any other file's
    decoded and packed: each row read adds one to ``read_crops_packed.raw_rows``
    or to ``read_crops_packed.decoded_rows`` (``reset_rows`` zeroes both)."""
    if fmt not in PACKED_FORMATS:
        raise ValueError(f"unknown feed format {fmt!r}; choose from "
                         f"{sorted(PACKED_FORMATS)}")
    mode, dtype = PACKED_FORMATS[fmt]
    lib = _need()
    count, c_paths, c_starts = _c_args(paths, starts)
    out = np.zeros((count, num_samples), dtype)
    rows = (ctypes.c_int64 * 2)()
    failures = lib.ds_read_crops_packed(
        c_paths, c_starts, num_samples, count, num_threads, mode,
        out.ctypes.data_as(ctypes.c_void_p), rows)
    read_crops_packed.raw_rows += rows[0]
    read_crops_packed.decoded_rows += rows[1]
    if failures:
        raise IOError(f"ds_read_crops_packed: {failures}/{count} files failed")
    return out


def reset_rows() -> None:
    """Zero ``read_crops_packed``'s counts of copied and decoded rows."""
    read_crops_packed.raw_rows = read_crops_packed.decoded_rows = 0


reset_rows()
