"""ctypes bindings to the port's own face-frame decoder library.

``csrc/dataservice_faces.cc`` is the face half of the JAX package's C++ data
service (``native/dataservice.cc``) with a baseline JPEG decoder of its own
in place of libjpeg, so it builds and runs on hosts without libjpeg:
``ops/_build.py`` compiles it with the host's ``g++`` at first use into
``build/kernels/``. ``decode_faces`` has the signature and the results of
``mcncrossmodalemotions_tpu/data/native.py``'s: bit for bit the committed
``native/libdataservice.so``'s frames, and ``decode_jpeg_rgb`` bit for bit
libjpeg-turbo's RGB (``tests/test_torch_faces.py``).
``MCNCME_DISABLE_NATIVE`` switches it off as it does the wav reader. A
failed build raises with the compiler's output; a failed decode raises
``IOError``.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional, Sequence

import numpy as np

LIBRARY = "dataservice_faces"
_lib: Optional[ctypes.CDLL] = None

DECODE_ERRORS = {-1: "cannot be read", -2: "malformed header",
                 -3: "unsupported coding (progressive, arithmetic, 12-bit, "
                     "CMYK or sampling)",
                 -4: "over 64 MP", -5: "buffer too small"}
"""``ds_decode_jpeg_rgb``'s return codes."""


def _load() -> Optional[ctypes.CDLL]:
    """The library, built here at first use; None while switched off."""
    global _lib
    if os.environ.get("MCNCME_DISABLE_NATIVE"):
        return None
    if _lib is not None:
        return _lib
    from mcncrossmodalemotions_torch.ops import _build

    lib = _build.load(LIBRARY)
    lib.ds_decode_face.restype = ctypes.c_int
    lib.ds_decode_face.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                   ctypes.c_double,
                                   ctypes.POINTER(ctypes.c_ubyte)]
    lib.ds_decode_faces.restype = ctypes.c_int
    lib.ds_decode_faces.argtypes = [ctypes.POINTER(ctypes.c_char_p),
                                    ctypes.c_int, ctypes.c_int,
                                    ctypes.c_double, ctypes.c_int,
                                    ctypes.POINTER(ctypes.c_ubyte)]
    lib.ds_decode_jpeg_rgb.restype = ctypes.c_int
    lib.ds_decode_jpeg_rgb.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                       ctypes.c_void_p,
                                       ctypes.POINTER(ctypes.c_int32),
                                       ctypes.POINTER(ctypes.c_int32)]
    _lib = lib
    return lib


def _need() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError("the port's face decoder is switched off "
                           "(MCNCME_DISABLE_NATIVE)")
    return lib


def available() -> bool:
    """True unless switched off; builds the library if it is not built."""
    return _load() is not None


def decode_faces(paths: Sequence[str], out_size: int = 224,
                 crop_ratio: float = 1.0 / 1.6,
                 num_threads: int = 8) -> np.ndarray:
    """Threaded JPEG decode + centered square crop of side ``crop_ratio *
    min(h, w)`` + align-corners resize + gray -> [count, S, S, 1] uint8,
    on at most ``num_threads`` threads of the library's pool (which an
    earlier call may have grown larger). Raises ``IOError`` naming the
    count of files that failed."""
    if out_size < 2:  # the align-corners resize divides by out_size - 1
        raise ValueError(f"out_size must be at least 2, not {out_size}")
    lib = _need()
    count = len(paths)
    out = np.zeros((count, out_size, out_size), np.uint8)
    c_paths = (ctypes.c_char_p * count)(*[str(p).encode() for p in paths])
    failures = lib.ds_decode_faces(
        c_paths, count, out_size, crop_ratio, num_threads,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)))
    if failures:
        raise IOError(f"ds_decode_faces: {failures}/{count} files failed")
    return out[..., None]


def decode_jpeg_rgb(path: str) -> np.ndarray:
    """The whole decoded image, [h, w, 3] uint8 RGB (libjpeg-turbo's default
    decompression). Raises ``IOError`` with the decoder's reason."""
    lib = _need()
    w, h = ctypes.c_int32(0), ctypes.c_int32(0)
    encoded = str(path).encode()
    rc = lib.ds_decode_jpeg_rgb(encoded, 0, None, ctypes.byref(w),
                                ctypes.byref(h))
    if rc == -5:  # the size is known now
        out = np.empty((h.value, w.value, 3), np.uint8)
        rc = lib.ds_decode_jpeg_rgb(encoded, out.size,
                                    out.ctypes.data_as(ctypes.c_void_p),
                                    ctypes.byref(w), ctypes.byref(h))
        if rc == 0:
            return out
    raise IOError(f"ds_decode_jpeg_rgb({path}): "
                  f"{DECODE_ERRORS.get(rc, f'code {rc}')}")
