"""MATLAB ``-v7.3`` (HDF5) container helpers.

The port's copy of ``mcncrossmodalemotions_tpu/utils/mat73.py``
(``tests/test_torch_release.py`` holds it equal). One difference:
``is_hdf5`` looks for the HDF5 signature itself, with numpy only, so that
a classic ``.mat`` loads without ``h5py`` (hosts without it can still
read the classic container); ``h5py`` is imported only by the functions
that read a ``-v7.3`` file.

MATLAB saves ``-v7.3`` files as HDF5 with three conventions that every
importer here must undo (data/imdb.py's logits-imdb reader and
zoo/matconvnet.py's weight importer share this module):

- numeric arrays are stored column-major, i.e. with REVERSED axes: a
  MATLAB ``[H, W, Cin, Cout]`` single arrives as an ``[Cout, Cin, W, H]``
  dataset;
- char arrays are uint16 codepoint matrices (a 1xL string arrives
  ``[L, 1]``);
- cell arrays are datasets of HDF5 object references into ``/#refs#``;
  struct arrays become groups whose per-field datasets hold one
  reference per element.

The classic (pre-v7.3) container is scipy.io territory and not handled
here. Reference download sites ship both containers (the multi-GB
releases — the prebuilt logits imdb, the large VGGFace2 dags — are
necessarily ``-v7.3``; MATLAB cannot write >2 GB otherwise).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np


HDF5_SIGNATURE = b"\x89HDF\r\n\x1a\n"


def is_hdf5(path: str | Path) -> bool:
    """True when ``path`` is an HDF5 file: its signature at byte 0 or after
    a user block of 512, 1024, 2048, ... bytes (MATLAB writes a 512-byte
    one), where ``h5py.is_hdf5`` looks for it."""
    path = Path(path)
    if not path.is_file():
        return False
    size = path.stat().st_size
    with open(path, "rb") as f:
        offset = 0
        while offset + len(HDF5_SIGNATURE) <= size:
            f.seek(offset)
            if f.read(len(HDF5_SIGNATURE)) == HDF5_SIGNATURE:
                return True
            offset = 512 if offset == 0 else 2 * offset
    return False


def deref(f, obj):
    """Follow an object reference (no-op for datasets/arrays)."""
    import h5py

    if isinstance(obj, h5py.Reference):
        return f[obj]
    return obj


def matlab_string(f, obj) -> str:
    """Decode a MATLAB v7.3 string (uint16 codepoint array or ref)."""
    arr = np.asarray(deref(f, obj)).reshape(-1)
    return "".join(chr(int(c)) for c in arr)


def matlab_array(f, obj) -> np.ndarray:
    """Dereference + un-transpose a numeric array to its MATLAB shape."""
    arr = np.asarray(deref(f, obj))
    return arr.T if arr.ndim > 1 else arr


def cell_refs(ds) -> np.ndarray:
    """Flatten a cell/struct-field dataset to its reference list."""
    return np.asarray(ds).reshape(-1)


def string_cell(f, ds) -> np.ndarray:
    """Cell-of-strings dataset -> object array of python strings."""
    return np.asarray([matlab_string(f, r) for r in cell_refs(ds)],
                      dtype=object)
