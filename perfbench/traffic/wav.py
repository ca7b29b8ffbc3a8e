"""PCM16 mono RIFF writer and reader (a frozen copy of the port's
``data/audio.write_wav`` layout: a 44-byte header, then little-endian
int16 samples)."""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np


def write_pcm16(path: Path, pcm: np.ndarray, sample_rate: int) -> None:
    """Write int16 samples ``pcm`` as a mono PCM16 wav at ``path``."""
    payload = np.ascontiguousarray(pcm, "<i2").tobytes()
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", 36 + len(payload)) + b"WAVEfmt ")
        f.write(struct.pack("<IHHIIHH", 16, 1, 1, sample_rate,
                            sample_rate * 2, 2, 16))
        f.write(b"data" + struct.pack("<I", len(payload)))
        f.write(payload)


def read_pcm16(path: Path, start: int = 0, count: int | None = None):
    """(int16 samples [start, start + count), sample rate) of a mono PCM16
    wav: the chunks are walked to find ``fmt `` and ``data``."""
    with open(path, "rb") as f:
        head = f.read(12)
        if head[:4] != b"RIFF" or head[8:12] != b"WAVE":
            raise ValueError(f"{path}: not a RIFF/WAVE file")
        rate = None
        while True:
            hdr = f.read(8)
            if len(hdr) < 8:
                raise ValueError(f"{path}: no data chunk")
            cid, size = hdr[:4], struct.unpack("<I", hdr[4:])[0]
            if cid == b"fmt ":
                fmt = f.read(size)
                tag, chans, rate, _, _, bits = struct.unpack("<HHIIHH", fmt[:16])
                if tag != 1 or chans != 1 or bits != 16:
                    raise ValueError(f"{path}: not mono PCM16")
            elif cid == b"data":
                total = size // 2
                start = min(start, total)
                n = total - start if count is None else min(count, total - start)
                f.seek(start * 2, 1)
                return np.frombuffer(f.read(n * 2), "<i2").copy(), rate
            else:
                f.seek(size + (size & 1), 1)
