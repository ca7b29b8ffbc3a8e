"""The least bytes and operations of the port's two hand-written kernels.

K1, the spectrogram: reads each row's samples once and writes the
``[nfft, T]`` float32 magnitudes once; its operations are a real FFT's
5 N log2 N a frame (N = nfft). K2, the 3x3/2 max pool: its forward reads
x and writes y; in training the forward and backward are one operation
whose inputs are x and dy and whose outputs are y and dx, each counted
once. What tells the backward where each maximum was (x read again, or
the index the port's forward keeps) is an implementation's choice and is
not counted, so no design can read above 100%.
"""

from __future__ import annotations

import math
from typing import Iterable, Tuple


def k1_bytes(samples: int, frames: int, nfft: int, sample_bytes: int) -> int:
    """Bytes of one row: ``samples`` in, ``nfft x frames`` float32 out."""
    return samples * sample_bytes + nfft * frames * 4


def k1_flops(frames: int, nfft: int) -> float:
    """A real FFT's 5 N log2 N a frame."""
    return 5.0 * nfft * math.log2(nfft) * frames


def k2_bytes(pools: Iterable[Tuple[int, int, int, int, int]], elem_bytes: int,
             backward: bool) -> int:
    """Bytes of one row's pools: each (C, H, W, Ho, Wo) forward reads x and
    writes y; with ``backward`` each also reads dy and writes dx."""
    total = 0
    for c, h, w, ho, wo in pools:
        x, y = c * h * w * elem_bytes, c * ho * wo * elem_bytes
        total += (x + y) * (2 if backward else 1)
    return total


def roofline(bytes_: float, flops: float, seconds: float, peaks: dict,
             flops_key: str = "fp32_flops") -> Tuple[float, str]:
    """(the share of the least time, in %, and which bound it is) for work
    of ``bytes_`` and ``flops`` done in ``seconds`` of kernel time."""
    t_bytes = bytes_ / peaks["hbm_bytes"]
    t_flops = flops / peaks[flops_key]
    bound = max(t_bytes, t_flops)
    return 100.0 * bound / seconds, ("bytes" if t_bytes >= t_flops else "flops")
