"""Hopper counterparts of the round-2 Mosaic probes (``tools/probe_mosaic2.py``).

    python -m mcncrossmodalemotions_torch.tools.probe_mosaic2

P4r, P4s, P4b, P12 and P1r at the unaligned pool1 tile (W = 197 input
columns, Wh = 100 candidate columns, C = 96), with the JAX tool's names,
seeds (``RandomState(0)`` for the candidates, ``RandomState(1)`` for P12's
input), dtypes and numpy ``expect`` arrays. The repeats and P1r run on
``probe_gather`` (P1r's indices are an operand of the probe, as in the JAX
tool); P12 runs on ``probe_col_candidates``.
"""

from __future__ import annotations

import sys
from typing import List

import numpy as np
import torch

from mcncrossmodalemotions_torch.ops import probes
from mcncrossmodalemotions_torch.tools import (
    Probe,
    exit_code,
    gather_probe,
    run_all,
)

T, W, C = 16, 197, 96  # the pool1 tile: W input columns, Wout = 98
WH = (W + 1) // 2 + 1  # 100 candidate columns including the halo


def expect12(xin: np.ndarray, x3: np.ndarray) -> np.ndarray:
    """numpy's P12 with y = x3 and dy = 2 x3, as the JAX tool computes it."""
    grad = np.zeros_like(xin)
    for k2 in (0, 1):
        yc = np.repeat(x3[:, 1 - k2:], 2, axis=1)[:, :W]
        dyc = np.repeat(x3[:, 1 - k2:] * 2, 2, axis=1)[:, :W]
        m = xin == yc
        if k2:
            m &= (np.arange(W) % 2 == 0)[None, :, None]
        grad += np.where(m, dyc, 0.0)
    return grad


def make_probes(device: torch.device) -> List[Probe]:
    x3 = np.random.RandomState(0).randn(T, WH, C).astype(np.float32)
    xin = np.random.RandomState(1).randn(T, W, C).astype(np.float32)
    a3 = torch.from_numpy(x3).to(device)
    ab = torch.from_numpy(x3).to(torch.bfloat16).to(device)  # round to nearest even

    S, L = 16, 256
    x2 = np.arange(S * L, dtype=np.float32).reshape(S, L)
    idx_l = np.repeat(np.arange(L // 2), 2).astype(np.int32)
    return [
        gather_probe("P4r 3D sublane repeat (Wh=100,C=96)", a3, 1,
                     np.repeat(np.arange(WH), 2)[:W],
                     np.repeat(x3, 2, axis=1)[:, :W]),
        gather_probe("P4s shifted sublane repeat", a3, 1,
                     np.repeat(np.arange(WH)[1:], 2)[:W],
                     np.repeat(x3[:, 1:], 2, axis=1)[:, :W]),
        gather_probe("P4b 3D sublane repeat bf16", ab, 1,
                     np.repeat(np.arange(WH), 2)[:W],
                     np.repeat(ab.float().cpu().numpy(), 2, axis=1)[:, :W]),
        Probe("P12 full col-candidate expansion", probes.probe_col_candidates,
              probes.col_candidates,
              (torch.from_numpy(xin).to(device), a3,
                     torch.from_numpy(x3 * 2).to(device)),
              expect12(xin, x3)),
        gather_probe("P1r 2D lane gather (operand idx)",
                     torch.from_numpy(x2).to(device), 1, idx_l, x2[:, idx_l]),
    ]


def main(device: torch.device | str = "cuda"):
    """Run the five probes on ``device`` (the card by default);
    {name: (ran, match)}."""
    return run_all(make_probes, device, "probe_mosaic2")


if __name__ == "__main__":
    sys.exit(exit_code(main()))
