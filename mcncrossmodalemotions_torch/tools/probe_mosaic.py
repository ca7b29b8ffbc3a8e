"""Hopper counterparts of the Mosaic probes P1-P11 (``tools/probe_mosaic.py``).

    python -m mcncrossmodalemotions_torch.tools.probe_mosaic

The same probes, names, shapes (``[16, 256]`` and ``[8, 16, 128]`` f32,
``arange`` values) and numpy ``expect`` arrays as the JAX tool. Every data
movement the TPU probes ask Mosaic to lower is an index map here, built
with numpy from the same expression as the probe's ``expect`` and run by
``probe_gather``; P9's selection matmul runs on ``probe_select_matmul``.
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


def make_probes(device: torch.device) -> List[Probe]:
    S, L = 16, 256
    x2 = np.arange(S * L, dtype=np.float32).reshape(S, L)
    idx_l = np.repeat(np.arange(L // 2), 2).astype(np.int32)  # lane interleave
    idx_s = np.repeat(np.arange(S // 2), 2).astype(np.int32)  # sublane interleave
    T, W, C = 8, 16, 128
    x3 = np.arange(T * W * C, dtype=np.float32).reshape(T, W, C)
    idx_w = np.repeat(np.arange(W // 2), 2).astype(np.int32)
    idx_c = np.repeat(np.arange(C // 2), 2).astype(np.int32)
    a2 = torch.from_numpy(x2).to(device)
    a3 = torch.from_numpy(x3).to(device)

    def reshape(name, shape):
        """A reshape of x3 is the gather of its flat view by the reshaped
        positions."""
        pos = np.arange(x3.size).reshape(x3.shape).reshape(shape)
        index = probes.index_map(pos.ravel(), x3.size, device)
        return Probe(name, probes.probe_gather, probes.gather,
                     (a3.reshape(-1), index, 0), x3.reshape(shape), shape)

    sel = np.zeros((L // 2, L), np.float32)
    sel[idx_l, np.arange(L)] = 1.0
    return [
        gather_probe("P1 2D lane gather", a2, 1, idx_l, x2[:, idx_l]),
        gather_probe("P2 2D sublane gather", a2, 0, idx_s, x2[idx_s]),
        gather_probe("P3 3D sublane gather", a3, 1, idx_w, x3[:, idx_w]),
        gather_probe("P4 3D sublane repeat", a3, 1,
                     np.repeat(np.arange(W // 2), 2),
                     np.repeat(x3[:, : W // 2], 2, axis=1)),
        reshape("P5 reshape 3D->2D (fold outer+sublane)", (T * W, C)),
        reshape("P5b reshape fold sublane+lane", (T, W * C)),
        gather_probe("P6 2D sublane repeat", a2, 0,
                     np.repeat(np.arange(S // 2), 2),
                     np.repeat(x2[: S // 2], 2, axis=0)),
        gather_probe("P7 2D lane repeat", a2, 1,
                     np.repeat(np.arange(L // 2), 2),
                     np.repeat(x2[:, : L // 2], 2, axis=1)),
        gather_probe("P8 2D strided lane slice", a2, 1, np.arange(L)[0::2],
                     x2[:, 0::2]),
        Probe("P9 lane selection matmul", probes.probe_select_matmul,
              probes.select_matmul,
              (a2[:, : L // 2], torch.from_numpy(sel).to(device)),
              x2[:, : L // 2] @ sel),
        gather_probe("P10 2D lane roll", a2, 1, np.roll(np.arange(L), 1),
                     np.roll(x2, 1, axis=1)),
        gather_probe("P11 3D lane gather", a3, 2, idx_c, x3[:, :, idx_c]),
    ]


def main(device: torch.device | str = "cuda"):
    """Run P1-P11 on ``device`` (the card by default); {name: (ran, match)}."""
    return run_all(make_probes, device, "probe_mosaic")


if __name__ == "__main__":
    sys.exit(exit_code(main()))
