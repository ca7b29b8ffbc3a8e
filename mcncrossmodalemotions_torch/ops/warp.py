"""Align-corners separable bilinear resize, PyTorch.

Port of ``resize_separable`` (``mcncrossmodalemotions_tpu/ops/warp.py:142``):
the resize the teacher pipeline applies when frames are not already the
network's input size, as two fp32 matmuls with interpolation matrices (the
JAX function runs them at HIGHEST precision; here they are fp32 matmuls,
TF32 off by PyTorch's default). The convention is the framework's
align-corners one: the host resize of ``data/images.py`` and the C++
decoder agree with it. The affine warp and the host augmentation of the JAX
module are training work and not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch


def _weights(n_in: int, n_out: int) -> np.ndarray:
    """[n_in, n_out] align-corners interpolation matrix."""
    if n_in == 1:  # replication: all conventions agree
        return np.ones((1, n_out), np.float32)
    if n_out == 1:  # one output samples index 0, not the axis mean
        mat = np.zeros((n_in, 1), np.float32)
        mat[0, 0] = 1.0
        return mat
    pos = np.arange(n_out) * (n_in - 1) / (n_out - 1)
    lo = np.clip(np.floor(pos).astype(int), 0, n_in - 1)
    hi = np.minimum(lo + 1, n_in - 1)
    frac = pos - lo
    mat = np.zeros((n_in, n_out), np.float32)
    mat[lo, np.arange(n_out)] += 1.0 - frac
    mat[hi, np.arange(n_out)] += frac
    return mat


def resize_separable(images: torch.Tensor, out_height: int,
                     out_width: int) -> torch.Tensor:
    """[B, H, W, C] -> [B, H', W', C] float32, align-corners bilinear; the
    input itself when the size already matches."""
    b, h, w, c = images.shape
    if (h, w) == (out_height, out_width):
        return images
    dev = images.device
    wy = torch.from_numpy(_weights(h, out_height)).to(dev)
    wx = torch.from_numpy(_weights(w, out_width)).to(dev)
    out = torch.einsum("bhwc,hH->bHwc", images.float(), wy)
    return torch.einsum("bHwc,wW->bHWc", out, wx)
