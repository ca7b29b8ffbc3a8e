"""What a baseline JPEG decoder gives for the benchmark's face frames, and
the face crop the dense pass takes, worked out from the frames' pixels.

The file holds the Y plane's quantised DCT coefficients and flat chroma
(Cb = Cr = 128, so R = G = B = Y). Decoding dequantises them, takes the
inverse DCT (float64 here), adds 128 and rounds into 0..255. The face
crop is a centred square of side round(ratio x min(h, w)); gray is
0.2989 R + 0.587 G + 0.114 B; the resize to the output side is
align-corners bilinear; the result rounds into uint8."""

from __future__ import annotations

import numpy as np

from perfbench.traffic import jpeg


def decoded_luma(pixels: np.ndarray) -> np.ndarray:
    """[H, W] uint8 -> the Y plane a decoder reconstructs, float64."""
    h, w = pixels.shape
    zz, q, (ph, pw) = jpeg.quantised_luma(pixels)
    coef = np.empty_like(zz, dtype=np.float64)
    coef[:, jpeg.ZIGZAG] = zz  # back to natural order
    blocks = coef.reshape(-1, 8, 8) * q.reshape(8, 8)
    spatial = jpeg.DCT.T @ blocks @ jpeg.DCT + 128.0
    img = spatial.reshape(ph // 8, pw // 8, 8, 8).transpose(0, 2, 1, 3).reshape(ph, pw)
    return np.clip(np.round(img), 0, 255)[:h, :w]


def face_frame(pixels: np.ndarray, out_size: int, crop_ratio: float) -> np.ndarray:
    """[H, W] uint8 source -> [S, S, 1] uint8 face frame."""
    y = decoded_luma(pixels)
    h, w = y.shape
    side = max(1, int(round(crop_ratio * min(w, h))))
    top, left = (h - side) // 2, (w - side) // 2
    gray = y[top:top + side, left:left + side] * (0.2989 + 0.5870 + 0.1140)
    f = np.arange(out_size) * ((side - 1) / (out_size - 1))
    i0 = np.clip(np.floor(f).astype(int), 0, side - 1)
    i1 = np.minimum(i0 + 1, side - 1)
    wt = f - i0
    rows = gray[i0] * (1 - wt)[:, None] + gray[i1] * wt[:, None]
    out = rows[:, i0] * (1 - wt)[None, :] + rows[:, i1] * wt[None, :]
    return np.clip(np.round(out), 0, 255).astype(np.uint8)[..., None]
