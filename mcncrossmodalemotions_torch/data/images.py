"""Host-side face-frame loading (the ``vl_imreadjpeg`` path).

The port's copy of ``mcncrossmodalemotions_tpu/data/images.py``: JPEG decode
-> centered square crop -> align-corners bilinear resize -> ITU-R 601 gray
(fetch_emovoxceleb_imdb.m getImageBatch :152-193,
compute_visual_feats.m:123-164). Crop semantics follow ``vl_imreadjpeg``:
``CropSize`` is a fraction of the largest crop with the output's (square)
aspect, so a centered square of side ``crop_ratio * min(h, w)``; the
EmoVoxCeleb dense build uses 1/1.6 (fetch_emovoxceleb_imdb.m:169), the
external extractor 1.0.

``load_frame_batch`` reads through the port's own decoder library
(``data/native_faces.py``, ``csrc/dataservice_faces.cc``), which needs no
libjpeg and no PIL. Only while ``MCNCME_DISABLE_NATIVE`` is set does it read
through PIL (``load_face_frame``, imported there and nowhere else), within
one gray level of the library (``tests/test_torch_faces.py``).
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Sequence

import numpy as np

CROP_RATIO = 1.0 / 1.6  # fetch_emovoxceleb_imdb.m:169 CropSize


def resize_bilinear_np(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """Align-corners bilinear resize in float64 (the convention of the C++
    decoder and of ``ops.warp.resize_separable``)."""
    h, w = img.shape[:2]
    fy = (np.arange(out_h) * ((h - 1) / (out_h - 1) if out_h > 1 else 0.0))
    fx = (np.arange(out_w) * ((w - 1) / (out_w - 1) if out_w > 1 else 0.0))
    y0 = np.clip(np.floor(fy).astype(int), 0, h - 1)
    x0 = np.clip(np.floor(fx).astype(int), 0, w - 1)
    y1 = np.minimum(y0 + 1, h - 1)
    x1 = np.minimum(x0 + 1, w - 1)
    wy = (fy - y0)[:, None, None]
    wx = (fx - x0)[None, :, None]
    img = img.astype(np.float64)
    top = img[y0][:, x0] * (1 - wx) + img[y0][:, x1] * wx
    bot = img[y1][:, x0] * (1 - wx) + img[y1][:, x1] * wx
    return top * (1 - wy) + bot * wy


def load_face_frame(path: str | Path, out_size: int = 224,
                    crop_ratio: float = CROP_RATIO) -> np.ndarray:
    """Decode (PIL) + center-crop + bilinear resize + gray -> [S, S, 1]
    uint8: the Python reads behind ``MCNCME_DISABLE_NATIVE``."""
    from PIL import Image

    with Image.open(path) as img:
        img = img.convert("RGB")
        w, h = img.size
        side = max(1, int(round(crop_ratio * min(w, h))))
        left = (w - side) // 2
        top = (h - side) // 2
        img = img.crop((left, top, left + side, top + side))
        rgb = np.asarray(img, np.float64)
    resized = resize_bilinear_np(rgb, out_size, out_size)
    gray = resized @ np.asarray([0.2989, 0.5870, 0.1140])  # MATLAB rgb2gray
    return np.clip(np.round(gray), 0, 255).astype(np.uint8)[..., None]


def load_frame_batch(paths: Sequence[str | Path], out_size: int = 224,
                     num_threads: int = 8,
                     crop_ratio: float = CROP_RATIO) -> np.ndarray:
    """Threaded batch decode -> [count, S, S, 1] uint8 (the vl_imreadjpeg
    NumThreads analogue), through the port's decoder library; a failed
    build or decode raises. PIL reads it only with
    ``MCNCME_DISABLE_NATIVE`` set."""
    if not os.environ.get("MCNCME_DISABLE_NATIVE"):
        from mcncrossmodalemotions_torch.data import native_faces

        return native_faces.decode_faces([str(p) for p in paths], out_size,
                                         crop_ratio, num_threads)
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=num_threads) as pool:
        frames = list(pool.map(
            lambda p: load_face_frame(p, out_size, crop_ratio), paths))
    return np.stack(frames)


def save_synthetic_frame(path: str | Path, pattern_id: int, size: int = 64,
                         seed: int = 0) -> None:
    """Write a synthetic face-frame JPEG whose content encodes
    ``pattern_id`` (PIL; for the tests' frame trees)."""
    from PIL import Image

    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    base = 127 + 120 * np.sin(2 * np.pi * (pattern_id + 1) * (xx + yy) / (4 * size))
    img = np.clip(base + rng.randn(size, size) * 8, 0, 255).astype(np.uint8)
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    Image.fromarray(img).convert("RGB").save(path, quality=92)
