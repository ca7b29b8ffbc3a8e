"""K1: the fused spectrogram kernel (``csrc/spectrogram.cu``) and its wrapper.

Replaces the TPU kernel ``mcncrossmodalemotions_tpu/ops/pallas_spectrogram.py``
(``spectrogram_pallas``): pre-emphasis, 400-sample Hamming framing at hop
160 and the 512-point DFT magnitude in one pass, without a frames tensor
in device memory. The kernel computes the DFT as a real FFT (a 256-point
complex FFT and a post-processing pass) from the tables ``fft_tables_np``
builds; its plain version is ``ops.spectrogram.spectrogram`` (frames view
times the windowed DFT matrices, full fp32). The source note in
``csrc/spectrogram.cu`` says what bounds the kernel on the card and how
its design answers that.

``spectrogram_cuda`` runs the plain version for a CPU tensor and launches
the kernel for a CUDA tensor; it never falls back from the card.
"""

from __future__ import annotations

import functools
from typing import Dict, Tuple

import numpy as np
import torch

from mcncrossmodalemotions_torch.ops import _ffi
from mcncrossmodalemotions_torch.ops._ffi import FLOAT, INT, VOIDP
from mcncrossmodalemotions_torch.ops.spectrogram import (
    DEFAULT_SPEC,
    SpecConfig,
    decode_pcm,
    hamming,
    spectrogram,
)

KERNEL_NFFT = 512  # the kernel's FFT: 256 = 16 x 16 complex points
_ENTRY = {torch.float32: "spectrogram_f32", torch.int16: "spectrogram_i16"}
LIB = _ffi.Library("spectrogram", dict.fromkeys(
    _ENTRY.values(), (INT, [VOIDP] * 5 + [INT] * 6 + [FLOAT, VOIDP])))


@functools.lru_cache(maxsize=8)
def fft_tables_np(win_length: int, nfft: int):
    """The kernel's tables, built in float64 and cast to float32 once:

    - ``window`` [win_length]: the symmetric Hamming window;
    - ``twiddles`` [nfft/2, 2]: W^m = exp(-2 pi j m / (nfft/2)) as (re, im),
      the nfft/2-point complex FFT's twiddles;
    - ``post`` [nfft/4 + 1, 2]: exp(-2 pi j k / nfft), k <= nfft/4, the
      post-processing twiddles that turn that FFT into the real nfft-point
      one (the kernel takes bins k and nfft/2 - k together).

    Cached numpy arrays are never written.
    """
    half = nfft // 2

    def pairs(angle):
        return np.stack([np.cos(angle), np.sin(angle)], axis=-1).astype(np.float32)

    return (hamming(win_length, np.float64).astype(np.float32),
            pairs(-2.0 * np.pi * np.arange(half) / half),
            pairs(-2.0 * np.pi * np.arange(half // 2 + 1) / nfft))


_device_tables: Dict[Tuple[torch.device, int, int], Tuple[torch.Tensor, ...]] = {}


def fft_tables(cfg: SpecConfig, device: torch.device) -> Tuple[torch.Tensor, ...]:
    """``fft_tables_np`` on ``device``, copied there once per device."""
    key = (torch.device(device), cfg.win_length, cfg.nfft)
    if key not in _device_tables:
        _device_tables[key] = tuple(
            torch.from_numpy(t).to(device)
            for t in fft_tables_np(cfg.win_length, cfg.nfft))
    return _device_tables[key]


@_ffi.counted("spectrogram")
def spectrogram_cuda(x: torch.Tensor, cfg: SpecConfig = DEFAULT_SPEC) -> torch.Tensor:
    """[B, N] waveform (float32, int16 PCM or uint8 mu-law) -> [B, nfft, T]
    float32 magnitude spectrogram.

    A CPU tensor goes through the plain version. A CUDA tensor goes
    through the kernel, which fuses the pre-emphasis into its load and
    reads float32 and int16 rows as they are (int16 scaled by 2^-15,
    bitwise ``decode_pcm``); mu-law rows are decoded (``decode_pcm``)
    first. Each launch adds one to ``spectrogram_cuda.launches``.
    """
    if _ffi.on_cpu("spectrogram_cuda", x):
        return spectrogram(x, cfg)
    if x.dim() != 2:
        raise ValueError(f"spectrogram_cuda expects [B, N], got {tuple(x.shape)}")
    if x.dtype == torch.uint8:
        x = decode_pcm(x)
    _ffi.check_dtype("spectrogram_cuda", x, _ENTRY)
    if cfg.nfft != KERNEL_NFFT:
        raise ValueError(f"spectrogram_cuda: the kernel's FFT has "
                         f"{KERNEL_NFFT} points, not {cfg.nfft}")
    x = x.contiguous()
    bsz, n = x.shape
    t = cfg.num_frames(n)
    if t == 0:
        raise ValueError(f"input too short: {n} samples -> 0 frames")
    window, twiddles, post = fft_tables(cfg, x.device)
    out = torch.empty((bsz, cfg.nfft, t), dtype=torch.float32, device=x.device)
    LIB.launch(_ENTRY[x.dtype], spectrogram_cuda, x, (
        x.data_ptr(), window.data_ptr(), twiddles.data_ptr(), post.data_ptr(),
        out.data_ptr(), bsz, n, t, cfg.win_length, cfg.hop_length, cfg.nfft,
        cfg.preemph))
    return out
