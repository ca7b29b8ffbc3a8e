"""K1: the fused spectrogram kernel (``csrc/spectrogram.cu``) and its wrapper.

Replaces the TPU kernel ``mcncrossmodalemotions_tpu/ops/pallas_spectrogram.py``
(``spectrogram_pallas``): pre-emphasis, 400-sample Hamming framing at hop
160 and the 512-point DFT magnitude in one pass, without a frames tensor
in device memory. Its plain version is ``ops.spectrogram.spectrogram``
(frames view times the same windowed DFT matrices, full fp32). The source
note in ``csrc/spectrogram.cu`` says what bounds the kernel on the card
and how its tiling answers that.

``spectrogram_cuda`` runs the plain version for a CPU tensor and launches
the kernel for a CUDA tensor; it never falls back from the card.
"""

from __future__ import annotations

import ctypes

import torch

from mcncrossmodalemotions_torch.ops import _build
from mcncrossmodalemotions_torch.ops.spectrogram import (
    DEFAULT_SPEC,
    SpecConfig,
    decode_pcm,
    dft_matrix,
    spectrogram,
)


def _lib() -> ctypes.CDLL:
    lib = _build.load("spectrogram")
    fn = lib.spectrogram_f32
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                       + [ctypes.c_float, ctypes.c_void_p])
    return lib


def spectrogram_cuda(x: torch.Tensor, cfg: SpecConfig = DEFAULT_SPEC) -> torch.Tensor:
    """[B, N] waveform (float32, int16 PCM or uint8 mu-law) -> [B, nfft, T]
    float32 magnitude spectrogram.

    A CPU tensor goes through the plain version. A CUDA tensor is decoded
    (``decode_pcm``) and goes through the kernel, which fuses the
    pre-emphasis into its load; each launch adds one to
    ``spectrogram_cuda.launches``.
    """
    if x.device.type == "cpu":
        return spectrogram(x, cfg)
    if x.device.type != "cuda":
        raise ValueError(f"spectrogram_cuda: unsupported device {x.device}")
    if x.dim() != 2:
        raise ValueError(f"spectrogram_cuda expects [B, N], got {tuple(x.shape)}")
    x = decode_pcm(x)
    if x.dtype != torch.float32:
        raise TypeError(f"spectrogram_cuda: unsupported dtype {x.dtype}")
    x = x.contiguous()
    bsz, n = x.shape
    t = cfg.num_frames(n)
    if t == 0:
        raise ValueError(f"input too short: {n} samples -> 0 frames")
    mat = dft_matrix(cfg, x.device)  # [win, cos | sin]
    sin_m = mat[:, cfg.num_rbins:]
    out = torch.empty((bsz, cfg.nfft, t), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = _lib().spectrogram_f32(
            x.data_ptr(), mat.data_ptr(), sin_m.data_ptr(), out.data_ptr(),
            bsz, n, t, cfg.win_length, cfg.hop_length, cfg.nfft, mat.stride(0),
            cfg.preemph, torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"spectrogram kernel launch failed: CUDA error {err} "
                           f"(B={bsz}, N={n}, T={t})")
    spectrogram_cuda.launches += 1
    return out


spectrogram_cuda.launches = 0
