"""Audio spectrogram frontend (VGGVox ``runSpec``), plain PyTorch.

Port of ``mcncrossmodalemotions_tpu/ops/spectrogram.py``:

    decode -> preemphasis -> framing (400-sample window, hop 160, no
    padding) -> symmetric Hamming window -> 512-point DFT magnitude (all
    512 bins, the conjugate-symmetric half mirrored) -> [..., 512, T]
    -> per-utterance instance norm over time (N-1 std).

The plain frontend here is the frames-matmul form: the waveform is viewed
as overlapping frames (``Tensor.unfold``) and multiplied by the
Hamming-windowed cos|sin DFT matrix for the 257 non-redundant bins. A
float32 matrix product runs in full float32 on the card by default
(``torch.backends.cuda.matmul.allow_tf32`` is False), unlike a cuDNN
convolution, which allows TF32 by default. The fused kernel that replaces
the TPU's Pallas frontend lives in ``ops/spectrogram_kernel.py``; this
module is its plain version and the CPU path.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Tuple

import numpy as np
import torch

from mcncrossmodalemotions_torch.data.audio import MULAW_MU


@dataclasses.dataclass(frozen=True)
class SpecConfig:
    """Spectrogram frontend parameters (run_distillation.m:108-117).

    Restated from the JAX package, whose module imports jax; a CPU test
    holds the two equal.
    """

    sample_rate: int = 16000
    window_ms: float = 25.0
    hop_ms: float = 10.0
    preemph: float = 0.97
    nfft: int = 512

    def __post_init__(self):
        # a matrix DFT with win > nfft computes the wrapped (aliased)
        # transform where MATLAB's fft(x, nfft) truncates
        if self.win_length > self.nfft:
            raise ValueError(
                f"win_length {self.win_length} > nfft {self.nfft}: "
                "unsupported (matmul DFT would alias where MATLAB fft "
                "truncates)")

    @property
    def win_length(self) -> int:
        return int(round(self.sample_rate * self.window_ms / 1000.0))  # 400

    @property
    def hop_length(self) -> int:
        return int(round(self.sample_rate * self.hop_ms / 1000.0))  # 160

    @property
    def num_rbins(self) -> int:
        """Non-redundant rFFT bins actually computed."""
        return self.nfft // 2 + 1

    def frames_per_second(self) -> float:
        return self.sample_rate / self.hop_length  # 100

    def num_frames(self, num_samples: int) -> int:
        """Frames produced from ``num_samples`` (floor framing, no padding)."""
        if num_samples < self.win_length:
            return 0
        return (num_samples - self.win_length) // self.hop_length + 1

    def crop_samples(self, num_frames: int) -> int:
        """Samples to read for a ``num_frames``-frame crop
        (getBatchEmoVoxCeleb.m:67-68): 400 frames -> 64,384 samples."""
        aud_time = (self.hop_ms / 1000.0 * num_frames
                    + (self.window_ms - 1.0) / 1000.0)
        return int(round(aud_time * self.sample_rate))


DEFAULT_SPEC = SpecConfig()


def hamming(n: int, dtype=np.float32) -> np.ndarray:
    """Symmetric Hamming window (MATLAB ``hamming(n)`` convention)."""
    if n == 1:
        return np.ones(1, dtype)
    i = np.arange(n)
    return (0.54 - 0.46 * np.cos(2.0 * np.pi * i / (n - 1))).astype(dtype)


@functools.lru_cache(maxsize=8)
def dft_matrices_np(win_length: int, nfft: int, windowed: bool = True):
    """cos/sin DFT matrices [win_length, nfft//2+1], the Hamming window
    folded in unless ``windowed`` is False.

    Built in float64 and cast to float32 once. Cached numpy arrays are
    never written.
    """
    if win_length > nfft:
        raise ValueError(f"win_length {win_length} > nfft {nfft}")
    k = np.arange(nfft // 2 + 1)
    i = np.arange(win_length)
    angle = -2.0 * np.pi * np.outer(i, k) / nfft
    cos_m, sin_m = np.cos(angle), np.sin(angle)
    if windowed:
        w = hamming(win_length, np.float64)[:, None]
        cos_m, sin_m = cos_m * w, sin_m * w
    return cos_m.astype(np.float32), sin_m.astype(np.float32)


def dft_matrices(win_length: int, nfft: int, windowed: bool = True,
                 device: torch.device | str = "cuda"):
    """``dft_matrices_np`` as float32 tensors on ``device`` (the card by
    default), new copies at each call."""
    return tuple(torch.from_numpy(m).to(device)
                 for m in dft_matrices_np(win_length, nfft, windowed))


_device_dft: Dict[Tuple[torch.device, int, int], torch.Tensor] = {}


def dft_matrix(cfg: SpecConfig, device: torch.device) -> torch.Tensor:
    """The windowed [win_length, cos | sin] DFT matrix on ``device``,
    copied there once per device (read-only)."""
    key = (torch.device(device), cfg.win_length, cfg.nfft)
    if key not in _device_dft:
        cos_m, sin_m = dft_matrices_np(cfg.win_length, cfg.nfft)
        _device_dft[key] = torch.from_numpy(
            np.concatenate([cos_m, sin_m], axis=1)).to(device)
    return _device_dft[key]


def decode_pcm(x: torch.Tensor) -> torch.Tensor:
    """Decode the compact feed formats on the device; floats pass through.

    - int16: PCM16, dequantised with the audioread convention;
    - uint8: mu-law (mu=255) companded rows, as the JAX package's
      ``mcncrossmodalemotions_tpu/data/audio.py::pack_mulaw8`` packs them.
    """
    if x.dtype == torch.int16:
        return x.to(torch.float32) / 32768.0
    if x.dtype == torch.uint8:
        y = x.to(torch.float32) / 127.5 - 1.0
        return (torch.sign(y) * torch.expm1(y.abs() * float(np.log1p(MULAW_MU)))
                / MULAW_MU)
    return x


def preemphasis(x: torch.Tensor, alpha: float = 0.97) -> torch.Tensor:
    """MATLAB ``filter([1 -alpha], 1, x)`` along the last axis:
    y[0] = x[0]; y[n] = x[n] - alpha*x[n-1]."""
    x = decode_pcm(x)
    return torch.cat([x[..., :1], x[..., 1:] - alpha * x[..., :-1]], dim=-1)


def frame_signal(x: torch.Tensor, win_length: int,
                 hop_length: int) -> torch.Tensor:
    """[..., N] -> [..., T, win_length] frames (floor framing, no padding;
    T = 0 where N < win_length), a view of ``x``."""
    if x.shape[-1] < win_length:
        return x.new_empty((*x.shape[:-1], 0, win_length))
    return x.unfold(-1, win_length, hop_length)


def mirror_bins(half: torch.Tensor, nfft: int) -> torch.Tensor:
    """Expand rFFT magnitudes [..., nfft//2+1] to the full [..., nfft]
    (|X[k]| = |X[nfft-k]| for real input)."""
    return torch.cat([half, torch.flip(half[..., 1:nfft // 2], dims=(-1,))],
                     dim=-1)


def spectrogram_half_frames(x: torch.Tensor,
                            cfg: SpecConfig = DEFAULT_SPEC) -> torch.Tensor:
    """[..., N] waveform -> [..., T, nfft//2+1] non-redundant magnitudes."""
    y = preemphasis(x, cfg.preemph)
    lead, n = y.shape[:-1], y.shape[-1]
    if cfg.num_frames(n) == 0:
        raise ValueError(f"input too short: {n} samples -> 0 frames")
    frames = frame_signal(y.reshape(-1, n), cfg.win_length, cfg.hop_length)
    out = torch.matmul(frames, dft_matrix(cfg, y.device))  # [B, T, 2R]
    r = cfg.num_rbins
    re, im = out[..., :r], out[..., r:]
    half = torch.sqrt(re * re + im * im)
    return half.reshape(*lead, *half.shape[1:])


def spectrogram_frames(x: torch.Tensor,
                       cfg: SpecConfig = DEFAULT_SPEC) -> torch.Tensor:
    """[..., N] waveform -> [..., T, nfft] magnitude frames (time-major)."""
    return mirror_bins(spectrogram_half_frames(x, cfg), cfg.nfft)


def spectrogram(x: torch.Tensor, cfg: SpecConfig = DEFAULT_SPEC) -> torch.Tensor:
    """[..., N] waveform -> [..., F=nfft, T] spectrogram (freq-major)."""
    return spectrogram_frames(x, cfg).transpose(-1, -2).contiguous()


def instance_norm(spec: torch.Tensor, eps: float = 1e-8,
                  valid_frames=None) -> torch.Tensor:
    """Per-utterance normalisation over time, per frequency bin.

    mu = mean over time, sigma = std over time with N-1 normalisation
    (MATLAB ``std``; getBatchEmoVoxCeleb.m:164-169). ``spec`` is
    [..., F, T]. ``valid_frames`` ([...]-shaped ints) restricts the
    statistics to the first ``valid_frames`` columns and zeroes the rest.
    """
    t = spec.shape[-1]
    if valid_frames is None:
        mu = spec.mean(dim=-1, keepdim=True)
        var = ((spec - mu) ** 2).sum(dim=-1, keepdim=True) / max(t - 1, 1)
        return (spec - mu) / torch.sqrt(var + eps)
    vf = torch.as_tensor(valid_frames, device=spec.device)
    mask = (torch.arange(t, device=spec.device)[None, :] < vf.reshape(-1, 1))
    mask = mask.reshape(*vf.shape, 1, t).to(spec.dtype)
    denom = vf.to(spec.dtype).clamp(min=1.0).reshape(*vf.shape, 1, 1)
    mu = (spec * mask).sum(dim=-1, keepdim=True) / denom
    var = (((spec - mu) * mask) ** 2).sum(dim=-1, keepdim=True) / (
        (denom - 1.0).clamp(min=1.0))
    return torch.where(mask > 0, (spec - mu) / torch.sqrt(var + eps),
                       torch.zeros((), dtype=spec.dtype, device=spec.device))


def waveform_to_input(x: torch.Tensor, cfg: SpecConfig = DEFAULT_SPEC,
                      valid_frames=None, use_kernel: bool = True) -> torch.Tensor:
    """Full frontend: [B, N] waveform -> [B, F, T, 1] normalised input.

    With ``use_kernel`` framing+DFT go through ``spectrogram_cuda``, which
    launches the fused kernel for a CUDA tensor and runs this module's
    plain path for a CPU tensor; False runs the plain path everywhere.
    """
    # imported here: spectrogram_kernel imports this module
    from mcncrossmodalemotions_torch.ops.spectrogram_kernel import (
        spectrogram_cuda,
    )

    spec = spectrogram_cuda(x, cfg) if use_kernel else spectrogram(x, cfg)
    return instance_norm(spec, valid_frames=valid_frames)[..., None]
