"""Host-side audio I/O: wav header parsing, segment reads, PCM16 and mu-law
packing, resampling and speed perturbation.

The port's copy of what it calls from
``mcncrossmodalemotions_tpu/data/audio.py`` (MATLAB ``audioread`` /
``audioinfo`` / ``audiowrite`` / ``resample`` semantics,
getBatchEmoVoxCeleb.m:79,97-118), so that both packages read and write the
same bytes (``tests/test_torch_host_copies.py`` holds them equal).
"""

from __future__ import annotations

import dataclasses
import struct
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

MULAW_MU = 255.0
"""mu of the mu-law feed (``pack_mulaw8``; ``ops.spectrogram.decode_pcm``
decodes it)."""


@dataclasses.dataclass(frozen=True)
class WavInfo:
    """audioinfo equivalent."""

    num_samples: int
    sample_rate: int
    num_channels: int
    bits_per_sample: int
    data_offset: int  # byte offset of PCM payload
    audio_format: int  # 1 = PCM int, 3 = IEEE float

    @property
    def duration(self) -> float:
        return self.num_samples / self.sample_rate


def wav_info(path: str | Path) -> WavInfo:
    """Parse RIFF/WAVE headers only (no payload decode)."""
    with open(path, "rb") as f:
        riff = f.read(12)
        if riff[:4] != b"RIFF" or riff[8:12] != b"WAVE":
            raise ValueError(f"{path}: not a RIFF/WAVE file")
        fmt = None
        while True:
            header = f.read(8)
            if len(header) < 8:
                raise ValueError(f"{path}: missing data chunk")
            chunk_id, size = header[:4], struct.unpack("<I", header[4:])[0]
            if chunk_id == b"fmt ":
                fmt = f.read(size)
                if size % 2:
                    f.read(1)
            elif chunk_id == b"data":
                if fmt is None:
                    raise ValueError(f"{path}: data before fmt")
                audio_format, channels, rate = struct.unpack("<HHI", fmt[:8])
                bits = struct.unpack("<H", fmt[14:16])[0]
                return WavInfo(
                    num_samples=size // (channels * bits // 8),
                    sample_rate=rate,
                    num_channels=channels,
                    bits_per_sample=bits,
                    data_offset=f.tell(),
                    audio_format=audio_format,
                )
            else:
                f.seek(size + (size % 2), 1)


def read_wav(path: str | Path, start: int = 0,
             num_samples: Optional[int] = None) -> Tuple[np.ndarray, int]:
    """audioread equivalent with [start, start+n) segment access.

    Returns (float32 mono samples in [-1, 1], sample_rate); seeks straight
    to the requested frames (getBatchEmoVoxCeleb.m:97-100). Stereo files
    give their LEFT stream (compute_audio_feats.m:176 ``z = z(:,1)``).
    """
    info = wav_info(path)
    if num_samples is None:
        num_samples = info.num_samples - start
    num_samples = max(0, min(num_samples, info.num_samples - start))
    frame_bytes = info.bits_per_sample // 8 * info.num_channels
    with open(path, "rb") as f:
        f.seek(info.data_offset + start * frame_bytes)
        raw = f.read(num_samples * frame_bytes)
    if info.audio_format == 3 and info.bits_per_sample == 32:
        data = np.frombuffer(raw, "<f4").astype(np.float32)
    elif info.bits_per_sample == 16:
        data = np.frombuffer(raw, "<i2").astype(np.float32) / 32768.0
    elif info.bits_per_sample == 32:
        data = np.frombuffer(raw, "<i4").astype(np.float32) / 2147483648.0
    elif info.bits_per_sample == 8:
        data = (np.frombuffer(raw, "u1").astype(np.float32) - 128.0) / 128.0
    else:
        raise ValueError(f"unsupported bit depth {info.bits_per_sample}")
    if info.num_channels > 1:
        data = np.ascontiguousarray(
            data.reshape(-1, info.num_channels)[:, 0])
    return data, info.sample_rate


def float_to_pcm16(samples: np.ndarray) -> np.ndarray:
    """MATLAB audiowrite convention: scale by 32768, clip to int16 range;
    audioread divides by 32768, so the round-trip is pure quantisation."""
    samples = np.asarray(samples, np.float32)
    return np.clip(np.round(samples * 32768.0), -32768, 32767).astype(np.int16)


def pack_pcm16(waves: np.ndarray) -> np.ndarray:
    """[B, N] float waveforms -> int16 device feed (half the bytes).

    Rows are peak-normalised DOWN only (divisor >= 1), so augmented or
    resampled rows beyond [-1, 1] are not flat-topped. The scale is
    neutral downstream: the spectrogram is linear in the waveform and the
    per-bin instance norm divides any per-row scale back out.
    """
    peak = np.maximum(np.abs(waves).max(axis=1, keepdims=True), 1.0)
    return float_to_pcm16(waves / peak)


_MULAW_LUT: Optional[np.ndarray] = None


def _mulaw_encode_float(x: np.ndarray) -> np.ndarray:
    """The companding formula (mu = 255): float in [-1, 1] -> uint8."""
    y = np.sign(x) * np.log1p(MULAW_MU * np.abs(x)) / np.log1p(MULAW_MU)
    return np.clip(np.round((y + 1.0) * 127.5), 0, 255).astype(np.uint8)


def _mulaw_lut() -> np.ndarray:
    """int16 -> mu-law table indexed by the uint16 view (two's complement
    order), built once."""
    global _MULAW_LUT
    if _MULAW_LUT is None:
        idx = np.arange(65536)
        pcm = np.where(idx < 32768, idx, idx - 65536).astype(np.float32)
        _MULAW_LUT = _mulaw_encode_float(pcm / 32768.0)
    return _MULAW_LUT


def pack_mulaw8(waves: np.ndarray) -> np.ndarray:
    """[B, N] float waveforms -> uint8 mu-law device feed (half the int16
    feed's bytes, ~38 dB SNR on speech).

    The rows are peak-normalised down only and quantised to PCM16 as
    ``pack_pcm16`` does, then mapped through the 64K lin -> mu-law table;
    ``ops.spectrogram.decode_pcm`` decodes uint8 as mu-law on the device.
    The quantisation noise floor fills spectrally empty bins, which the
    frontend's per-bin instance norm then lifts to unit variance: for
    broadband signals (speech) only.
    """
    return _mulaw_lut()[pack_pcm16(waves).view(np.uint16)]


def write_wav(path: str | Path, samples: np.ndarray, sample_rate: int) -> None:
    """PCM16 mono wav writer (synthetic fixtures)."""
    payload = float_to_pcm16(samples).astype("<i2").tobytes()
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "wb") as f:
        f.write(b"RIFF")
        f.write(struct.pack("<I", 36 + len(payload)))
        f.write(b"WAVEfmt ")
        f.write(struct.pack("<IHHIIHH", 16, 1, 1, sample_rate,
                            sample_rate * 2, 2, 16))
        f.write(b"data")
        f.write(struct.pack("<I", len(payload)))
        f.write(payload)


def resample_poly(x: np.ndarray, up: int, down: int) -> np.ndarray:
    """Rational polyphase resample (MATLAB ``resample(x, p, q)``)."""
    from scipy.signal import resample_poly as _rp

    return _rp(x, up, down).astype(np.float32)


def resample_to(x: np.ndarray, from_fs: int, to_fs: int) -> np.ndarray:
    """Rational polyphase resample between sample rates (MATLAB
    ``resample(x, p, q)``); a no-op when they are equal."""
    if from_fs == to_fs:
        return x
    from fractions import Fraction

    frac = Fraction(to_fs, from_fs).limit_denominator(1000)
    return resample_poly(x, frac.numerator, frac.denominator)


def speed_perturb(x: np.ndarray, factor: float,
                  max_denominator: int = 100) -> np.ndarray:
    """Speed perturbation by rational resampling (getBatchEmoVoxCeleb.m:
    102-108): playing at ``factor`` speed resamples by 1 / factor, so the
    length becomes N / factor."""
    from fractions import Fraction

    frac = Fraction(factor).limit_denominator(max_denominator)
    return resample_poly(x, frac.denominator, frac.numerator)
