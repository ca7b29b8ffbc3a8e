"""EmoVoxCeleb student batches (``getBatchEmoVoxCeleb`` equivalent), jax-free.

Restates the default train/val feed path of
``mcncrossmodalemotions_tpu/data/emovox.py``, whose module imports
``ops.spectrogram`` and so jax. The batches are bitwise equal to the JAX
batcher's Python path (``tests/test_torch_emovox.py``):

- random ``num_seconds`` crop in train, start-anchored in val (the
  reference's 'vI' transform, :21-26); clips capped at 19.9 s, short clips
  zero-padded;
- crop time -> teacher-logit frame indices (fps 25, stride 6), logits
  aggregated over the crop window by max or mean and truncated to
  ``num_pred_emotions``; loss-specific targets;
- per-(seed, epoch, stream) SeedSequence RNGs for the shuffle and the crop
  draws;
- int16 PCM rows (``emit_int16``, the default) or float32 rows.

Not ported, and refused with ``NotImplementedError`` rather than ignored:
speed and noise augmentation, fixedSegments (``time_offsets``), face
frames, the mu-law feed and the native C++ reader (the JAX batcher takes
it where it loads; its rows are bit-identical to the Python path's).
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Dict, Iterator, Optional

import numpy as np

from mcncrossmodalemotions_torch import EMOTIONS
from mcncrossmodalemotions_torch.data.audio import (
    pack_pcm16,
    read_wav,
    resample_to,
    wav_info,
    write_wav,
)
from mcncrossmodalemotions_torch.data.imdb import (
    SET_HEARD_VAL,
    SET_TRAIN,
    SET_UNHEARD_VAL,
    EmoVoxImdb,
)
from mcncrossmodalemotions_torch.ops.spectrogram import DEFAULT_SPEC, SpecConfig

# Restated from the JAX package's data/emovox.py; a CPU test holds them
# equal.
MAX_CLIP_SECONDS = 19.9  # getBatchEmoVoxCeleb.m:84-88
LOGIT_FPS = 25.0  # video frame rate (time2idx, :210-214)
LOGIT_STRIDE = 6  # teacher logits every 6th frame


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to the PyTorch package yet; the JAX package "
        "(mcncrossmodalemotions_tpu.data.emovox) has it")


@dataclasses.dataclass(frozen=True)
class BatchConfig:
    """Batch-loader options (run_distillation.m:71-89 defaults); the
    fields of the JAX ``BatchConfig``. The augmentation, frame and mu-law
    options raise unless left at their defaults."""

    num_seconds: float = 4.0
    batch_size: int = 64
    loss_type: str = "hot-cross-ent"
    logit_aggregator: str = "max"  # 'max' | 'mean'
    num_pred_emotions: int = 8
    speed_aug: bool = False
    noise_aug: bool = False
    noise: Optional[object] = None
    frames_per_crop: int = 0
    frame_size: int = 224
    emit_int16: bool = True    # ship PCM16 crops (half the feed bytes)
    emit_mulaw: bool = False
    spec: SpecConfig = DEFAULT_SPEC

    def __post_init__(self):
        if self.speed_aug:
            raise _not_ported("speed augmentation (speed_aug)")
        if self.noise_aug or self.noise is not None:
            raise _not_ported("noise augmentation (noise_aug / noise)")
        if self.frames_per_crop > 0:
            raise _not_ported("face frames (frames_per_crop)")
        if self.emit_mulaw:
            raise _not_ported("the mu-law feed (emit_mulaw)")

    @property
    def num_frames(self) -> int:
        return int(round(self.num_seconds * self.spec.frames_per_second()))

    @property
    def crop_samples(self) -> int:
        return self.spec.crop_samples(self.num_frames)  # 64,384 for 4 s


def time_to_logit_idx(t_seconds: float, num_logits: int) -> int:
    """Time offset -> teacher-logit frame index: the time2idx arithmetic
    (getBatchEmoVoxCeleb.m:210-214), ``floor(max(t*fps - 1, 0)/stride)``
    zero-based, clipped to the track's logits."""
    idx = int(np.floor(max(t_seconds * LOGIT_FPS - 1.0, 0.0) / LOGIT_STRIDE))
    return int(np.clip(idx, 0, max(num_logits - 1, 0)))


def aggregate_logits(wav_logits: np.ndarray, t0: float, t1: float,
                     aggregator: str = "max") -> np.ndarray:
    """Aggregate per-frame teacher logits over the crop window [t0, t1]."""
    f = len(wav_logits)
    i0 = time_to_logit_idx(t0, f)
    i1 = max(time_to_logit_idx(t1, f) + 1, i0 + 1)
    window = wav_logits[i0:i1]
    if aggregator == "max":
        return window.max(axis=0)
    if aggregator == "mean":
        return window.mean(axis=0)
    raise ValueError(f"unknown aggregator {aggregator!r}")


def _stream_rng(seed: int, epoch: int, stream: str) -> np.random.RandomState:
    """Independent per-(seed, epoch, stream) RandomState from a
    SeedSequence, so the shuffle and crop streams never collide; negative
    seeds map into the unsigned 64-bit range."""
    if seed < 0:
        seed &= 0xFFFFFFFFFFFFFFFF
    ss = np.random.SeedSequence(
        [seed, epoch, int.from_bytes(stream.encode(), "little")])
    return np.random.RandomState(ss.generate_state(4))


def target_logit_window(wav_logits: np.ndarray, t0: float,
                        cfg: BatchConfig) -> np.ndarray:
    """Teacher-logit aggregation over the crop [t0, t0 + num_seconds]."""
    return aggregate_logits(wav_logits, t0, t0 + cfg.num_seconds,
                            cfg.logit_aggregator)


def load_crop(wav_path: str | Path, cfg: BatchConfig,
              rng: Optional[np.random.RandomState] = None):
    """Read one crop; returns (samples[crop_samples], t0_seconds, duration).

    Start-anchored when ``rng`` is None (val), a random start otherwise;
    crop arithmetic in native-rate samples, off-rate files resampled.
    """
    info = wav_info(wav_path)
    fs = cfg.spec.sample_rate
    native_fs = info.sample_rate
    total = min(info.num_samples, int(MAX_CLIP_SECONDS * native_fs))
    need = cfg.crop_samples
    need_native = int(np.ceil(need * (native_fs / fs)))
    max_start = max(total - need_native, 0)
    start = (int(rng.randint(0, max_start + 1))
             if (rng is not None and max_start > 0) else 0)
    samples, got_fs = read_wav(wav_path, start, min(need_native, total - start))
    if got_fs != fs:
        samples = resample_to(samples, got_fs, fs)
    if len(samples) < need:  # zero-pad short clips (:115-119)
        samples = np.pad(samples, (0, need - len(samples)))
    samples = samples[:need]
    return samples.astype(np.float32), start / native_fs, info.duration


def make_targets(logit_window: np.ndarray,
                 cfg: BatchConfig) -> Dict[str, np.ndarray]:
    """Loss-specific target dict for one sample (:28-44)."""
    logits = logit_window[: cfg.num_pred_emotions].astype(np.float32)
    out = {"max_label": np.int32(int(np.argmax(logits)))}
    if cfg.loss_type in ("hot-cross-ent", "euclidean", "huber"):
        out["logit_target"] = logits
    if cfg.loss_type in ("euclidean", "huber"):
        out["instance_weights"] = np.ones_like(logits)
    return out


class EmoVoxBatcher:
    """Batched iterator over an EmoVoxImdb subset: shuffled random crops
    from per-epoch seeded RNGs in train, in-order start-anchored crops in
    val."""

    def __init__(self, imdb: EmoVoxImdb, cfg: BatchConfig, train: bool = True,
                 seed: int = 0, time_offsets=None):
        if time_offsets is not None:
            raise _not_ported("fixedSegments (time_offsets)")
        self.imdb = imdb
        self.cfg = cfg
        self.train = train
        self.seed = seed

    def epoch_indices(self, epoch: int,
                      epoch_size: Optional[int] = None) -> np.ndarray:
        """Shuffled (train) or in-order (val) indices; ``epoch_size``
        subsamples (the mini-epoch mechanism, run_distillation.m:154)."""
        n = self.imdb.num_tracks
        if self.train:
            idx = _stream_rng(self.seed, epoch, "shuffle").permutation(n)
        else:
            idx = np.arange(n)
        if epoch_size is not None:
            idx = idx[:epoch_size]
        return idx

    def batches(self, epoch: int = 1, epoch_size: Optional[int] = None,
                drop_remainder: bool = False) -> Iterator[Dict[str, np.ndarray]]:
        idx = self.epoch_indices(epoch, epoch_size)
        rng = _stream_rng(self.seed, epoch, "augment") if self.train else None
        wav_root = Path(self.imdb.wav_dir)
        for i in range(0, len(idx), self.cfg.batch_size):
            chunk = idx[i:i + self.cfg.batch_size]
            if drop_remainder and len(chunk) < self.cfg.batch_size:
                break
            yield self._python_batch(chunk, rng, wav_root)

    def _python_batch(self, chunk, rng, wav_root: Path) -> Dict[str, np.ndarray]:
        waves, targets = [], []
        for j in chunk:
            samples, t0, _ = load_crop(str(wav_root / self.imdb.wav_paths[j]),
                                       self.cfg, rng=rng)
            window = target_logit_window(self.imdb.wav_logits[j], t0, self.cfg)
            waves.append(samples)
            targets.append(make_targets(window, self.cfg))
        batch = {"data": self._pack_waves(np.stack(waves))}
        for key in targets[0]:
            batch[key] = np.stack([t[key] for t in targets])
        return batch

    def _pack_waves(self, waves: np.ndarray) -> np.ndarray:
        return pack_pcm16(waves) if self.cfg.emit_int16 else waves


def build_synthetic_imdb(root: str | Path, num_speakers: int = 4,
                         tracks_per_speaker: int = 6, seed: int = 0,
                         num_emotions: int = 8,
                         duration_range=(4.2, 8.0),
                         sample_rate: int = 16000,
                         with_frames: bool = False,
                         logit_gap: float = 8.0) -> EmoVoxImdb:
    """Synthetic mini EmoVoxCeleb: wav files + correlated fake teacher
    logits, the same files and logits as the JAX ``build_synthetic_imdb``.

    Each track's dominant "emotion" sets its tone (200 + 150 * emotion Hz)
    and the rate of a slow amplitude envelope (which survives the
    frontend's per-bin instance norm), and bumps that class's teacher
    logits by ``logit_gap``, so distillation on it is learnable. Speakers
    0..n-2 are train with their last track heardVal; the last speaker is
    unheardVal.
    """
    if with_frames:
        raise _not_ported("face frames (with_frames)")
    root = Path(root)
    rng = np.random.RandomState(seed)
    wav_paths, speakers, sets, all_logits = [], [], [], []
    for s in range(num_speakers):
        for t in range(tracks_per_speaker):
            duration = float(rng.uniform(*duration_range))
            n = int(duration * sample_rate)
            emotion = int(rng.randint(0, num_emotions))
            freq = 200.0 + 150.0 * emotion
            rate = 0.8 + 0.35 * emotion
            tt = np.arange(n) / sample_rate
            envelope = 0.3 + 0.7 * (0.5 + 0.5 * np.sin(2 * np.pi * rate * tt))
            wave = (0.5 * np.sin(2 * np.pi * freq * tt) * envelope
                    + 0.05 * rng.randn(n)).astype(np.float32)
            rel = f"spk{s:03d}/track{t:03d}.wav"
            write_wav(root / rel, wave, sample_rate)
            f = max(int(duration * LOGIT_FPS / LOGIT_STRIDE), 1)
            logits = rng.randn(f, num_emotions).astype(np.float32) * 0.3
            logits[:, emotion] += logit_gap
            wav_paths.append(rel)
            speakers.append(f"spk{s:03d}")
            if s == num_speakers - 1:
                sets.append(SET_UNHEARD_VAL)
            else:
                sets.append(SET_HEARD_VAL if t == tracks_per_speaker - 1
                            else SET_TRAIN)
            all_logits.append(logits)
    return EmoVoxImdb(
        wav_paths=np.asarray(wav_paths, dtype=object),
        speaker=np.asarray(speakers, dtype=object),
        set_id=np.asarray(sets, np.int32),
        wav_logits=all_logits,
        dense_frames=None,
        wav_dir=str(root),
        frame_dir="",
        classes=EMOTIONS[:num_emotions],
    )
