"""EmoVoxCeleb student batches (``getBatchEmoVoxCeleb`` equivalent), jax-free.

Restates ``mcncrossmodalemotions_tpu/data/emovox.py``, whose module imports
``ops.spectrogram`` and so jax. The batches are bitwise equal to the JAX
batcher's (``tests/test_torch_emovox.py``, ``tests/test_torch_feed_options.py``,
``tests/test_torch_online_distill.py``):

- random ``num_seconds`` crop in train, start-anchored in val (the
  reference's 'vI' transform, :21-26); clips capped at 19.9 s, short clips
  zero-padded;
- speed perturbation 0.95-1.05 by polyphase resampling (:102-108), noise
  mixed from a corpus of numbered wavs (``NoiseConfig``, :122-131) or, with
  ``noise_aug`` and no corpus, from another clip of the set;
- fixedSegments (``time_offsets``): crops pinned at each track's offset,
  targets aggregated over the whole track (:91-99, :136-138);
- crop time -> teacher-logit frame indices (fps 25, stride 6), logits
  aggregated over the crop window by max or mean and truncated to
  ``num_pred_emotions``; loss-specific targets;
- per-(seed, epoch, stream) SeedSequence RNGs for the shuffle and the crop
  draws;
- int16 PCM rows (``emit_int16``, the default), uint8 mu-law rows
  (``emit_mulaw``) or float32 rows;
- ``frames_per_crop`` > 0: ``[B, K, S, S, 1]`` uint8 face frames sampled
  over each crop's window, decoded by the port's JPEG library, for the
  online (fused-teacher) step.

Where the augmentations are off, the wavs are read by the port's own
library (``data/native_audio.py``) in one threaded call a batch, packed on
its threads; its rows are bit for bit the Python path's. Only
``MCNCME_DISABLE_NATIVE`` sends the batcher to the Python reads.
"""

from __future__ import annotations

import dataclasses
import functools
import os
import time
from pathlib import Path
from typing import Dict, Iterator, Optional

import numpy as np

from mcncrossmodalemotions_torch import EMOTIONS
from mcncrossmodalemotions_torch.data.audio import (
    pack_mulaw8,
    pack_pcm16,
    read_wav,
    resample_to,
    speed_perturb,
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
from mcncrossmodalemotions_torch.utils import trace

# Restated from the JAX package's data/emovox.py; a CPU test holds them
# equal.
MAX_CLIP_SECONDS = 19.9  # getBatchEmoVoxCeleb.m:84-88
LOGIT_FPS = 25.0  # video frame rate (time2idx, :210-214)
LOGIT_STRIDE = 6  # teacher logits every 6th frame


@dataclasses.dataclass(frozen=True)
class NoiseConfig:
    """Noise-corpus augmentation (getBatchEmoVoxCeleb.m:122-131): a random
    file of ``noise_dir/%02d.wav`` (``num_files`` of them), a random offset
    and a mix ratio ``rand * noise_vol``. ``noise_len`` (native samples)
    None reads each file's length from its header."""

    noise_dir: str
    num_files: int               # meta.noise.noisenum
    noise_vol: float = 0.3       # meta.noise.noisevol
    noise_len: Optional[int] = None  # meta.noise.noiselen (samples)

    def file_path(self, index: int) -> Path:
        """1-based numbered corpus filename ('%02d.wav')."""
        return Path(self.noise_dir) / f"{index:02d}.wav"


@dataclasses.dataclass(frozen=True)
class BatchConfig:
    """Batch-loader options (run_distillation.m:71-89 defaults); the
    fields of the JAX ``BatchConfig``."""

    num_seconds: float = 4.0
    batch_size: int = 64
    loss_type: str = "hot-cross-ent"
    logit_aggregator: str = "max"  # 'max' | 'mean'
    num_pred_emotions: int = 8
    speed_aug: bool = False
    noise_aug: bool = False    # corpus-free fallback: mix another clip
    noise: Optional[NoiseConfig] = None  # the reference's corpus
    frames_per_crop: int = 0   # > 0: face frames for the online step
    frame_size: int = 224
    emit_int16: bool = True    # ship PCM16 crops (half the feed bytes)
    emit_mulaw: bool = False   # ship mu-law uint8 crops (overrides int16)
    spec: SpecConfig = DEFAULT_SPEC

    @property
    def noise_enabled(self) -> bool:
        return self.noise_aug or self.noise is not None

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


def pinned_start(start_seconds: float, native_fs: int,
                 num_samples: int) -> int:
    """fixedSegments' crop start in native samples (:91-99), clamped to a
    valid read of the real file (the DATASET_LIMIT cap does not apply);
    one definition for the Python and library feed paths."""
    return min(max(int(round(start_seconds * native_fs)), 0),
               max(num_samples - 1, 0))


def target_logit_window(wav_logits: np.ndarray, t0: Optional[float],
                        cfg: BatchConfig) -> np.ndarray:
    """Teacher-logit aggregation for one crop: over [t0, t0 +
    num_seconds], or with ``t0`` None (fixedSegments) over the whole track
    (:136-138 ``lgts_sampled = lgts``)."""
    if t0 is None:
        return aggregate_logits(wav_logits, 0.0, 1e6, cfg.logit_aggregator)
    return aggregate_logits(wav_logits, t0, t0 + cfg.num_seconds,
                            cfg.logit_aggregator)


def load_crop(wav_path: str | Path, cfg: BatchConfig,
              rng: Optional[np.random.RandomState] = None,
              noise_path: Optional[str] = None,
              start_seconds: Optional[float] = None):
    """Read one crop; returns (samples[crop_samples], t0_seconds, duration).

    Start-anchored when ``rng`` is None (val), a random start otherwise,
    with the speed factor drawn first when ``speed_aug`` is on; crop
    arithmetic in native-rate samples, off-rate files resampled.
    ``start_seconds`` pins the start (fixedSegments: no draw, no speed
    perturbation, zero-padded past the clip end). ``noise_path`` with
    ``noise_aug`` mixes that clip in at a random ratio up to 0.3.
    """
    info = wav_info(wav_path)
    fs = cfg.spec.sample_rate
    native_fs = info.sample_rate
    total = min(info.num_samples, int(MAX_CLIP_SECONDS * native_fs))
    need = cfg.crop_samples

    factor = 1.0
    if rng is not None and cfg.speed_aug and start_seconds is None:
        # fixedSegments and chspeed are exclusive branches (:91-108)
        factor = float(rng.uniform(0.95, 1.05))
    need_native = int(np.ceil(need * (native_fs / fs) * factor)) + (
        4 if factor != 1.0 else 0)

    if start_seconds is not None:
        start = pinned_start(start_seconds, native_fs, info.num_samples)
        total = min(info.num_samples, start + need_native)  # allow the tail
    else:
        max_start = max(total - need_native, 0)
        start = (int(rng.randint(0, max_start + 1))
                 if (rng is not None and max_start > 0) else 0)
    samples, got_fs = read_wav(wav_path, start, min(need_native, total - start))
    if got_fs != fs:
        samples = resample_to(samples, got_fs, fs)
    if factor != 1.0:
        samples = speed_perturb(samples, factor)
    if len(samples) < need:  # zero-pad short clips (:115-119)
        samples = np.pad(samples, (0, need - len(samples)))
    samples = samples[:need]
    if rng is not None and cfg.noise_aug and noise_path is not None:
        noise = read_noise_resampled(noise_path, need, fs)
        samples = samples + float(rng.uniform(0.0, 0.3)) * noise
    return samples.astype(np.float32), start / native_fs, info.duration


@functools.lru_cache(maxsize=256)
def _noise_wav_info(path_str: str):
    """Header of a noise-corpus file, read once: the corpus is a small
    fixed set of numbered wavs."""
    return wav_info(Path(path_str))


def read_noise_resampled(path, need: int, target_fs: int,
                         start: int = 0) -> np.ndarray:
    """``need`` target-rate samples of noise from ``path`` at native-rate
    offset ``start``: off-rate corpora resampled, short reads zero-padded.
    Shared by the corpus mix and the corpus-free fallback."""
    info = _noise_wav_info(str(path))
    need_native = (need if info.sample_rate == target_fs
                   else int(np.ceil(need * info.sample_rate / target_fs)) + 4)
    noise, fs = read_wav(path, start, need_native)
    if fs != target_fs:
        noise = resample_to(noise, fs, target_fs)
    if len(noise) < need:
        noise = np.pad(noise, (0, need - len(noise)))
    return noise[:need]


def mix_corpus_noise(samples: np.ndarray, ncfg: NoiseConfig,
                     rng: np.random.RandomState,
                     target_fs: int) -> np.ndarray:
    """The corpus mix (:122-131): three draws a sample in the reference's
    order (file ``randi(noisenum)``, offset within ``noiselen - numel(z)``,
    ratio ``rand * noisevol``), taken after the crop's draws; offsets in
    the corpus file's native samples."""
    need = len(samples)
    idx = int(rng.randint(1, ncfg.num_files + 1))
    path = ncfg.file_path(idx)
    info = _noise_wav_info(str(path))
    native_fs = info.sample_rate
    need_native = (need if native_fs == target_fs
                   else int(np.ceil(need * native_fs / target_fs)) + 4)
    total = ncfg.noise_len if ncfg.noise_len is not None else info.num_samples
    max_start = max(total - need_native, 0)
    start = int(rng.randint(0, max_start + 1)) if max_start > 0 else 0
    noise = read_noise_resampled(path, need, target_fs, start=start)
    ratio = float(rng.uniform(0.0, ncfg.noise_vol))
    return (samples + ratio * noise).astype(np.float32)


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


def logit_indices(t_seconds: np.ndarray, num_logits: np.ndarray) -> np.ndarray:
    """``time_to_logit_idx`` of each time and track length, as int64."""
    idx = np.floor(np.maximum(t_seconds * LOGIT_FPS - 1.0, 0.0) / LOGIT_STRIDE)
    return np.clip(idx.astype(np.int64), 0, np.maximum(num_logits - 1, 0))


def batch_targets(windows: np.ndarray, cfg: BatchConfig) -> Dict[str, np.ndarray]:
    """``make_targets`` of each row of ``windows`` ([B, E] aggregated
    logits), stacked."""
    logits = windows[:, : cfg.num_pred_emotions].astype(np.float32)
    out = {"max_label": np.argmax(logits, axis=1).astype(np.int32)}
    if cfg.loss_type in ("hot-cross-ent", "euclidean", "huber"):
        out["logit_target"] = logits
    if cfg.loss_type in ("euclidean", "huber"):
        out["instance_weights"] = np.ones_like(logits)
    return out


class EmoVoxBatcher:
    """Batched iterator over an EmoVoxImdb subset: shuffled random crops
    from per-epoch seeded RNGs in train, in-order start-anchored crops in
    val. ``time_offsets`` ([num_tracks] seconds) turns on fixedSegments
    (run_distillation.m:86,220): each crop starts at its track's offset and
    its target aggregates over the whole track."""

    def __init__(self, imdb: EmoVoxImdb, cfg: BatchConfig, train: bool = True,
                 seed: int = 0, time_offsets=None):
        self.imdb = imdb
        self.cfg = cfg
        self.train = train
        self.seed = seed
        self.time_offsets = (None if time_offsets is None
                             else np.asarray(time_offsets, np.float64))
        if (self.time_offsets is not None
                and len(self.time_offsets) != imdb.num_tracks):
            raise ValueError(f"time_offsets gives {len(self.time_offsets)} "
                             f"offsets for {imdb.num_tracks} tracks")
        if cfg.frames_per_crop > 0 and imdb.dense_frames is None:
            raise ValueError("frames_per_crop needs an imdb with dense_frames")

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

    def uses_library(self) -> bool:
        """Whether the batches are read by the port's wav library: unless
        switched off, wherever speed and noise augmentation are off (those
        resample and mix each crop on the host)."""
        if self.train and (self.cfg.speed_aug or self.cfg.noise_enabled):
            return False
        from mcncrossmodalemotions_torch.data import native_audio

        return native_audio.available()

    def batches(self, epoch: int = 1, epoch_size: Optional[int] = None,
                drop_remainder: bool = False) -> Iterator[Dict[str, np.ndarray]]:
        idx = self.epoch_indices(epoch, epoch_size)
        rng = _stream_rng(self.seed, epoch, "augment") if self.train else None
        wav_root = Path(self.imdb.wav_dir)
        make = self._library_batch if self.uses_library() else self._python_batch
        for i in range(0, len(idx), self.cfg.batch_size):
            chunk = idx[i:i + self.cfg.batch_size]
            if drop_remainder and len(chunk) < self.cfg.batch_size:
                break
            yield make(chunk, rng, wav_root)

    def _offset(self, j) -> Optional[float]:
        return None if self.time_offsets is None else float(self.time_offsets[j])

    def _python_batch(self, chunk, rng, wav_root: Path) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        waves, targets, t0s = [], [], []
        for j in chunk:
            noise_path = None
            if rng is not None and cfg.noise_aug and cfg.noise is None:
                # corpus-free fallback: a random other clip of the set
                k = int(rng.randint(0, self.imdb.num_tracks))
                noise_path = str(wav_root / self.imdb.wav_paths[k])
            offset = self._offset(j)
            samples, t0, _ = load_crop(str(wav_root / self.imdb.wav_paths[j]),
                                       cfg, rng=rng, noise_path=noise_path,
                                       start_seconds=offset)
            if rng is not None and cfg.noise is not None:
                samples = mix_corpus_noise(samples, cfg.noise, rng,
                                           cfg.spec.sample_rate)
            window = target_logit_window(self.imdb.wav_logits[j],
                                         None if offset is not None else t0,
                                         cfg)
            waves.append(samples)
            t0s.append(t0)
            targets.append(make_targets(window, cfg))
        stacked = {key: np.stack([t[key] for t in targets])
                   for key in targets[0]}
        return self._assemble(chunk, self._pack_waves(np.stack(waves)),
                              stacked, t0s)

    def _library_batch(self, chunk, rng, wav_root: Path) -> Dict[str, np.ndarray]:
        """``_read_batch`` inside a ``feed.batch`` span of the producer's
        thread, with its ``rows`` and the ``raw_rows`` the library copied
        (16-bit PCM) while it read them."""
        if not trace.recording():
            return self._read_batch(chunk, rng, wav_root)
        from mcncrossmodalemotions_torch.data import native_audio

        t0, raw0 = time.time_ns(), native_audio.read_crops_packed.raw_rows
        batch = self._read_batch(chunk, rng, wav_root)
        trace.add("feed.batch", t0, time.time_ns(), rows=len(chunk),
                  raw_rows=native_audio.read_crops_packed.raw_rows - raw0)
        return batch

    def _read_batch(self, chunk, rng, wav_root: Path) -> Dict[str, np.ndarray]:
        """One threaded library read of the batch's headers, then one of
        its on-rate files, packed on the library's threads when every file
        is on-rate: two releases of the interpreter lock a batch, whatever
        its size. The starts, windows and targets are array code over the
        batch. An off-rate file goes through ``load_crop`` (host resample)
        on its own, in its place in the batch. Both draw one value a sample
        with a crop start to draw, in the batch's order, so the train stream
        is the Python path's."""
        from mcncrossmodalemotions_torch.data import native_audio

        cfg = self.cfg
        fs = cfg.spec.sample_rate
        need = cfg.crop_samples
        count = len(chunk)
        root = str(wav_root)
        paths = [os.path.join(root, self.imdb.wav_paths[j]) for j in chunk]
        infos = native_audio.wav_infos(paths)
        num_samples = infos[:, 0]
        on_rate = infos[:, 1] == fs
        max_start = np.maximum(
            np.minimum(num_samples, int(MAX_CLIP_SECONDS * fs)) - need, 0)
        starts = np.zeros(count, np.int64)
        if self.time_offsets is None and rng is not None:
            draws = on_rate & (max_start > 0)
        else:  # pinned or start-anchored crops
            draws = np.zeros(count, bool)
        if self.time_offsets is not None:
            for k in np.flatnonzero(on_rate):
                starts[k] = pinned_start(self._offset(chunk[k]), fs,
                                         int(num_samples[k]))
        t0 = starts / fs
        off_rows = {}
        prev = 0
        for pos in [*np.flatnonzero(~on_rate).tolist(), count]:
            drawn = prev + np.flatnonzero(draws[prev:pos])
            if drawn.size:
                starts[drawn] = rng.randint(0, max_start[drawn] + 1)
                t0[drawn] = starts[drawn] / fs
            if pos < count:
                off_rows[pos], t0[pos], _ = load_crop(
                    paths[pos], cfg, rng=rng,
                    start_seconds=self._offset(chunk[pos]))
            prev = pos + 1
        targets = batch_targets(self._windows(chunk, t0), cfg)
        fmt = ("mulaw8" if cfg.emit_mulaw
               else "int16" if cfg.emit_int16 else None)
        if not off_rows and fmt is not None:
            data = native_audio.read_crops_packed(paths, starts, need, fmt=fmt)
        else:
            waves = np.zeros((count, need), np.float32)
            if on_rate.any():
                waves[on_rate] = native_audio.read_crops(
                    [p for p, on in zip(paths, on_rate) if on],
                    starts[on_rate], need)
            for pos, row in off_rows.items():
                waves[pos] = row
            data = self._pack_waves(waves)
        return self._assemble(chunk, data, targets, t0.tolist())

    def _windows(self, chunk, t0: np.ndarray) -> np.ndarray:
        """[B, E] teacher logits aggregated over each crop's window
        (``target_logit_window`` of each row): over [t0, t0 + num_seconds],
        or over the whole track with fixedSegments."""
        logits = [self.imdb.wav_logits[j] for j in chunk]
        lengths = np.array([len(x) for x in logits], np.int64)
        if self.time_offsets is None:
            lo, hi = t0, t0 + self.cfg.num_seconds
        else:
            lo, hi = np.zeros_like(t0), np.full_like(t0, 1e6)
        i0 = logit_indices(lo, lengths)
        i1 = np.maximum(logit_indices(hi, lengths) + 1, i0 + 1)
        if self.cfg.logit_aggregator == "mean":
            return np.stack([x[a:b].mean(axis=0)
                             for x, a, b in zip(logits, i0, i1)])
        if self.cfg.logit_aggregator != "max":
            raise ValueError(f"unknown aggregator {self.cfg.logit_aggregator!r}")
        if not lengths.all():
            raise ValueError("a track without teacher logits has no window")
        # one maximum.reduceat over the batch's tracks end to end, a row
        # past the last so that each window's end is an index
        flat = np.concatenate(logits + [logits[-1][:1]])
        first = np.cumsum(lengths) - lengths
        bounds = np.stack([first + i0, first + i1], axis=1).ravel()
        return np.maximum.reduceat(flat, bounds, axis=0)[::2]

    def _assemble(self, chunk, data: np.ndarray, targets: Dict[str, np.ndarray],
                  t0s: list) -> Dict[str, np.ndarray]:
        batch = {"data": data, **targets}
        if self.cfg.frames_per_crop > 0:
            batch["frames"] = self._crop_frames(chunk, t0s)
        return batch

    def _pack_waves(self, waves: np.ndarray) -> np.ndarray:
        if self.cfg.emit_mulaw:
            return pack_mulaw8(waves)
        return pack_pcm16(waves) if self.cfg.emit_int16 else waves

    def _crop_frames(self, chunk, crop_starts) -> np.ndarray:
        """[B, K, S, S, 1] uint8 face frames of each crop's window: K
        frames evenly spaced over the crop's logit-frame range (a track
        with fewer repeats its last), decoded by the port's library."""
        from mcncrossmodalemotions_torch.data.images import load_frame_batch

        cfg = self.cfg
        frame_root = Path(self.imdb.frame_dir)
        paths = []
        for j, t0 in zip(chunk, crop_starts):
            track_frames = self.imdb.dense_frames[j]
            f = len(track_frames)
            i0 = time_to_logit_idx(t0, f)
            i1 = max(time_to_logit_idx(t0 + cfg.num_seconds, f), i0)
            picks = np.linspace(i0, i1, cfg.frames_per_crop).round().astype(int)
            picks = np.clip(picks, 0, f - 1)
            paths.extend(str(frame_root / track_frames[p]) for p in picks)
        flat = load_frame_batch(paths, cfg.frame_size)
        return flat.reshape(len(chunk), cfg.frames_per_crop, *flat.shape[1:])


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
    unheardVal. ``with_frames`` also writes one synthetic face JPEG a
    logit frame under ``root.parent / "frames"`` (through PIL, so only
    where PIL is installed) and fills ``dense_frames``.
    """
    root = Path(root)
    rng = np.random.RandomState(seed)
    wav_paths, speakers, sets, all_logits = [], [], [], []
    dense_frames = [] if with_frames else None
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
            if with_frames:
                from mcncrossmodalemotions_torch.data.images import (
                    save_synthetic_frame,
                )

                frame_rels = [f"{rel[:-4]}/{k:04d}.jpg" for k in range(f)]
                for k, frel in enumerate(frame_rels):
                    save_synthetic_frame(root.parent / "frames" / frel,
                                         emotion, seed=seed + k)
                dense_frames.append(np.asarray(frame_rels, dtype=object))
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
        dense_frames=dense_frames,
        wav_dir=str(root),
        frame_dir=str(root.parent / "frames") if with_frames else "",
        classes=EMOTIONS[:num_emotions],
    )
