"""External benchmark datasets (mcnDatasets' ``getRmlImdb``,
``getEnterfaceImdb``, ``getAfewImdb``).

The port's copy of ``mcncrossmodalemotions_tpu/data/external.py``: the
RML/eNTERFACE layout scan (``<root>/<emotion>/<track>.wav`` with an
optional ``<track>/`` frame directory, compute_audio_feats.m:63-81),
AFEW's predefined split (``<root>/{Train,Val}/<emotion>/<track>.wav``),
and the tone-coded synthetic builder the tests and ``chip_smoke.py``
drive, in either layout and with or without face frames. The same seed
gives the same wav bytes and the same manifest as the JAX builder, and
the same tree the same manifests; the frames' pixels are within 10 gray
levels of the JAX builder's, whose files PIL writes
(``tests/test_torch_host_copies.py``).
"""

from __future__ import annotations

from pathlib import Path
from typing import Sequence

import numpy as np

from mcncrossmodalemotions_torch.data.audio import write_wav
from mcncrossmodalemotions_torch.data.imdb import TrackImdb

RML_CLASSES = ("anger", "disgust", "fear", "happiness", "sadness", "surprise")
ENTERFACE_CLASSES = RML_CLASSES
AFEW_CLASSES = ("anger", "disgust", "fear", "happiness", "neutral",
                "sadness", "surprise")


def _scan_emotion_dirs(root: Path, classes: Sequence[str], set_value: int):
    ids, labels, sets, wavs, frames = [], [], [], [], []
    for label, emotion in enumerate(classes):
        emo_dir = root / emotion
        if not emo_dir.is_dir():
            continue
        for wav in sorted(emo_dir.glob("*.wav")):
            ids.append(f"{emotion}/{wav.stem}")
            labels.append(label)
            sets.append(set_value)
            wavs.append(str(wav))
            frame_dir = wav.with_suffix("")
            if frame_dir.is_dir():
                frames.append(np.asarray(
                    sorted(str(p) for p in frame_dir.glob("*.jpg")), dtype=object))
            else:
                frames.append(np.asarray([], dtype=object))
    return ids, labels, sets, wavs, frames


def _track_imdb(root: Path, classes: Sequence[str]) -> TrackImdb:
    ids, labels, sets, wavs, frames = _scan_emotion_dirs(root, classes, 1)
    return TrackImdb(
        track_ids=np.asarray(ids, dtype=object),
        labels=np.asarray(labels, np.int32),
        set_id=np.asarray(sets, np.int32),
        wav_paths=np.asarray(wavs, dtype=object),
        frame_paths=frames,
        classes=tuple(classes),
    )


def get_rml_imdb(root: str | Path) -> TrackImdb:
    """RML emotion dataset manifest (6 classes, CV splits downstream)."""
    return _track_imdb(Path(root), RML_CLASSES)


def get_enterface_imdb(root: str | Path) -> TrackImdb:
    """eNTERFACE'05 manifest (the layout and classes of RML)."""
    return get_rml_imdb(root)


def get_afew_imdb(root: str | Path, drop_tracks_with_no_dets: bool = True,
                  subsample_stride: int = 1) -> TrackImdb:
    """AFEW manifest with its predefined Train(1)/Val(2) split.

    ``drop_tracks_with_no_dets`` drops tracks with empty frame lists (all
    of them kept where none has frames: the audio-only layout);
    ``subsample_stride`` thins the frame lists (getAfewImdb options,
    compute_audio_feats.m:67-73).
    """
    root = Path(root)
    parts = [_scan_emotion_dirs(root / subset, AFEW_CLASSES, set_value)
             for subset, set_value in (("Train", 1), ("Val", 2))]
    ids, labels, sets, wavs, frames = (sum((p[i] for p in parts), [])
                                       for i in range(5))
    if subsample_stride > 1:
        frames = [f[::subsample_stride] for f in frames]
    keep = np.arange(len(ids))
    if drop_tracks_with_no_dets:
        keep = np.asarray([i for i in keep if len(frames[i]) > 0], np.int64)
        if len(keep) == 0:
            keep = np.arange(len(ids))
    return TrackImdb(
        track_ids=np.asarray(ids, dtype=object)[keep],
        labels=np.asarray(labels, np.int32)[keep],
        set_id=np.asarray(sets, np.int32)[keep],
        wav_paths=np.asarray(wavs, dtype=object)[keep],
        frame_paths=[frames[i] for i in keep],
        classes=AFEW_CLASSES,
    )


def build_synthetic_track_imdb(root: str | Path,
                               classes: Sequence[str] = RML_CLASSES,
                               tracks_per_class: int = 8, seed: int = 0,
                               sample_rate: int = 16000,
                               duration: float = 2.0,
                               with_frames: bool = False,
                               afew_layout: bool = False) -> TrackImdb:
    """Synthetic RML/eNTERFACE/AFEW-style dataset on disk, tone-coded (180 +
    140 * label Hz) so a trained model's logits carry label signal.

    ``afew_layout`` puts the first 70% of each class's tracks under
    ``Train/`` and the rest under ``Val/`` and returns ``get_afew_imdb``'s
    manifest; ``with_frames`` writes three synthetic face frames beside
    each wav (``data/images.save_synthetic_frame``: the pixels of the JAX
    builder's frames, through the port's own JPEG writer).
    """
    from mcncrossmodalemotions_torch.data.images import save_synthetic_frame

    root = Path(root)
    rng = np.random.RandomState(seed)
    for label, emotion in enumerate(classes):
        for t in range(tracks_per_class):
            if afew_layout:
                subset = "Train" if t < int(tracks_per_class * 0.7) else "Val"
                wav_path = root / subset / emotion / f"track{t:03d}.wav"
            else:
                wav_path = root / emotion / f"track{t:03d}.wav"
            n = int(duration * sample_rate)
            tt = np.arange(n) / sample_rate
            freq = 180.0 + 140.0 * label
            wave = (0.5 * np.sin(2 * np.pi * freq * tt)
                    + 0.05 * rng.randn(n)).astype(np.float32)
            write_wav(wav_path, wave, sample_rate)
            if with_frames:
                frame_dir = wav_path.with_suffix("")
                for k in range(3):
                    save_synthetic_frame(frame_dir / f"{k:02d}.jpg", label,
                                         seed=seed + t * 10 + k)
    if afew_layout:
        return get_afew_imdb(root)
    return _track_imdb(root, classes)
