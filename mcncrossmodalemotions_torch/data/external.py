"""External benchmark datasets (mcnDatasets' ``getRmlImdb``), audio only.

The port's copy of the audio branch of
``mcncrossmodalemotions_tpu/data/external.py``: the RML/eNTERFACE layout
scan (``<root>/<emotion>/<track>.wav``, compute_audio_feats.m:63-81) and
the tone-coded synthetic builder the tests and ``chip_smoke.py`` drive.
Face frames are not written here: no ported path reads them. The same
seed gives the same wav bytes and the same manifest as the JAX builder
(``tests/test_torch_host_copies.py``).
"""

from __future__ import annotations

from pathlib import Path
from typing import Sequence

import numpy as np

from mcncrossmodalemotions_torch.data.audio import write_wav
from mcncrossmodalemotions_torch.data.imdb import TrackImdb

RML_CLASSES = ("anger", "disgust", "fear", "happiness", "sadness", "surprise")


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


def build_synthetic_track_imdb(root: str | Path,
                               classes: Sequence[str] = RML_CLASSES,
                               tracks_per_class: int = 8, seed: int = 0,
                               sample_rate: int = 16000,
                               duration: float = 2.0) -> TrackImdb:
    """Synthetic RML/eNTERFACE-style dataset on disk, tone-coded (180 + 140
    * label Hz) so a trained model's logits carry label signal."""
    root = Path(root)
    rng = np.random.RandomState(seed)
    for label, emotion in enumerate(classes):
        for t in range(tracks_per_class):
            n = int(duration * sample_rate)
            tt = np.arange(n) / sample_rate
            freq = 180.0 + 140.0 * label
            wave = (0.5 * np.sin(2 * np.pi * freq * tt)
                    + 0.05 * rng.randn(n)).astype(np.float32)
            write_wav(root / emotion / f"track{t:03d}.wav", wave, sample_rate)
    return _track_imdb(root, classes)
