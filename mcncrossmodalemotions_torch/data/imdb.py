"""The imdb manifests the port reads and writes (SURVEY.md section 2.3).

The port's copy of ``EmoVoxImdb``, ``TrackImdb`` and their helpers from
``mcncrossmodalemotions_tpu/data/imdb.py``: typed dataclasses with an npz
round trip (object arrays for ragged per-track data). They write and read
the same ``.npz`` files, with the same keys, as the JAX package's classes,
in both directions (``tests/test_torch_host_copies.py``).
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np

# Set conventions (generateBaseImdb.m:47-64, student_stats.m:79-81)
SET_TRAIN = 1
SET_UNHEARD_VAL = 2
SET_HEARD_VAL = 3


def object_array(seq) -> np.ndarray:
    """1-D object array whose elements are the items of ``seq``.

    ``np.asarray(seq, dtype=object)`` collapses uniformly shaped per-track
    arrays into one (N, F, C) object array, whose rows break float ufuncs
    after an npz round trip; a pre-allocated 1-D container keeps each
    track an independent float array.
    """
    arr = np.empty(len(seq), object)
    for i, item in enumerate(seq):
        arr[i] = item
    return arr


def float_tracks(rows) -> list:
    """Per-track rows from an npz cache -> list of float32 arrays (rows
    written by the collapsing idiom come back as float32 too)."""
    return [np.asarray(r, np.float32) for r in rows]


def _save_npz(path: str | Path, arrays: Dict[str, np.ndarray], meta: dict) -> None:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(".tmp.npz")
    np.savez_compressed(tmp, __meta__=json.dumps(meta, default=str), **arrays)
    tmp.replace(path)


def _load_npz(path: str | Path):
    data = np.load(path, allow_pickle=True)
    return data, json.loads(str(data["__meta__"]))


@dataclasses.dataclass
class EmoVoxImdb:
    """EmoVoxCeleb manifest: one row per wav track."""

    wav_paths: np.ndarray          # [N] str relpaths
    speaker: np.ndarray            # [N] str speaker ids
    set_id: np.ndarray             # [N] int in {1,2,3}
    wav_logits: List[np.ndarray]   # per wav: [F, 8] float32 teacher logits
    dense_frames: Optional[List[np.ndarray]] = None  # per wav: frame relpaths
    wav_dir: str = ""
    frame_dir: str = ""
    classes: Sequence[str] = ()

    def __post_init__(self):
        if len(self.wav_paths) != len(self.wav_logits):
            raise ValueError(f"{len(self.wav_paths)} wav paths but "
                             f"{len(self.wav_logits)} logit tracks")

    @property
    def num_tracks(self) -> int:
        return len(self.wav_paths)

    def subset(self, idx) -> "EmoVoxImdb":
        idx = np.asarray(idx)
        return EmoVoxImdb(
            wav_paths=self.wav_paths[idx],
            speaker=self.speaker[idx],
            set_id=self.set_id[idx],
            wav_logits=[self.wav_logits[i] for i in idx],
            dense_frames=(
                [self.dense_frames[i] for i in idx] if self.dense_frames else None
            ),
            wav_dir=self.wav_dir,
            frame_dir=self.frame_dir,
            classes=self.classes,
        )

    def save(self, path: str | Path) -> None:
        arrays = {
            "wav_paths": np.asarray(self.wav_paths, dtype=object),
            "speaker": np.asarray(self.speaker, dtype=object),
            "set_id": np.asarray(self.set_id, np.int32),
            "wav_logits": object_array(self.wav_logits),
        }
        if self.dense_frames is not None:
            arrays["dense_frames"] = object_array(self.dense_frames)
        _save_npz(path, arrays, {"wav_dir": self.wav_dir,
                                 "frame_dir": self.frame_dir,
                                 "classes": list(self.classes)})

    @classmethod
    def load(cls, path: str | Path) -> "EmoVoxImdb":
        data, meta = _load_npz(path)
        return cls(
            wav_paths=data["wav_paths"],
            speaker=data["speaker"],
            set_id=data["set_id"],
            wav_logits=float_tracks(data["wav_logits"]),
            dense_frames=(
                list(data["dense_frames"]) if "dense_frames" in data else None
            ),
            wav_dir=meta["wav_dir"],
            frame_dir=meta.get("frame_dir", ""),
            classes=tuple(meta["classes"]),
        )


@dataclasses.dataclass
class TrackImdb:
    """External benchmark manifest (RML/eNTERFACE/AFEW): one row per track."""

    track_ids: np.ndarray                 # [N] str/int
    labels: np.ndarray                    # [N] int dataset-native emotion ids
    set_id: np.ndarray                    # [N] int (1 train / 2 val)
    wav_paths: Optional[np.ndarray] = None      # [N] str (audio modality)
    frame_paths: Optional[List[np.ndarray]] = None  # per track frame lists
    logits: Optional[List[np.ndarray]] = None   # per track [F, 8] features
    classes: Sequence[str] = ()

    @property
    def num_tracks(self) -> int:
        return len(self.track_ids)

    def save(self, path: str | Path) -> None:
        arrays = {
            "track_ids": np.asarray(self.track_ids, dtype=object),
            "labels": np.asarray(self.labels, np.int32),
            "set_id": np.asarray(self.set_id, np.int32),
        }
        if self.wav_paths is not None:
            arrays["wav_paths"] = np.asarray(self.wav_paths, dtype=object)
        if self.frame_paths is not None:
            arrays["frame_paths"] = object_array(self.frame_paths)
        if self.logits is not None:
            arrays["logits"] = object_array(self.logits)
        _save_npz(path, arrays, {"classes": list(self.classes)})

    @classmethod
    def load(cls, path: str | Path) -> "TrackImdb":
        data, meta = _load_npz(path)
        return cls(
            track_ids=data["track_ids"],
            labels=data["labels"],
            set_id=data["set_id"],
            wav_paths=data.get("wav_paths"),
            frame_paths=list(data["frame_paths"]) if "frame_paths" in data else None,
            logits=(float_tracks(data["logits"])
                    if "logits" in data else None),
            classes=tuple(meta["classes"]),
        )
