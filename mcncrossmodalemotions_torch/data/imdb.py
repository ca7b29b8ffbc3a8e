"""The imdb manifests the port reads and writes (SURVEY.md section 2.3).

The port's copy of ``EmoVoxImdb``, ``FerPlusImdb``, ``TrackImdb`` and their
helpers from ``mcncrossmodalemotions_tpu/data/imdb.py``: typed dataclasses with an npz
round trip (object arrays for ragged per-track data). They write and read
the same ``.npz`` files, with the same keys, as the JAX package's classes,
in both directions (``tests/test_torch_host_copies.py``). Also the reader
of the released EmoVoxCeleb logits imdb (``emovox_imdb_from_mat``), bitwise
the JAX package's on both MATLAB containers (``tests/test_torch_artifacts.py``);
it tells the containers apart by the file's signature
(``utils/mat73.is_hdf5``), so a classic file reads without ``h5py``.
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


def emovox_imdb_from_mat(path: str | Path, wav_dir: str = "",
                         frame_dir: str = "",
                         with_frames: bool = True) -> EmoVoxImdb:
    """Import the released ``senet50-ferplus-logits.mat`` EmoVoxCeleb imdb.

    Schema (fetch_emovoxceleb_imdb.m buildImdb, SURVEY.md section 2.3):
    ``images.name`` wav relpaths, ``images.sp`` speaker ids, ``images.set``
    in {1,2,3}, flat ``images.denseFrames`` + ``images.denseFramesWavIds``
    (1-based wav ids per frame), and the ``wavLogits`` cell of per-wav
    [F, 8] logits. Reads the classic container (scipy.io) and MATLAB
    -v7.3/HDF5 (h5py, imported only for it: the released multi-GB dump's
    format).
    """
    from mcncrossmodalemotions_torch.utils import mat73

    if mat73.is_hdf5(path):
        return _emovox_from_mat_h5(path, wav_dir, frame_dir, with_frames)
    return _emovox_from_mat_scipy(path, wav_dir, frame_dir, with_frames)


def _group_dense_frames(dense_frames, wav_ids, num_tracks: int):
    """Flat frame list + 1-based wav ids -> per-track frame-path lists."""
    if dense_frames is None or len(dense_frames) == 0:
        return None
    per_track: list = [[] for _ in range(num_tracks)]
    for frame, wid in zip(dense_frames, wav_ids):
        per_track[int(wid) - 1].append(str(frame))
    return [np.asarray(f, dtype=object) for f in per_track]


def _emovox_from_mat_scipy(path, wav_dir, frame_dir, with_frames) -> EmoVoxImdb:
    import scipy.io

    from mcncrossmodalemotions_torch import EMOTIONS

    mat = scipy.io.loadmat(str(path), struct_as_record=False, squeeze_me=True)
    images = mat["images"]
    names = np.asarray([str(n) for n in np.atleast_1d(images.name)],
                       dtype=object)
    speakers = np.asarray([str(s) for s in np.atleast_1d(images.sp)],
                          dtype=object)
    set_id = np.asarray(np.atleast_1d(images.set), np.int32)
    wl = mat["wavLogits"]
    if isinstance(wl, np.ndarray) and wl.dtype != object:
        # squeeze_me collapses a 1-cell wavLogits to the bare [F, 8]
        # array; iterating that would yield F per-row "tracks"
        cells = [np.asarray(wl)]
    else:
        cells = list(np.atleast_1d(wl))
    wav_logits = [np.atleast_2d(np.asarray(l, np.float32)) for l in cells]
    dense = None
    if with_frames and hasattr(images, "denseFrames"):
        dense = _group_dense_frames(
            [str(f) for f in np.atleast_1d(images.denseFrames)],
            np.atleast_1d(images.denseFramesWavIds), len(names))
    return EmoVoxImdb(wav_paths=names, speaker=speakers, set_id=set_id,
                      wav_logits=wav_logits, dense_frames=dense,
                      wav_dir=wav_dir, frame_dir=frame_dir, classes=EMOTIONS)


def _emovox_from_mat_h5(path, wav_dir, frame_dir, with_frames) -> EmoVoxImdb:
    """MATLAB -v7.3 (HDF5) layout: cell arrays are object-reference
    datasets, strings uint16 codepoint matrices, numeric arrays transposed
    (column-major storage); ``utils/mat73`` undoes each."""
    import h5py

    from mcncrossmodalemotions_torch import EMOTIONS
    from mcncrossmodalemotions_torch.utils import mat73

    with h5py.File(str(path), "r") as f:
        images = f["images"]
        names = mat73.string_cell(f, images["name"])
        speakers = mat73.string_cell(f, images["sp"])
        set_id = np.asarray(images["set"]).reshape(-1).astype(np.int32)
        # v7.3 stores column-major: a MATLAB [F, 8] single arrives [8, F]
        wav_logits = [
            np.atleast_2d(mat73.matlab_array(f, r).astype(np.float32))
            for r in mat73.cell_refs(f["wavLogits"])]
        dense = None
        if with_frames and "denseFrames" in images:
            frames = mat73.string_cell(f, images["denseFrames"])
            wav_ids = np.asarray(images["denseFramesWavIds"]).reshape(-1)
            dense = _group_dense_frames(frames, wav_ids, len(names))
    return EmoVoxImdb(wav_paths=names, speaker=speakers, set_id=set_id,
                      wav_logits=wav_logits, dense_frames=dense,
                      wav_dir=wav_dir, frame_dir=frame_dir, classes=EMOTIONS)


@dataclasses.dataclass
class FerPlusImdb:
    """FER2013+ manifest: pixel data + rater vote distributions."""

    data: np.ndarray        # [N, H, W, 1] uint8 grayscale
    hard_labels: np.ndarray  # [N] int (majority emotion)
    votes: np.ndarray        # [N, 10] float rater votes (cols 8,9 = NF/unknown)
    set_id: np.ndarray       # [N] int {1 train, 2 val, 3 test}
    classes: Sequence[str] = ()

    @property
    def num_images(self) -> int:
        return len(self.data)

    def subset(self, idx) -> "FerPlusImdb":
        idx = np.asarray(idx)
        return FerPlusImdb(self.data[idx], self.hard_labels[idx],
                           self.votes[idx], self.set_id[idx], self.classes)

    def save(self, path: str | Path) -> None:
        _save_npz(path, {
            "data": self.data,
            "hard_labels": self.hard_labels.astype(np.int32),
            "votes": self.votes.astype(np.float32),
            "set_id": self.set_id.astype(np.int32),
        }, {"classes": list(self.classes)})

    @classmethod
    def load(cls, path: str | Path) -> "FerPlusImdb":
        data, meta = _load_npz(path)
        return cls(data["data"], data["hard_labels"], data["votes"],
                   data["set_id"], tuple(meta["classes"]))


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
