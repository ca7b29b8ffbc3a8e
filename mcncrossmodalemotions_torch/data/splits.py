"""Identity-split generation (``misc/generateBaseImdb.m`` equivalent).

The port's copy of ``mcncrossmodalemotions_tpu/data/splits.py``, held
bitwise equal to it by ``tests/test_torch_host_copies.py``.

The reference maps the ECCV "Learnable PINs" identity splits onto the
VoxCeleb imdb: set 1 = train (ECCV val merged in), set 2 = unseen-unheard
test (speakers held out entirely), set 3 = seen-heard test (held-out
tracks of training speakers) — generateBaseImdb.m:26-27,47-64, with
alignment asserts (:41-44,98-101). The published splits are tied to
VoxCeleb metadata files we cannot fetch; this module provides the same
split *semantics* driven by either an explicit speaker->set mapping (the
published split loaded from a manifest) or a deterministic seeded
generator, and exports frozen split manifests so downstream numbers are
reproducible (SURVEY.md section 7 "MATLAB RNG-pinned artifacts").
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Optional, Sequence

import numpy as np

from mcncrossmodalemotions_torch.data.imdb import (
    SET_HEARD_VAL,
    SET_TRAIN,
    SET_UNHEARD_VAL,
    EmoVoxImdb,
)


def generate_identity_splits(speakers: Sequence[str],
                             unheard_fraction: float = 0.2,
                             heard_val_fraction: float = 0.03,
                             seed: int = 0) -> np.ndarray:
    """Per-track set ids from speaker identities.

    - ``unheard_fraction`` of distinct speakers are held out entirely
      (all their tracks -> set 2, unseen-unheard);
    - of the remaining speakers' tracks, ``heard_val_fraction`` per
      speaker -> set 3 (seen-heard), rest -> set 1 (train).

    Deterministic in ``seed``; proportions follow the reference's scale
    (118,485 / 30,496 / 4,505 of 153,486 tracks — generateBaseImdb.m:26-27).
    """
    speakers = np.asarray(speakers)
    unique = np.unique(speakers)
    rng = np.random.RandomState(seed)
    shuffled = rng.permutation(unique)
    n_unheard = max(int(round(len(unique) * unheard_fraction)), 1)
    unheard = set(shuffled[:n_unheard].tolist())

    sets = np.full(len(speakers), SET_TRAIN, np.int32)
    for spk in unique:
        idx = np.where(speakers == spk)[0]
        if spk in unheard:
            sets[idx] = SET_UNHEARD_VAL
        else:
            n_heard = int(round(len(idx) * heard_val_fraction))
            if n_heard > 0:
                picks = rng.permutation(idx)[:n_heard]
                sets[picks] = SET_HEARD_VAL
    return sets


def apply_splits(imdb: EmoVoxImdb, speaker_to_set: Optional[Dict[str, int]] = None,
                 heard_val_fraction: float = 0.03, seed: int = 0,
                 **generate_kwargs) -> EmoVoxImdb:
    """Return the imdb with set ids from an explicit mapping or generated.

    An explicit ``speaker_to_set`` reproduces a published speaker-level
    split; the track-level seen-heard assignment (set 3: held-out tracks
    of train speakers, generateBaseImdb.m:47-64) is then drawn per train
    speaker at ``heard_val_fraction`` with the pinned ``seed``.
    """
    if speaker_to_set is not None:
        sets = np.asarray([speaker_to_set[s] for s in imdb.speaker], np.int32)
        rng = np.random.RandomState(seed)
        speakers = np.asarray(imdb.speaker)
        for spk in np.unique(speakers):
            if speaker_to_set.get(spk) != SET_TRAIN:
                continue
            idx = np.where(speakers == spk)[0]
            n_heard = int(round(len(idx) * heard_val_fraction))
            if n_heard > 0:
                sets[rng.permutation(idx)[:n_heard]] = SET_HEARD_VAL
    else:
        sets = generate_identity_splits(
            list(imdb.speaker), heard_val_fraction=heard_val_fraction,
            seed=seed, **generate_kwargs)
    imdb.set_id = sets
    validate_splits(imdb)
    return imdb


def validate_splits(imdb: EmoVoxImdb) -> None:
    """Alignment asserts (generateBaseImdb.m:41-44,98-101 upgraded):
    unheard speakers must not appear in train/heard sets."""
    speakers = np.asarray(imdb.speaker)
    train_spk = set(speakers[imdb.set_id == SET_TRAIN].tolist())
    heard_spk = set(speakers[imdb.set_id == SET_HEARD_VAL].tolist())
    unheard_spk = set(speakers[imdb.set_id == SET_UNHEARD_VAL].tolist())
    overlap = unheard_spk & (train_spk | heard_spk)
    assert not overlap, f"unheard speakers leak into train/heard: {overlap}"
    assert heard_spk <= train_spk or not heard_spk, (
        "heard-val speakers must be a subset of train speakers"
    )


def export_split_manifest(imdb: EmoVoxImdb, path: str | Path) -> None:
    """Freeze the split as JSON so it can be re-applied bit-identically."""
    manifest = {
        "tracks": {str(p): int(s)
                   for p, s in zip(imdb.wav_paths, imdb.set_id)},
        "counts": {str(k): int(v) for k, v in
                   zip(*np.unique(imdb.set_id, return_counts=True))},
    }
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(manifest, indent=1))


def load_split_manifest(imdb: EmoVoxImdb, path: str | Path) -> EmoVoxImdb:
    manifest = json.loads(Path(path).read_text())
    tracks = manifest["tracks"]
    imdb.set_id = np.asarray(
        [tracks[str(p)] for p in imdb.wav_paths], np.int32
    )
    validate_splits(imdb)
    return imdb
