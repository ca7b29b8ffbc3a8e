"""Host-side dataset helpers of the port.

``audio``, ``native``, ``imdb``, ``external`` and ``images`` are the port's
own copies of what it uses from the JAX package's host modules of the same
names (numpy and ctypes only; ``tests/test_torch_host_copies.py`` and
``tests/test_torch_faces.py`` hold each equal to its original). The port imports nothing of the JAX package.
Scripts that drive the port take what they need from here.
"""

from __future__ import annotations

from pathlib import Path
from typing import Sequence

import numpy as np

from mcncrossmodalemotions_torch.data.external import build_synthetic_track_imdb
from mcncrossmodalemotions_torch.data.imdb import TrackImdb

__all__ = ["TrackImdb", "synthetic_track_imdb"]


def synthetic_track_imdb(root: str | Path,
                         durations: Sequence[float] = (1.5, 4.1, 10.3),
                         tracks_per_class: int = 7) -> TrackImdb:
    """Tone-coded synthetic wavs of the six RML classes,
    ``tracks_per_class`` per class at each of ``durations`` seconds (one
    subdirectory and seed ``i`` per duration), as one TrackImdb.

    The defaults are the extraction traffic that ``chip_smoke.py`` and
    ``exp/profile_extraction.py`` drive: 126 tracks (6 classes x 7) in the
    100-, 400- and 1000-frame buckets, padded to 200, 500 and 1100 frames.
    """
    root = Path(root)
    parts = [build_synthetic_track_imdb(root / f"d{i}",
                                        tracks_per_class=tracks_per_class,
                                        seed=i, duration=d)
             for i, d in enumerate(durations)]
    return TrackImdb(
        track_ids=np.concatenate([p.track_ids for p in parts]),
        labels=np.concatenate([p.labels for p in parts]),
        set_id=np.concatenate([p.set_id for p in parts]),
        wav_paths=np.concatenate([p.wav_paths for p in parts]))
