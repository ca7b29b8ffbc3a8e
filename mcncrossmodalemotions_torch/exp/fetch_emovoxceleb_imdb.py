"""EmoVoxCeleb imdb construction (``fetch_emovoxceleb_imdb.m``).

Port of ``mcncrossmodalemotions_tpu/exp/fetch_emovoxceleb_imdb.py``: crawls
the VoxCeleb face-frame tree, registers frames to wav tracks (dropping
frameless tracks and unclaimed frames, :228-285), runs dense teacher
inference over every frame on the card (batch 128, crop 1/1.6, :119-136,
through ``exp/compute_visual_feats.VisualFeatureExtractor``) and regroups
the logits per wav into ``wav_logits`` matrices (:140-148). The result is
the port's ``data/imdb.EmoVoxImdb``, the one ``run_distillation`` trains
on; its ``.npz`` cache is the JAX package's format.

Expected layout:
    <root>/wavs/<speaker>/<track>.wav
    <root>/frames/<speaker>/<track>/*.jpg   (every 6th video frame)

``fetch_emovoxceleb_imdb(download=True)`` first resolves the released
prebuilt logits (``senet50-ferplus-logits.mat``, fetch_emovoxceleb_imdb.m:
288-324) through the artifact registry and converts them
(``data/imdb.emovox_imdb_from_mat``); on a miss it falls through to the
teacher build.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Mapping, Optional

import numpy as np
import torch
from torch import nn

from mcncrossmodalemotions_torch import EMOTIONS
from mcncrossmodalemotions_torch.data.imdb import (
    EmoVoxImdb,
    emovox_imdb_from_mat,
)
from mcncrossmodalemotions_torch.exp.compute_visual_feats import (
    VisualFeatureExtractor,
)
from mcncrossmodalemotions_torch.utils.device import resolve_device

CROP_RATIO = 1.0 / 1.6  # fetch_emovoxceleb_imdb.m:169 CropSize
_MEMORY_CACHE: Dict[str, EmoVoxImdb] = {}  # dev_cache (misc/dev_cache.m)


def register_frames(wav_paths: List[str], frame_root: Path) -> tuple:
    """Map each wav track to its sorted dense frame list. Tracks without
    frames are dropped (:268-275), frames without a wav ignored
    (:276-281). Returns (kept wav indices, frames of each kept track)."""
    kept, frames = [], []
    for i, rel in enumerate(wav_paths):
        track = Path(rel).with_suffix("")
        frame_dir = frame_root / track
        if not frame_dir.is_dir():
            continue
        # the JAX original's str(p.relative_to(frame_root)), spelled from
        # the names: relative_to cost most of a registration
        jpgs = sorted(f"{track}/{p.name}" for p in frame_dir.glob("*.jpg"))
        if not jpgs:
            continue
        kept.append(i)
        frames.append(np.asarray(jpgs, dtype=object))
    return np.asarray(kept, np.int64), frames


def build_imdb(root: str | Path, teacher_model: nn.Module,
               teacher_state: Mapping[str, torch.Tensor],
               set_assignment: Optional[Dict[str, int]] = None,
               batch_size: int = 128,
               limit: Optional[int] = None,
               mesh=None,
               partial_path: Optional[str] = None,
               max_frames: Optional[int] = None,
               max_frames_per_process: Optional[int] = None,
               verbose: bool = True,
               device: torch.device | str = "cuda") -> Optional[EmoVoxImdb]:
    """Dense teacher inference over every registered frame -> EmoVoxImdb.

    ``teacher_model`` is a ``FaceTeacherPipeline`` and ``teacher_state``
    its ``state_dict``, run on ``device`` (the card by default; without a
    CUDA device the default raises). ``set_assignment`` maps speaker id ->
    set (1/2/3, default 1); ``limit`` caps the tracks (the opts.limit dev
    pattern, :62). ``partial_path`` makes the pass resumable; with it,
    ``max_frames`` bounds the frames of this call, which returns None until
    a call finishes the job. ``mesh`` and ``max_frames_per_process`` are
    not ported and raise.
    """
    if mesh is not None:
        raise NotImplementedError("multi-card inference (mesh=) is not "
                                  "ported yet; see ROADMAP.md queue 1, item 15")
    if max_frames_per_process:
        raise NotImplementedError(
            "max_frames_per_process (exp/dense_chunked.py of the JAX package) "
            "is not ported; see ROADMAP.md")
    device = resolve_device(device, "build_imdb")
    root = Path(root)
    wav_root, frame_root = root / "wavs", root / "frames"
    wav_paths = sorted(str(p.relative_to(wav_root))
                       for p in wav_root.rglob("*.wav"))
    kept, frames = register_frames(wav_paths, frame_root)
    if limit:
        kept, frames = kept[:limit], frames[:limit]
    wav_paths = [wav_paths[i] for i in kept]
    speakers = [p.split("/")[0] for p in wav_paths]
    sets = np.asarray([(set_assignment or {}).get(s, 1) for s in speakers],
                      np.int32)
    flat = [str(frame_root / f) for track in frames for f in track]
    if verbose:
        print(f"dense teacher inference over {len(flat)} frames "
              f"({len(wav_paths)} tracks)")
    extractor = VisualFeatureExtractor(teacher_model, teacher_state,
                                       batch_size=batch_size,
                                       crop_ratio=CROP_RATIO, device=device)
    all_logits = extractor.frame_logits(flat, verbose=verbose,
                                        partial_path=partial_path,
                                        max_frames=max_frames)
    if all_logits is None:  # a bounded call that did not finish the job
        return None
    wav_logits, offset = [], 0
    for track in frames:
        f = len(track)
        wav_logits.append(all_logits[offset:offset + f].astype(np.float32))
        offset += f
    return EmoVoxImdb(
        wav_paths=np.asarray(wav_paths, dtype=object),
        speaker=np.asarray(speakers, dtype=object),
        set_id=sets,
        wav_logits=wav_logits,
        dense_frames=frames,
        wav_dir=str(wav_root),
        frame_dir=str(frame_root),
        classes=EMOTIONS,
    )


def fetch_emovoxceleb_imdb(root: str | Path,
                           teacher_model: Optional[nn.Module] = None,
                           teacher_state: Optional[Mapping[str, torch.Tensor]] = None,
                           cache_path: Optional[str] = None,
                           download: bool = False,
                           **build_kwargs) -> EmoVoxImdb:
    """Load-or-build with two cache levels (in memory, then the ``.npz`` at
    ``cache_path``), as fetch_emovoxceleb_imdb.m:16-40. On a miss: with
    ``download=True``, the released prebuilt logits through the artifact
    registry (``ensure_artifact("emovoxceleb-logits")``, its tracks under
    ``root/wavs`` and ``root/frames``); else, or when that artifact is
    unavailable, the teacher builds it (``build_imdb``, resumable through
    ``<cache_path>.partial.npz`` unless ``partial_path`` is given)."""
    key = f"{root}|{cache_path}"
    if key in _MEMORY_CACHE:
        return _MEMORY_CACHE[key]
    if cache_path and Path(cache_path).exists():
        imdb = EmoVoxImdb.load(cache_path)
    else:
        imdb = None
        if download:
            from mcncrossmodalemotions_torch.zoo.artifacts import (
                ensure_artifact,
            )

            mat = ensure_artifact("emovoxceleb-logits")
            if mat is not None:
                imdb = emovox_imdb_from_mat(
                    mat, wav_dir=str(Path(root) / "wavs"),
                    frame_dir=str(Path(root) / "frames"))
        if imdb is None:
            if teacher_model is None or teacher_state is None:
                raise FileNotFoundError(
                    f"no cached imdb at {cache_path!r}; pass a teacher model "
                    "and its state to build it, or download=True for the "
                    "released logits")
            build_kwargs.setdefault(
                "partial_path",
                f"{cache_path}.partial.npz" if cache_path else None)
            imdb = build_imdb(root, teacher_model, teacher_state,
                              **build_kwargs)
            if imdb is None:
                raise ValueError("fetch_emovoxceleb_imdb builds the whole "
                                 "imdb: max_frames belongs to build_imdb")
        if cache_path:
            imdb.save(cache_path)
    _MEMORY_CACHE[key] = imdb
    return imdb
