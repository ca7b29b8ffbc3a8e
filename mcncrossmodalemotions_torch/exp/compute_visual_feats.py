"""Teacher feature extraction over face frames (``compute_visual_feats.m``).

Port of ``mcncrossmodalemotions_tpu/exp/compute_visual_feats.py``: flattens
every track's frame list, runs batched teacher inference (batch 128, as the
reference, :83-98) and regroups per-track logit matrices [F, C] (:100-110).
The same engine runs the dense EmoVoxCeleb imdb build
(``exp/fetch_emovoxceleb_imdb.py``).

Frames are decoded on the host by the port's own JPEG decoder library
(``data/images.load_frame_batch``: decode, crop, resize, gray, threaded in
C++), one batch ahead of the card, and shipped as uint8 through pinned
memory; the pipeline's resize, channel replication, mean subtraction and
the teacher run on the device (the card unless the caller passes
``device="cpu"``).
"""

from __future__ import annotations

import dataclasses
import hashlib
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import List, Mapping, Optional, Sequence

import numpy as np
import torch
from torch import nn
from torch.func import functional_call

from mcncrossmodalemotions_torch.data.images import load_frame_batch
from mcncrossmodalemotions_torch.exp.compute_audio_feats import (
    _load_feat_cache,
    _save_feat_cache,
)
from mcncrossmodalemotions_torch.utils.device import resolve_device
from mcncrossmodalemotions_torch.utils.logging import Eta


@dataclasses.dataclass
class VisualFeatureExtractor:
    """Batched teacher forward over host-decoded face frames.

    ``model`` is a ``FaceTeacherPipeline`` (uint8 gray frames in, logits
    out) and ``state`` its ``state_dict`` on any device; ``state`` is copied
    to ``device`` (the card unless the caller asks for ``"cpu"``; without a
    CUDA device the default raises) and the forward is a
    ``functional_call`` with it, so ``model``'s own tensors are never read.
    One prefetch thread decodes batch i+1 while the device runs batch i.
    ``crop_ratio`` 1.0 is the reference's external-face default (no
    CropSize, compute_visual_feats.m:123-143); the EmoVoxCeleb build uses
    1/1.6 (fetch_emovoxceleb_imdb.m:169). The ``mesh`` of the JAX extractor
    (multi-chip inference) is not ported.
    """

    model: nn.Module
    state: Mapping[str, torch.Tensor]
    batch_size: int = 128
    num_threads: int = 8
    input_size: int = 224
    crop_ratio: float = 1.0
    device: torch.device | str = "cuda"

    def __post_init__(self):
        self.device = resolve_device(self.device, "VisualFeatureExtractor")
        self._state = {k: v.to(self.device) for k, v in self.state.items()}

    def _job_key(self, frame_paths: Sequence[str]) -> str:
        """Fingerprint guarding resume: the frame list (count and a sample
        of paths), crop and size, and every tensor of the port's own
        ``state_dict`` in key order. A partial written by the JAX package
        (whose key hashes its Flax tree) does not resume here, nor the
        other way round: the job restarts."""
        h = hashlib.sha1()
        h.update(f"crop={self.crop_ratio} size={self.input_size}\n".encode())
        h.update(str(len(frame_paths)).encode())
        h.update("\n".join(map(str, frame_paths[:: max(
            1, len(frame_paths) // 4096)])).encode())
        for key in sorted(self.state):
            arr = self.state[key].detach().cpu().contiguous().numpy()
            h.update(f"{key}{arr.shape}{arr.dtype}".encode())
            h.update(arr.tobytes())
        return h.hexdigest()

    def _pad_batch(self, batch: np.ndarray) -> np.ndarray:
        """Pad to ``batch_size`` with the last frame (trimmed after)."""
        pad = self.batch_size - len(batch)
        if pad > 0:
            batch = np.concatenate([batch, np.repeat(batch[-1:], pad, 0)])
        return batch

    def _forward(self, batch: np.ndarray) -> torch.Tensor:
        x = torch.from_numpy(batch)
        if self.device.type == "cuda":
            x = x.pin_memory().to(self.device, non_blocking=True)
        with torch.inference_mode():
            return functional_call(self.model, self._state, (x,), strict=True)

    def _decode(self, chunk: Sequence[str]) -> np.ndarray:
        return load_frame_batch(chunk, self.input_size, self.num_threads,
                                self.crop_ratio)

    def frame_logits(self, frame_paths: Sequence[str],
                     verbose: bool = True,
                     partial_path: Optional[str] = None,
                     checkpoint_every: int = 200,
                     max_frames: Optional[int] = None) -> Optional[np.ndarray]:
        """[N, C] fp32 logits over a flat frame list, batched + prefetched.

        ``partial_path`` makes the dense pass resumable: completed logits
        are flushed every ``checkpoint_every`` batches (at most about 20
        flushes a run) and reloaded on restart when the fingerprint
        (``_job_key``) matches. ``max_frames`` (which needs
        ``partial_path``) bounds the new frames of this call to whole
        batches, at least one: when the job does not finish within it,
        progress is flushed and None is returned; a later call resumes.
        A finished job deletes its partial.
        """
        if max_frames is not None and not partial_path:
            raise ValueError("max_frames requires partial_path (the next "
                             "call must be able to resume)")
        n = len(frame_paths)
        done = 0
        out: List[np.ndarray] = []
        job_key = self._job_key(frame_paths) if partial_path else ""
        if partial_path and Path(partial_path).exists():
            data = np.load(partial_path, allow_pickle=False)
            if "key" in data and str(data["key"]) == job_key:
                saved = data["logits"]
                done = saved.shape[0]
                out.append(saved)
                if verbose:
                    print(f"resuming dense inference at {done}/{n} frames")
            elif verbose:
                print("partial checkpoint does not match this job; restarting")

        def flush():
            merged = np.concatenate(out) if out else np.zeros((0, 8), np.float32)
            tmp = Path(partial_path).with_suffix(".tmp.npz")
            tmp.parent.mkdir(parents=True, exist_ok=True)
            np.savez(tmp, logits=merged, key=job_key)
            tmp.replace(partial_path)

        remaining = n - done
        eta = (Eta(remaining, "visual-feats", log_every=10 * self.batch_size)
               if verbose and remaining > 0 else None)
        chunks = [frame_paths[i:i + self.batch_size]
                  for i in range(done, n, self.batch_size)]
        truncated = False
        if max_frames is not None and max_frames < remaining:
            keep = max(1, max_frames // self.batch_size)
            if keep < len(chunks):
                chunks, truncated = chunks[:keep], True
        if not chunks:
            if partial_path:
                Path(partial_path).unlink(missing_ok=True)  # job complete
            return np.concatenate(out) if out else np.zeros((0, 8), np.float32)
        effective_every = max(checkpoint_every, len(chunks) // 20)
        with ThreadPoolExecutor(max_workers=1) as prefetcher:
            future = prefetcher.submit(self._decode, chunks[0])
            for ci, chunk in enumerate(chunks):
                batch = future.result()
                if ci + 1 < len(chunks):  # decode the next batch meanwhile
                    future = prefetcher.submit(self._decode, chunks[ci + 1])
                logits = self._forward(self._pad_batch(batch))
                out.append(logits[: len(chunk)].float().cpu().numpy())
                if eta:
                    eta.tick(len(chunk))
                if partial_path and (ci + 1) % effective_every == 0:
                    flush()
        if truncated:
            flush()  # bounded run: persist progress, leave the partial
            return None
        if partial_path:
            Path(partial_path).unlink(missing_ok=True)  # complete
        return np.concatenate(out)


def compute_visual_feats(imdb, model: Optional[nn.Module] = None,
                         state: Optional[Mapping[str, torch.Tensor]] = None,
                         model_name: str = "senet50-ferplus",
                         feat_path: Optional[str] = None,
                         batch_size: int = 128,
                         num_classes: int = 8,
                         seed: int = 0,
                         frame_root: str = "",
                         limit: Optional[int] = None,
                         crop_ratio: float = 1.0,
                         mesh=None,
                         clobber: bool = False,
                         input_size: int = 224,
                         max_frames_per_process: Optional[int] = None,
                         verbose: bool = True,
                         device: torch.device | str = "cuda"
                         ) -> List[np.ndarray]:
    """Per-track [F, C] teacher logits for a TrackImdb (``frame_paths``).

    ``model`` is a ``FaceTeacherPipeline`` and ``state`` its
    ``state_dict``; they run on ``device``, the card by default (without a
    CUDA device the default raises). ``model_name='random'`` emits gaussian
    logits (the null baseline). The cache at ``feat_path`` is the JAX
    package's format (``compute_audio_feats._save_feat_cache``), so either
    package reads the other's; with ``feat_path`` the dense pass is also
    resumable through ``<feat_path>.partial.npz``. ``clobber`` recomputes,
    overwrites the cache and discards a stale partial; ``limit`` caps the
    tracks of a dev run, which is never cached. ``mesh`` (multi-chip
    inference) and ``max_frames_per_process`` (bounded worker processes)
    are not ported and raise.
    """
    if mesh is not None:
        raise NotImplementedError("multi-card inference (mesh=) is not "
                                  "ported yet; see ROADMAP.md queue 1, item 15")
    if max_frames_per_process:
        raise NotImplementedError(
            "max_frames_per_process (exp/dense_chunked.py of the JAX package) "
            "is not ported: no leak that it works around has been measured "
            "on the card's host; see ROADMAP.md")
    if model_name != "random":
        resolve_device(device, "compute_visual_feats")
    if feat_path and Path(feat_path).exists() and not clobber:
        logits = _load_feat_cache(feat_path, len(imdb.frame_paths), model_name)
        if logits is not None:
            return logits
    if feat_path and clobber:
        Path(f"{feat_path}.partial.npz").unlink(missing_ok=True)
    tracks = imdb.frame_paths
    if limit:
        tracks = tracks[:limit]
    if model_name == "random":
        rng = np.random.RandomState(seed)
        logits = [rng.randn(len(t), num_classes).astype(np.float32)
                  for t in tracks]
    else:
        if model is None or state is None:
            raise ValueError(f"model {model_name!r} needs a model and its state")
        flat = [str(Path(frame_root) / p) for track in tracks for p in track]
        partial = f"{feat_path}.partial.npz" if feat_path else None
        extractor = VisualFeatureExtractor(model, state, batch_size=batch_size,
                                           crop_ratio=crop_ratio,
                                           input_size=input_size,
                                           device=device)
        all_logits = extractor.frame_logits(flat, verbose=verbose,
                                            partial_path=partial)
        logits, offset = [], 0
        for track in tracks:
            f = len(track)
            logits.append(all_logits[offset:offset + f])
            offset += f
    if feat_path and not limit:  # a limit= dev run is never cached
        _save_feat_cache(feat_path, logits, model_name)
    return logits
