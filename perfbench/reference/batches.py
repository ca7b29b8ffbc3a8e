"""The distillation batches as ``getBatchEmoVoxCeleb`` defines them, worked
out again from the benchmark's files: per (seed, epoch) a shuffle of the
tracks and, in that order, one random crop start a track (no draw where
the track is no longer than the crop), from numpy ``RandomState``s seeded
by ``SeedSequence([seed, epoch, stream])`` (``stream`` the little-endian
integer of ``b"shuffle"`` or ``b"augment"``); crops of ``crop_samples``
read from the file at that start and zero-padded; the target the max over
the crop's teacher-logit frames (frame index floor(max(t fps - 1, 0) /
stride), clipped to the track's frames)."""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

from perfbench.traffic.wav import read_pcm16


def _rng(seed: int, epoch: int, stream: str) -> np.random.RandomState:
    if seed < 0:
        seed &= 0xFFFFFFFFFFFFFFFF
    ss = np.random.SeedSequence(
        [seed, epoch, int.from_bytes(stream.encode(), "little")])
    return np.random.RandomState(ss.generate_state(4))


def _logit_idx(t: float, frames: int, fps: float, stride: int) -> int:
    idx = int(np.floor(max(t * fps - 1.0, 0.0) / stride))
    return int(np.clip(idx, 0, max(frames - 1, 0)))


def epoch_batches(cfg: dict, paths: Sequence[str], num_samples: Sequence[int],
                  logits: Sequence[np.ndarray], seed: int, epoch: int,
                  batch_size: int, count: int) -> List[dict]:
    """The first ``count`` batches of ``epoch``: ``pcm`` [B, crop] int16 and
    ``teacher`` [B, C] float32 (numpy)."""
    fs = cfg["spectrogram"]["sample_rate"]
    need = int(round((cfg["spectrogram"]["hop_ms"] / 1000 * cfg["crop_frames"]
                      + (cfg["spectrogram"]["window_ms"] - 1) / 1000) * fs))
    order = _rng(seed, epoch, "shuffle").permutation(len(paths))
    rng = _rng(seed, epoch, "augment")
    out = []
    for b in range(count):
        pcm = np.zeros((batch_size, need), np.int16)
        teacher = []
        for row, j in enumerate(order[b * batch_size:(b + 1) * batch_size]):
            total = min(int(num_samples[j]), int(cfg["max_clip_seconds"] * fs))
            max_start = max(total - need, 0)
            start = int(rng.randint(0, max_start + 1)) if max_start > 0 else 0
            samples, _ = read_pcm16(paths[j], start, min(need, total - start))
            pcm[row, :len(samples)] = samples
            t0 = start / fs
            lg = logits[j]
            i0 = _logit_idx(t0, len(lg), cfg["logit_fps"], cfg["logit_stride"])
            i1 = max(_logit_idx(t0 + cfg["crop_seconds"], len(lg), cfg["logit_fps"],
                                cfg["logit_stride"]) + 1, i0 + 1)
            teacher.append(lg[i0:i1].max(axis=0)[:cfg["num_outputs"]])
        out.append({"pcm": pcm, "teacher": np.stack(teacher).astype(np.float32)})
    return out
