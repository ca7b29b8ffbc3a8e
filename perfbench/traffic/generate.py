"""The one traffic generator: a mix (``mixes/<name>.json``) names its
``kind`` and parameters, and ``generate`` makes its files from the seed.

Every seed gets the same set of sizes (durations, image sizes), in an
order the seed draws, so that two seeds ask for the same work; only the
content differs. Kinds:

- ``wav_tracks``: ``tracks`` mono 16 kHz PCM16 tracks whose durations
  follow an exponential tail above ``min_s`` with mean ``mean_s``, capped
  at ``max_s`` (VoxCeleb1's published 4 s minimum and 8.2 s mean), each a
  tone with a slow envelope plus noise, and a ``[F, emotions]`` array of
  cached teacher logits (one row every ``logit_stride`` frames at
  ``logit_fps``) whose dominant emotion sets the tone; with ``distinct``
  (default ``tracks``) that many recordings are written, each under
  ``tracks / distinct`` names (hard links: the names are read as files of
  their own, the disk holds each recording once), every name with
  logits of its own;
- ``jpeg_frames``: ``frames`` square gray JPEGs of side ``size`` at
  quality 92 (``jpeg.py``), ``distinct`` different images each written
  ``frames / distinct`` times under other names;
- ``ferplus_faces``: ``images`` 48x48 gray faces in memory with 10-column
  rater votes (8 emotions, unknown, NF), FER2013's training count.

Waveforms are synthesised on the card where there is one, in blocks, and
written from the host; the device's peak is reset by the caller after.
"""

from __future__ import annotations

import dataclasses
import json
import os
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import List, Optional

import numpy as np

from perfbench.traffic import jpeg
from perfbench.traffic.wav import write_pcm16

MIXES = Path(__file__).resolve().parent / "mixes"
_STREAMS = {"order": 1, "content": 2, "logits": 3, "wave": 4, "pixels": 5}


def load_mix(name: str) -> dict:
    """The parameters of traffic mix ``name``."""
    path = MIXES / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no traffic mix {name!r} ({path})")
    return json.loads(path.read_text())


def stream_rng(seed: int, stream: str) -> np.random.Generator:
    """An independent numpy generator per (seed, stream); any integer seed."""
    return np.random.default_rng(
        np.random.SeedSequence([seed & 0xFFFFFFFFFFFFFFFF, _STREAMS[stream]]))


def torch_seed(seed: int, stream: str) -> int:
    """A 63-bit seed for a ``torch.Generator`` per (seed, stream)."""
    return int(stream_rng(seed, stream).integers(0, 2 ** 63 - 1))


def durations(mix: dict) -> np.ndarray:
    """The mix's recordings' durations (seconds), the same for every seed:
    the mid-quantiles of ``min_s`` + an exponential of mean ``mean_s -
    min_s``, capped at ``max_s``, longest first."""
    n = int(mix.get("distinct", mix["tracks"]))
    q = (np.arange(n) + 0.5) / n
    d = mix["min_s"] - (mix["mean_s"] - mix["min_s"]) * np.log1p(-q)
    return np.minimum(d, mix["max_s"])[::-1].copy()


@dataclasses.dataclass
class WavTracks:
    """The files and cached logits of a ``wav_tracks`` mix."""

    root: Path
    rel_paths: List[str]
    num_samples: np.ndarray   # [N] samples in each file
    durations: np.ndarray     # [N] seconds
    logits: List[np.ndarray]  # per track [F, emotions] float32
    emotion: np.ndarray       # [N] the dominant emotion
    sample_rate: int
    bytes_written: int        # the distinct recordings' bytes

    def paths(self) -> List[str]:
        return [str(self.root / p) for p in self.rel_paths]


def _synthesise(num_samples: np.ndarray, emotion: np.ndarray,
                phase: np.ndarray, sample_rate: int, seed: int, device):
    """Yield (track index, int16 samples) for every track: 0.5 sin(2 pi f
    t + phase) x (0.3 + 0.7 (0.5 + 0.5 sin(2 pi r t))) + 0.05 noise, f =
    200 + 150 e Hz and r = 0.8 + 0.35 e Hz for emotion e; peak under 1, so
    a PCM16 row of it is the file's samples. Made in blocks of about 32M
    samples on ``device``."""
    import torch

    gen = torch.Generator(device=device).manual_seed(torch_seed(seed, "wave"))
    order = np.arange(len(num_samples))
    block, start = [], 0
    budget = 1 << 25
    while start < len(order):
        stop, total = start, 0
        while stop < len(order) and (total == 0 or total + num_samples[stop] <= budget):
            total += int(num_samples[stop])
            stop += 1
        idx = order[start:stop]
        lens = torch.as_tensor(num_samples[idx], device=device)
        which = torch.repeat_interleave(torch.arange(len(idx), device=device), lens)
        offs = torch.cumsum(lens, 0) - lens
        t = (torch.arange(total, device=device) - offs[which]).float() / sample_rate
        e = torch.as_tensor(emotion[idx], dtype=torch.float32, device=device)[which]
        ph = torch.as_tensor(phase[idx], dtype=torch.float32, device=device)[which]
        tone = torch.sin(2 * np.pi * (200.0 + 150.0 * e) * t + ph)
        env = 0.3 + 0.7 * (0.5 + 0.5 * torch.sin(2 * np.pi * (0.8 + 0.35 * e) * t))
        noise = torch.randn(total, generator=gen, device=device)
        wave = 0.5 * tone * env + 0.05 * noise.clamp(-8.0, 8.0)
        pcm = torch.round(wave * 32768.0).clamp(-32768, 32767).to(torch.int16)
        pcm = pcm.cpu().numpy()
        cuts = np.cumsum(num_samples[idx])[:-1]
        for k, part in zip(idx, np.split(pcm, cuts)):
            yield int(k), part
        start = stop


def wav_tracks(mix: dict, seed: int, root: Path, device="cpu",
               overrides: Optional[dict] = None) -> WavTracks:
    """Write a ``wav_tracks`` mix under ``root`` for ``seed``."""
    mix = dict(mix, **(overrides or {}))
    rate = int(mix["sample_rate"])
    tracks = int(mix["tracks"])
    distinct = int(mix.get("distinct", tracks))
    if tracks % distinct:
        raise ValueError("tracks must be a multiple of distinct")
    order = stream_rng(seed, "order")
    dur = durations(mix)[order.permutation(distinct)]
    # name i holds recording source[i]; every recording has tracks / distinct names
    source = (order.permutation(np.arange(tracks) % distinct) if distinct < tracks
              else np.arange(tracks))
    n = np.round(dur * rate).astype(np.int64)
    content = stream_rng(seed, "content")
    emotion = content.integers(0, mix["emotions"], distinct)
    phase = content.uniform(0, 2 * np.pi, distinct)
    rel = [f"spk{i // 64:03d}/track{i % 64:03d}.wav" for i in range(tracks)]
    first = np.full(distinct, -1)
    for i, k in enumerate(source):
        if first[k] < 0:
            first[k] = i
    with ThreadPoolExecutor(4) as pool:
        futs = [pool.submit(write_pcm16, root / rel[first[k]], pcm, rate)
                for k, pcm in _synthesise(n, emotion, phase, rate, seed, device)]
        for f in futs:
            f.result()
    for i, k in enumerate(source):
        if i != first[k]:
            (root / rel[i]).parent.mkdir(parents=True, exist_ok=True)
            os.link(root / rel[first[k]], root / rel[i])
    os.sync()  # no write-back of these files inside the window
    lg = stream_rng(seed, "logits")
    logits = []
    for k in source:
        f = max(int(dur[k] * mix["logit_fps"] / mix["logit_stride"]), 1)
        row = (lg.standard_normal((f, mix["emotions"])) * 0.3).astype(np.float32)
        row[:, emotion[k]] += mix["logit_gap"]
        logits.append(row)
    return WavTracks(root=root, rel_paths=rel, num_samples=n[source], durations=dur[source],
                     logits=logits, emotion=emotion[source], sample_rate=rate,
                     bytes_written=int(n.sum() * 2 + 44 * distinct))


@dataclasses.dataclass
class JpegFrames:
    """The files of a ``jpeg_frames`` mix: ``pixels[source[i]]`` is the
    image written to ``paths[i]``."""

    paths: List[str]
    pixels: np.ndarray   # [distinct, S, S] uint8
    source: np.ndarray   # [frames] index into pixels
    bytes_written: int


def jpeg_frames(mix: dict, seed: int, root: Path,
                overrides: Optional[dict] = None) -> JpegFrames:
    """Encode ``distinct`` seed-made gray images (``synthetic_frame_pixels``
    patterns) and write each under ``frames / distinct`` names."""
    mix = dict(mix, **(overrides or {}))
    frames, distinct, size = int(mix["frames"]), int(mix["distinct"]), int(mix["size"])
    if frames % distinct:
        raise ValueError("frames must be a multiple of distinct")
    content = stream_rng(seed, "pixels")
    patterns = content.integers(0, 8, distinct)
    seeds = content.integers(0, 2 ** 31 - 1, distinct)
    pixels = np.stack([jpeg.synthetic_frame_pixels(int(p), size, int(s))
                       for p, s in zip(patterns, seeds)])
    with ThreadPoolExecutor(8) as pool:
        blobs = list(pool.map(jpeg.encode_jpeg, pixels))
    source = stream_rng(seed, "order").permutation(np.arange(frames) % distinct)
    paths = [str(root / f"frames/{i // 256:03d}/{i % 256:04d}.jpg")
             for i in range(frames)]
    for d in {Path(p).parent for p in paths}:
        d.mkdir(parents=True, exist_ok=True)
    for p, k in zip(paths, source):
        Path(p).write_bytes(blobs[k])
    os.sync()  # no write-back of these files inside the window
    return JpegFrames(paths=paths, pixels=pixels, source=source,
                      bytes_written=sum(len(blobs[k]) for k in source))


@dataclasses.dataclass
class FerFaces:
    """A ``ferplus_faces`` mix in memory."""

    data: np.ndarray   # [N, 48, 48, 1] uint8
    votes: np.ndarray  # [N, 10] float32 (8 emotions, unknown, NF)


def ferplus_faces(mix: dict, seed: int,
                  overrides: Optional[dict] = None) -> FerFaces:
    """``images`` gray faces: a per-emotion gradient pattern plus noise
    (the port's synthetic FER+ maker's recipe), with ten raters' votes
    that favour that emotion."""
    mix = dict(mix, **(overrides or {}))
    n, size = int(mix["images"]), int(mix["size"])
    rng = stream_rng(seed, "content")
    labels = rng.integers(0, 8, n)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    base = np.stack([127 + 120 * np.sin(2 * np.pi * (k + 1) * (xx + (k % 3) * yy)
                                        / (8 * size)) for k in range(8)])
    noise = rng.standard_normal((n, size, size), dtype=np.float32) * 10
    data = np.clip(base[labels] + noise, 0, 255).astype(np.uint8)[..., None]
    votes = np.zeros((n, 10), np.float32)
    votes[np.arange(n), labels] = 7 + rng.integers(0, 3, n)
    votes[np.arange(n), rng.integers(0, 8, n)] += 2
    votes[np.arange(n), 8 + rng.integers(0, 2, n)] += rng.integers(0, 2, n)
    return FerFaces(data=data, votes=votes)
