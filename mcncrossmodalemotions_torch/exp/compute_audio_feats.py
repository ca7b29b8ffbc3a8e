"""Student feature extraction over full clips (``compute_audio_feats.m``).

Port of ``mcncrossmodalemotions_tpu/exp/compute_audio_feats.py``: per-track
student logits over every track of a dataset, with the same host pipeline
and the same bucketing:

- a header-only metadata pass groups tracks by (padded length ``t_pad``,
  duration bucket) and cuts each group into chunks of ``batch_size``;
- waveform reads run two chunks ahead of the device, through a C++ reader
  (fused packing to the feed's format) or the Python path for off-rate
  files; the rows (PCM16 by default, mu-law uint8 or float32 on request)
  go to the device through pinned memory. The C++ reader is the
  port's own ``csrc/dataservice_audio.cc`` (built with ``g++`` at first
  use; a failed build raises); the Python path reads every file only
  where ``MCNCME_DISABLE_NATIVE`` is set. Both give the same bits;
- on the device (the card unless the caller passes ``device="cpu"``):
  decode, spectrogram (the K1 kernel on the card), masked instance norm
  over the full clip, a centre crop to the bucket, and the student (whose
  pool1/pool2 run the K2 kernel) with every frame valid.

``model_name='random'`` gives gaussian logits (the null baseline,
compute_audio_feats.m:95-99). Results are cached at ``feat_path`` with the
model name and track count, and a cache written for another model or
imdb raises instead of being returned.
"""

from __future__ import annotations

import dataclasses
import sys
from pathlib import Path
from typing import Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch
from torch import nn
from torch.func import functional_call

from mcncrossmodalemotions_torch.data import native_audio
from mcncrossmodalemotions_torch.data.audio import (
    pack_mulaw8,
    pack_pcm16,
    read_wav,
    resample_to,
    wav_info,
)
from mcncrossmodalemotions_torch.data.imdb import float_tracks, object_array
from mcncrossmodalemotions_torch.ops.spectrogram import (
    DEFAULT_SPEC,
    SpecConfig,
    instance_norm,
    spectrogram,
)
from mcncrossmodalemotions_torch.ops.spectrogram_kernel import spectrogram_cuda
from mcncrossmodalemotions_torch.utils.device import resolve_device
from mcncrossmodalemotions_torch.utils.logging import Eta

# Restated from the JAX package (its modules import jax); a CPU test holds
# them equal.
MAX_CLIP_SECONDS = 19.9  # getBatchEmoVoxCeleb.m:84-88 (data/emovox.py)
BUCKET_WIDTHS = tuple(range(100, 1001, 100))  # frames (compute_audio_feats.m:45)
MAX_EVAL_FRAMES = 1990  # 19.9 s cap (getBatchEmoVoxCeleb.m:84-88)


def bucket_for(num_frames: int) -> int:
    """Largest bucket width <= num_frames (minimum 100)."""
    eligible = [w for w in BUCKET_WIDTHS if w <= num_frames]
    return eligible[-1] if eligible else BUCKET_WIDTHS[0]


def pad_frames_shape(num_frames: int) -> int:
    """Round up to a multiple of 100 (few distinct shapes), cap 19.9 s."""
    num_frames = min(num_frames, MAX_EVAL_FRAMES)
    return min(-(-num_frames // 100) * 100, 2000)


def _bucket_forward(model: nn.Module, state: Mapping[str, torch.Tensor],
                    specs: torch.Tensor, bucket: int, valid: torch.Tensor,
                    use_kernels: bool = True) -> torch.Tensor:
    """specs: [B, F, T_pad] raw magnitudes; masked norm over the full clip,
    centre crop to ``bucket`` frames, then the student with every frame
    of the crop valid."""
    normed = instance_norm(specs, valid_frames=valid)
    start = torch.clamp((valid - bucket) // 2, min=0)
    idx = start[:, None] + torch.arange(bucket, device=specs.device)[None, :]
    cropped = torch.gather(
        normed, 2, idx[:, None, :].expand(-1, normed.shape[1], -1))
    return functional_call(
        model, dict(state), (cropped[..., None],),
        {"valid_frames": torch.full_like(valid, bucket),
         "use_kernels": use_kernels}, strict=True)


def wav_reader():
    """The port's C++ wav reader (built at first use; a failed build
    raises), or None, the Python reads, where ``MCNCME_DISABLE_NATIVE`` is
    set."""
    return native_audio if native_audio.available() else None


@dataclasses.dataclass
class AudioFeatureExtractor:
    """Batched bucketed student inference with a threaded host pipeline.

    ``model`` is a bare ``VGGMStudent``; ``state`` its ``state_dict``
    (``zoo/bridge.py``) on any device. ``state`` is copied to ``device``,
    the card unless the caller asks for ``"cpu"``; without a CUDA device
    the default raises rather than running on the CPU. The forward is a
    ``functional_call`` with ``state`` for every parameter and buffer, so
    ``model``'s own tensors are never read and it stays where the caller
    keeps it. With ``use_kernels``
    (the default) the spectrogram and pool1/pool2 go through their
    kernels on the card; False runs their plain versions (the comparison
    run). On the CPU both run the plain versions. The feed is the JAX
    extractor's: rows ship as PCM16 (``emit_int16``, the default), half the
    host-to-device bytes of fp32; per-track peak normalisation is neutral,
    since the spectrogram is linear in the waveform and instance norm
    divides any per-track scale back out. ``emit_mulaw`` ships mu-law uint8
    instead (``data/audio.pack_mulaw8``, a quarter of fp32's bytes; its
    ~38 dB SNR moves the logits slightly), and with both off the rows ship
    as float32. The frontend takes each as it comes (``decode_pcm``).
    ``readers`` records which host reader each chunk took:
    ``native-packed``, ``native`` or ``python``.
    """

    model: nn.Module
    state: Mapping[str, torch.Tensor]
    spec: SpecConfig = DEFAULT_SPEC
    batch_size: int = 64
    use_kernels: bool = True
    num_threads: int = 8
    device: torch.device | str = "cuda"
    emit_int16: bool = True
    emit_mulaw: bool = False
    readers: set = dataclasses.field(default_factory=set)

    # -- host side ----------------------------------------------------------
    def _meta(self, path: str):
        """(t, bucket, t_pad, native_fs, num_samples) from headers only."""
        cfg = self.spec
        info = wav_info(path)
        n16 = info.num_samples
        if info.sample_rate != cfg.sample_rate:
            n16 = int(round(n16 * cfg.sample_rate / info.sample_rate))
        n16 = min(n16, int(MAX_CLIP_SECONDS * cfg.sample_rate))
        t = max(cfg.num_frames(n16), 1)
        t = min(t, MAX_EVAL_FRAMES)
        t_pad = pad_frames_shape(t)
        return t, bucket_for(t), t_pad, info.sample_rate, info.num_samples

    def _load_one(self, path: str, need: int) -> np.ndarray:
        """Python read path (off-rate files): full read + resample + pad."""
        cfg = self.spec
        samples, fs = read_wav(path)
        if fs != cfg.sample_rate:
            samples = resample_to(samples, fs, cfg.sample_rate)
        cap = int(MAX_CLIP_SECONDS * cfg.sample_rate)
        samples = samples[:cap]
        if len(samples) < need:
            samples = np.pad(samples, (0, need - len(samples)))
        return samples[:need].astype(np.float32)

    def _submit_chunk(self, pool, chunk, t_pad: int):
        """Start all of a chunk's reads; returns a join() closure."""
        cfg = self.spec
        need = cfg.crop_samples(t_pad)
        cap = int(MAX_CLIP_SECONDS * cfg.sample_rate)
        reader = wav_reader()
        fast, fast_rows, slow_futs = [], [], {}
        for row, (_, path, meta) in enumerate(chunk):
            if reader is not None and meta[3] == cfg.sample_rate:
                fast.append(path)
                fast_rows.append(row)
            else:
                slow_futs[row] = pool.submit(self._load_one, path, need)
        # The fused read+pack computes each row's peak over everything it
        # reads, so it is only taken when no 19.9 s cap truncation applies.
        fmt = self._feed_format()
        packed = (fmt is not None and not slow_futs and bool(fast)
                  and need <= cap)
        fast_fut = None
        if fast:
            if packed:
                fast_fut = pool.submit(reader.read_crops_packed, fast,
                                       [0] * len(fast), need,
                                       self.num_threads, fmt=fmt)
            else:
                fast_fut = pool.submit(reader.read_crops, fast,
                                       [0] * len(fast), need, self.num_threads)
            self.readers.add("native-packed" if packed else "native")
        if slow_futs:
            self.readers.add("python")

        def join() -> np.ndarray:
            if packed:
                return fast_fut.result()
            waves = np.zeros((len(chunk), need), np.float32)
            if fast_fut is not None:
                block = fast_fut.result()
                if need > cap:  # 19.9 s cap: zero anything read past it
                    block[:, cap:] = 0.0
                for k, row in enumerate(fast_rows):
                    waves[row] = block[k]
            for row, fut in slow_futs.items():
                waves[row] = fut.result()
            return waves

        return join

    def _feed_format(self) -> Optional[str]:
        """The packed format of the rows shipped, None for float32."""
        return ("mulaw8" if self.emit_mulaw
                else "int16" if self.emit_int16 else None)

    def _to_device(self, waves: np.ndarray, device: torch.device) -> torch.Tensor:
        host = torch.from_numpy(waves)
        if device.type != "cuda":
            return host
        return host.pin_memory().to(device, non_blocking=True)

    # -- main loop ----------------------------------------------------------
    def track_logits(self, wav_paths: Sequence[str],
                     verbose: bool = True) -> List[np.ndarray]:
        """Per-track [1, C] logits over the bucketed full clip."""
        from concurrent.futures import ThreadPoolExecutor

        cfg = self.spec
        device = resolve_device(self.device, "feature extraction")
        state = {k: v.to(device) for k, v in self.state.items()}
        eta = Eta(len(wav_paths), "audio-feats", log_every=200) if verbose else None
        out: List[Optional[np.ndarray]] = [None] * len(wav_paths)
        with ThreadPoolExecutor(self.num_threads) as pool, torch.inference_mode():
            metas = list(pool.map(self._meta, wav_paths))
            groups: Dict[tuple, list] = {}
            for i, (path, meta) in enumerate(zip(wav_paths, metas)):
                groups.setdefault((meta[2], meta[1]), []).append((i, path, meta))
            chunks = []  # (t_pad, bucket, [(idx, path, meta), ...])
            for (t_pad, bucket), group in sorted(groups.items()):
                for k in range(0, len(group), self.batch_size):
                    chunks.append((t_pad, bucket, group[k:k + self.batch_size]))
            # chunk k+2's reads start before chunk k's logits are fetched
            lookahead = 2
            joins = [self._submit_chunk(pool, c[2], c[0])
                     for c in chunks[:lookahead]]
            for ci, (t_pad, bucket, chunk) in enumerate(chunks):
                waves = joins[ci]()
                if ci + lookahead < len(chunks):
                    nxt = chunks[ci + lookahead]
                    joins.append(self._submit_chunk(pool, nxt[2], nxt[0]))
                if waves.dtype == np.float32:  # packed chunks arrive ready
                    if self.emit_mulaw:
                        waves = pack_mulaw8(waves)
                    elif self.emit_int16:
                        waves = pack_pcm16(waves)
                x = self._to_device(waves, device)
                valid = torch.tensor([c[2][0] for c in chunk], device=device)
                specs = (spectrogram_cuda(x, cfg) if self.use_kernels
                         else spectrogram(x, cfg))
                logits = _bucket_forward(self.model, state, specs, bucket,
                                         valid, self.use_kernels)
                logits = logits.cpu().numpy()
                for (idx, _, _), row_logits in zip(chunk, logits):
                    out[idx] = row_logits[None, :]  # [1, C] per track
                    if eta:
                        eta.tick()
        if verbose:
            print(f"[audio-feats] host reader: {', '.join(sorted(self.readers))}",
                  file=sys.stderr, flush=True)
        return out  # type: ignore[return-value]


def compute_audio_feats(imdb, model: Optional[nn.Module] = None,
                        state: Optional[Mapping[str, torch.Tensor]] = None,
                        model_name: str = "emovoxceleb-student",
                        feat_path: Optional[str] = None,
                        batch_size: int = 64,
                        num_classes: int = 8,
                        seed: int = 0,
                        limit: Optional[int] = None,
                        clobber: bool = False,
                        use_kernels: bool = True,
                        verbose: bool = True,
                        device: torch.device | str = "cuda") -> List[np.ndarray]:
    """Per-track student logits for a TrackImdb/EmoVoxImdb.

    The model and ``state`` (on any device) run on ``device``: the card by
    default, the CPU only when the caller passes ``device="cpu"``; without
    a CUDA device the default raises.
    ``model_name='random'`` emits gaussian logits. Results are cached at
    ``feat_path``; ``clobber`` recomputes and overwrites. ``limit`` (a dev
    run) neither reads nor writes the cache.
    """
    if feat_path and Path(feat_path).exists() and not clobber and not limit:
        logits = _load_feat_cache(feat_path, len(imdb.wav_paths), model_name)
        if logits is not None:
            return logits
    wav_dir = getattr(imdb, "wav_dir", "")
    paths = [str(Path(wav_dir) / p) for p in imdb.wav_paths]
    if limit:
        paths = paths[:limit]
    if model_name == "random":
        rng = np.random.RandomState(seed)
        logits = [rng.randn(1, num_classes).astype(np.float32) for _ in paths]
    else:
        if model is None or state is None:
            raise ValueError(f"model {model_name!r} needs a model and its state")
        extractor = AudioFeatureExtractor(model, state, batch_size=batch_size,
                                          use_kernels=use_kernels,
                                          device=device)
        logits = extractor.track_logits(paths, verbose=verbose)
    if feat_path and not limit:
        _save_feat_cache(feat_path, logits, model_name)
    return logits


def _load_feat_cache(feat_path, expected_tracks: int, model_name: str):
    """Finished-cache load with identity checks. Returns None only for a
    legacy cache (no model name) whose track count does not match;
    wrong-model or wrong-count caches raise."""
    data = np.load(feat_path, allow_pickle=True)
    cached_model = str(data["model_name"]) if "model_name" in data else None
    logits = float_tracks(data["logits"])
    if cached_model is not None and cached_model != model_name:
        raise ValueError(
            f"{feat_path}: cached features are from model "
            f"{cached_model!r}, not {model_name!r} — use a per-model "
            "feat_path or clobber=True")
    if len(logits) != expected_tracks:
        if cached_model is None:
            return None
        raise ValueError(
            f"{feat_path}: cache holds {len(logits)} tracks but the imdb "
            f"has {expected_tracks} — stale cache for a different imdb; "
            "delete it or pass clobber=True")
    return logits


def _save_feat_cache(feat_path, logits, model_name: str) -> None:
    Path(feat_path).parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(feat_path, logits=object_array(logits),
                        model_name=np.asarray(model_name))
