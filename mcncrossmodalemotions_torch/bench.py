"""Distillation training throughput benchmark of the port, on the card.

Port of the repository's ``bench.py`` (which drives the JAX package):
the same sub-benchmarks, sizes, seeds, batches and output keys, measured
through ``mcncrossmodalemotions_torch`` on a CUDA device::

    python -m mcncrossmodalemotions_torch.bench              # headline + numerics + frontend
    python -m mcncrossmodalemotions_torch.bench --full       # + end-to-end epochs, teacher,
                                                             #   fused, dense, audio-feats
    python -m mcncrossmodalemotions_torch.bench --quick      # headline only
    python -m mcncrossmodalemotions_torch.bench --out-dir DIR --device cpu

or ``python -m mcncrossmodalemotions_torch.cli bench [--full|--quick]``.

Headline (the last stdout line): steady-state utts/s of the full student
distillation train step (frontend with K1, VGG-M forward and backward
with K2, hot-cross-ent at T=2, SGD) at float32 ``[128, 64384]`` on a
batch that stays on the card.

The details merge-update ``<out-dir>/bench_details.json`` (default
``build/bench/``) and one row per run is appended to
``<out-dir>/bench_history.jsonl``; the repository root's files of those
names are the JAX package's records and are never written here.

Unlike ``bench.py``, nothing is skipped quietly: every sub-benchmark
runs, the headline line is printed, and the exit code is 1 when a
sub-benchmark, an end-to-end worker, a reader build or the numerics gate
failed (named on stderr); 2 without a CUDA device unless the caller asks
for ``device="cpu"``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Callable, Optional

import numpy as np

# dense bf16 peak TFLOP/s by torch.cuda.get_device_name() (NVIDIA's data
# sheet, SXM part, at its 700 W limit); a card not named here gets no
# mfu_estimate
_PEAK_TFLOPS = {"NVIDIA H100 80GB HBM3": 989.0}

MODULE = "mcncrossmodalemotions_torch.bench"
DEFAULT_OUT_DIR = Path(__file__).resolve().parents[1] / "build" / "bench"
WORKER_TIMEOUT_S = 1800
QUEUE_CYCLES = 100_000_000  # ~50 ms of device sleep ahead of timed calls

# the end-to-end workers' fields -> details keys, per worker flag (the
# int16/mulaw8 names predate the online worker; bench.py's names)
E2E_KEYMAPS = {
    "int16": {"utts_per_sec": "end_to_end_epoch_utts_per_sec",
              "num_samples": "end_to_end_epoch_samples",
              "feed_bound_frac": "end_to_end_feed_bound_frac",
              "feed_bytes_per_utt": "end_to_end_feed_bytes_per_utt"},
    "mulaw8": {"utts_per_sec": "end_to_end_epoch_utts_per_sec_mulaw8",
               "num_samples": "end_to_end_epoch_samples_mulaw8",
               "feed_bound_frac": "end_to_end_feed_bound_frac_mulaw8",
               "feed_bytes_per_utt": "end_to_end_feed_bytes_per_utt_mulaw8"},
    "online": {"utts_per_sec": "online_epoch_utts_per_sec",
               "num_samples": "online_epoch_samples",
               "feed_bound_frac": "online_epoch_feed_bound_frac",
               "feed_bytes_per_utt": "online_epoch_feed_bytes_per_utt",
               "frames_per_crop": "online_epoch_frames_per_crop"},
}


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _best_of(fn: Callable, sync: Callable, iters: int = 20,
             reps: int = 3) -> float:
    """Seconds a call: the best of ``reps`` windows of ``iters`` calls
    after one warm-up call, each window ended by ``sync``."""
    fn()
    sync()
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        sync()
        best = min(best, (time.perf_counter() - t0) / iters)
    return best


def _device(device):
    from mcncrossmodalemotions_torch.utils.device import resolve_device

    return resolve_device(device, "the bench")


def cuda_ms(fn, iters: int = 20, warmup: int = 3,
            cycles: int = QUEUE_CYCLES) -> float:
    """Mean device milliseconds per call, CUDA events around ``iters`` calls.

    The calls are queued behind a device-side sleep of ``cycles``, so they
    run back to back on the card: a call shorter than the host's cost of
    issuing it (a kernel launched through ctypes costs the host 40-70 us)
    is timed on the device, not at the host's pace."""
    import torch

    for _ in range(warmup):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    torch.cuda._sleep(cycles)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, device, iters: int = 10) -> float:
    """Milliseconds a call of ``fn`` on ``device``: ``cuda_ms`` on a CUDA
    device; on the CPU (a rehearsal) the host's ``_best_of``."""
    import torch

    if torch.device(device).type == "cuda":
        return cuda_ms(fn, iters)
    return _best_of(fn, lambda: None, iters=iters) * 1000


def train_step_setup(device="cuda", batch_size: int = 128,
                     num_frames: int = 400, tiny: bool = False,
                     int16_rows: bool = False, pad_mask: bool = False,
                     conv1_s2d: bool = False,
                     remat_policy: Optional[str] = None) -> tuple:
    """(step, state, batch) of the headline's train step on ``device``:
    the full student (``build_student("emovoxceleb-student")``'s pipeline,
    seed 0, its conv1 as ``conv1_s2d`` asks) on float32 randn ``[128,
    64384]`` rows (seed 0), hot-cross-ent at T=2, SGD without weight decay,
    under ``remat_policy``. ``int16_rows`` feeds the same rows as int16 PCM
    (x 0.1 full scale) and ``pad_mask`` adds an all-ones ``pad_mask`` that
    the step passes to the student (its masked BatchNorm branch), as
    ``run_distillation``'s steps do; the headline uses neither, as
    ``bench.py``'s step does."""
    import torch

    from mcncrossmodalemotions_torch.models.pipeline import (
        AudioStudentPipeline,
    )
    from mcncrossmodalemotions_torch.ops.spectrogram import DEFAULT_SPEC
    from mcncrossmodalemotions_torch.train.state import (
        SGDConfig,
        TrainState,
        make_train_step,
    )
    from mcncrossmodalemotions_torch.zoo import student_loss_fn

    dev = _device(device)
    crop = DEFAULT_SPEC.crop_samples(num_frames)  # 4 s = 64,384 samples
    rng = np.random.RandomState(0)
    rows = rng.randn(batch_size, crop).astype(np.float32)
    if int16_rows:
        rows = np.clip(np.round(rows * 0.1 * 32767), -32768, 32767).astype(
            np.int16)
    batch = {
        "data": torch.from_numpy(rows).to(dev),
        "logit_target": torch.from_numpy(
            rng.randn(batch_size, 8).astype(np.float32) * 2).to(dev),
        "max_label": torch.from_numpy(rng.randint(0, 8, batch_size)).to(dev),
    }
    if pad_mask:
        batch["pad_mask"] = torch.ones(batch_size, device=dev)
    widths = dict(fc6_features=64, fc7_features=32) if tiny else {}
    model = AudioStudentPipeline(conv1_s2d=conv1_s2d,
                                 generator=torch.Generator().manual_seed(0),
                                 **widths)
    state = TrainState.create(model.to(dev),
                              torch.Generator(device=dev).manual_seed(1))
    step = make_train_step(student_loss_fn("hot-cross-ent", temperature=2.0),
                           SGDConfig(weight_decay=0.0), pass_pad_mask=pad_mask,
                           remat_policy=remat_policy)
    return step, state, batch


def bench_train_step(details: dict, device="cuda", batch_size: int = 128,
                     num_frames: int = 400, tiny: bool = False,
                     iters: int = 20, **forms) -> float:
    """Headline: the full distillation train step on a batch on the card
    (``train_step_setup``: float32 randn ``[128, 64384]``, seed 0: K1's
    ``spectrogram_f32``, and K2's with-index forward and backward twice a
    step). Returns utts/s. ``forms`` (``int16_rows``, ``pad_mask``,
    ``conv1_s2d``, ``remat_policy``) go to ``train_step_setup``; the
    headline uses none of them (``tools/step_variants.py`` times the rows'
    and the mask's forms side by side, ``tools/ab_step_conv1.py`` and
    ``probe_masked_bn.py`` conv1's and the mask's one form a process).

    ``train_step_flops`` is counted by ``torch.utils.flop_counter.
    FlopCounterMode`` over one step: convolutions and matrix products
    only (the hand-written kernels, BatchNorm and elementwise passes
    count nothing), where ``bench.py``'s XLA ``cost_analysis`` counts
    every op, so the two packages' FLOP and MFU fields differ in scope.
    """
    from torch.utils.flop_counter import FlopCounterMode

    step, state, batch = train_step_setup(device, batch_size, num_frames,
                                          tiny, **forms)
    dev = batch["data"].device
    with FlopCounterMode(display=False) as counter:
        step(state, batch, 1e-4)
    flops = float(counter.get_total_flops())

    sec = _best_of(lambda: step(state, batch, 1e-4), lambda: _sync(dev),
                   iters=iters)
    utts = batch_size / sec
    details["train_step_ms"] = round(sec * 1000, 3)
    details["train_step_utts_per_sec"] = round(utts, 2)
    details["train_step_flops"] = flops
    details["achieved_tflops"] = round(flops / sec / 1e12, 2)
    kind = details.get("device_kind")
    peak = _PEAK_TFLOPS.get(kind)
    if peak:
        details["mfu_estimate"] = round(flops / sec / 1e12 / peak, 4)
        _log(f"MFU: {details['mfu_estimate']:.1%} "
             f"({details['achieved_tflops']} TFLOP/s of {peak} peak bf16 on "
             f"{kind}; convolutions and matrix products only)")
    return utts


def _epochs(trainer, batcher) -> tuple:
    """Epoch 1 warms; the best of epochs 2-3 (samples/s) is measured."""
    state = trainer.init_state()
    state, _ = trainer.run_epoch(state, batcher.batches(epoch=1), 1, True)
    best = None
    for ep in (2, 3):
        state, stats = trainer.run_epoch(state, batcher.batches(epoch=ep),
                                         ep, True)
        if best is None or stats["samples_per_sec"] > best["samples_per_sec"]:
            best = stats
    return best


def _feed_bytes_per_utt(example: dict, batch_size: int) -> int:
    """Bytes the host ships per utterance for this feed format."""
    return int(sum(np.asarray(v).nbytes for v in example.values())
               / batch_size)


def _trainer(student, root: Path, device, **kw):
    from mcncrossmodalemotions_torch.train.engine import TrainConfig, Trainer
    from mcncrossmodalemotions_torch.zoo import student_loss_fn

    return Trainer(
        student, student_loss_fn("hot-cross-ent", temperature=2.0),
        TrainConfig(num_epochs=3, learning_rate=1e-4, weight_decay=0.0,
                    log_every=10_000, resume=False,
                    exp_dir=str(root / "exp")), device=device, **kw)


def _e2e_epoch_worker(emit_mulaw: bool, device="cuda", num_speakers: int = 8,
                      tracks_per_speaker: int = 64, batch_size: int = 64,
                      tiny: bool = False) -> dict:
    """One offline feed format's end-to-end epoch (in a fresh process, as
    ``bench.py``'s: the int16 or mu-law uint8 crops read by the port's wav
    library from a synthetic on-disk imdb, the engine's prefetch, the
    train step); 512 utterances an epoch at the defaults."""
    from mcncrossmodalemotions_torch.data.emovox import (
        BatchConfig,
        EmoVoxBatcher,
        build_synthetic_imdb,
    )
    from mcncrossmodalemotions_torch.zoo import build_student

    dev = _device(device)
    with tempfile.TemporaryDirectory(prefix="bench_e2e_") as tmp:
        root = Path(tmp)
        imdb = build_synthetic_imdb(root / "wavs", num_speakers=num_speakers,
                                    tracks_per_speaker=tracks_per_speaker,
                                    duration_range=(4.2, 6.0))
        cfg = BatchConfig(batch_size=batch_size, emit_mulaw=emit_mulaw)
        batcher = EmoVoxBatcher(imdb, cfg, train=True, seed=0)
        trainer = _trainer(build_student("emovoxceleb-student", tiny=tiny),
                           root, dev)
        example = next(iter(batcher.batches(epoch=1, epoch_size=batch_size)))
        best = _epochs(trainer, batcher)
    return {"utts_per_sec": round(best["samples_per_sec"], 2),
            "num_samples": best["num_samples"],
            "feed_bound_frac": best.get("feed_bound_frac"),
            "feed_bytes_per_utt": _feed_bytes_per_utt(example, batch_size)}


def _online_epoch_worker(device="cuda", num_speakers: int = 8,
                         tracks_per_speaker: int = 64, batch_size: int = 64,
                         frames_per_crop: int = 2, tiny: bool = False) -> dict:
    """The fused online-distillation epoch end to end (in a fresh
    process): on-disk wavs and face-frame JPEGs (written by
    ``data/images.py``'s writer, outside the timed epochs) -> the batcher
    emitting crops and ``[B, K, 224, 224, 1]`` uint8 frames -> epochs of
    ``make_online_distill_step`` over a frozen SENet50 pipeline. K = 2
    adds 2 x 224^2 = 100,352 bytes an utterance to the feed."""
    import torch

    from mcncrossmodalemotions_torch.data.emovox import (
        BatchConfig,
        EmoVoxBatcher,
        build_synthetic_imdb,
    )
    from mcncrossmodalemotions_torch.models.teacher_pipeline import (
        FaceTeacherPipeline,
    )
    from mcncrossmodalemotions_torch.train.distill import (
        make_online_distill_step,
    )
    from mcncrossmodalemotions_torch.train.state import SGDConfig
    from mcncrossmodalemotions_torch.zoo import build_student, build_teacher

    dev = _device(device)
    size = 48 if tiny else 224
    pipeline = FaceTeacherPipeline(
        teacher=build_teacher("senet50-ferplus", tiny=tiny), input_size=size,
        augment=False)
    pipeline.reset_parameters(torch.Generator().manual_seed(1))
    step = make_online_distill_step(pipeline.to(dev),
                                    sgd=SGDConfig(weight_decay=0.0))
    with tempfile.TemporaryDirectory(prefix="bench_online_") as tmp:
        root = Path(tmp)
        t0 = time.perf_counter()
        imdb = build_synthetic_imdb(root / "wavs", num_speakers=num_speakers,
                                    tracks_per_speaker=tracks_per_speaker,
                                    duration_range=(4.2, 6.0), with_frames=True)
        frames = sum(len(f) for f in imdb.dense_frames)
        _log(f"online worker: {imdb.num_tracks} wavs and {frames} frames "
             f"written in {time.perf_counter() - t0:.1f} s")
        cfg = BatchConfig(batch_size=batch_size,
                          frames_per_crop=frames_per_crop, frame_size=size)
        batcher = EmoVoxBatcher(imdb, cfg, train=True, seed=0)
        trainer = _trainer(build_student("emovoxceleb-student", tiny=tiny),
                           root, dev, train_step_override=step)
        example = next(iter(batcher.batches(epoch=1, epoch_size=batch_size)))
        best = _epochs(trainer, batcher)
    return {"utts_per_sec": round(best["samples_per_sec"], 2),
            "num_samples": best["num_samples"],
            "feed_bound_frac": best.get("feed_bound_frac"),
            "frames_per_crop": cfg.frames_per_crop,
            "feed_bytes_per_utt": _feed_bytes_per_utt(example, batch_size)}


def _run_worker(args: list, device) -> dict:
    """Run ``python -m mcncrossmodalemotions_torch.bench <args>`` in a
    fresh process; its last stdout line (JSON). Raises on a timeout, a
    non-zero exit or an unparseable line."""
    from mcncrossmodalemotions_torch.exp.dense_chunked import worker_env

    proc = subprocess.run(
        [sys.executable, "-m", MODULE, *args, "--device", str(device)],
        capture_output=True, text=True, timeout=WORKER_TIMEOUT_S,
        env=worker_env())
    if proc.stderr:
        sys.stderr.write(proc.stderr[-4000:])
    if proc.returncode != 0:
        raise RuntimeError(f"worker {args} exited {proc.returncode}")
    try:
        return json.loads(proc.stdout.strip().splitlines()[-1])
    except (ValueError, IndexError) as exc:
        raise RuntimeError(f"worker {args}: unparseable output "
                           f"{proc.stdout[-200:]!r}") from exc


def bench_end_to_end_epoch(details: dict, device="cuda",
                           failures: Optional[list] = None) -> None:
    """The int16, mu-law uint8 and fused online epochs, each in a fresh
    ``--e2e-worker`` process (no worker inherits another's state), their
    fields under ``E2E_KEYMAPS``' keys. A failed worker is named in
    ``failures`` and the others still run."""
    for flag, keys in E2E_KEYMAPS.items():
        try:
            res = _run_worker(["--e2e-worker", flag], device)
        except (OSError, RuntimeError, subprocess.TimeoutExpired) as exc:
            _log(f"e2e worker {flag} failed: {exc}")
            if failures is not None:
                failures.append(f"e2e worker {flag}: {exc}")
            continue
        for field, key in keys.items():
            if field in res:
                details[key] = res[field]


def bench_teacher(details: dict, device="cuda", batch_size: int = 128,
                  tiny: bool = False, iters: int = 10) -> None:
    """SENet50 (bf16): inference and train-step images/s at batch 128,
    224x224x3 float32 randn, ``teacher_loss_fn("distributions")``."""
    import torch

    from mcncrossmodalemotions_torch.train.state import (
        SGDConfig,
        TrainState,
        make_train_step,
    )
    from mcncrossmodalemotions_torch.zoo import build_teacher, teacher_loss_fn

    dev = _device(device)
    size = 48 if tiny else 224
    rng = np.random.RandomState(0)
    teacher = build_teacher("senet50-ferplus", tiny=tiny)
    teacher.reset_parameters(torch.Generator().manual_seed(0))
    teacher.to(dev)
    x = torch.from_numpy(
        rng.randn(batch_size, size, size, 3).astype(np.float32)).to(dev)

    def run_fwd():
        with torch.no_grad():
            teacher(x, train=False)

    sec = _best_of(run_fwd, lambda: _sync(dev), iters=iters)
    details["teacher_inference_imgs_per_sec"] = round(batch_size / sec, 2)

    batch = {
        "data": torch.from_numpy(rng.randn(batch_size, size, size, 3)
                                 .astype(np.float32)).to(dev),
        "label_dist": torch.full((batch_size, 8), 1 / 8, device=dev),
        "hard_label": torch.from_numpy(rng.randint(0, 8, batch_size)).to(dev),
    }
    state = TrainState.create(teacher,
                              torch.Generator(device=dev).manual_seed(1))
    step = make_train_step(teacher_loss_fn("distributions"),
                           SGDConfig(weight_decay=0.0))
    sec = _best_of(lambda: step(state, batch, 1e-3), lambda: _sync(dev),
                   iters=iters)
    details["teacher_train_imgs_per_sec"] = round(batch_size / sec, 2)


def bench_fused_online(details: dict, device="cuda", batch_size: int = 64,
                       frames_per_crop: int = 2, num_frames: int = 400,
                       tiny: bool = False, iters: int = 10) -> None:
    """The fused online step (frozen SENet50 forward + the student's step,
    ``train/distill.py``) at batch 64 x 2 frames of 224x224, on a batch on
    the card."""
    import torch

    from mcncrossmodalemotions_torch.models.teacher_pipeline import (
        FaceTeacherPipeline,
    )
    from mcncrossmodalemotions_torch.ops.spectrogram import DEFAULT_SPEC
    from mcncrossmodalemotions_torch.train.distill import (
        make_online_distill_step,
    )
    from mcncrossmodalemotions_torch.train.state import SGDConfig, TrainState
    from mcncrossmodalemotions_torch.zoo import build_student, build_teacher

    dev = _device(device)
    size = 48 if tiny else 224
    rng = np.random.RandomState(0)
    crop = DEFAULT_SPEC.crop_samples(num_frames)
    batch = {
        "data": torch.from_numpy(
            rng.randn(batch_size, crop).astype(np.float32)).to(dev),
        "frames": torch.from_numpy(rng.randint(
            0, 255, (batch_size, frames_per_crop, size, size, 1)).astype(
                np.uint8)).to(dev),
    }
    student = build_student("emovoxceleb-student", tiny=tiny,
                            generator=torch.Generator().manual_seed(0))
    pipeline = FaceTeacherPipeline(
        teacher=build_teacher("senet50-ferplus", tiny=tiny), input_size=size,
        augment=False)
    pipeline.reset_parameters(torch.Generator().manual_seed(1))
    state = TrainState.create(student.to(dev),
                              torch.Generator(device=dev).manual_seed(2))
    step = make_online_distill_step(pipeline.to(dev),
                                    sgd=SGDConfig(weight_decay=0.0))
    sec = _best_of(lambda: step(state, batch, 1e-4), lambda: _sync(dev),
                   iters=iters)
    details["fused_online_step_utts_per_sec"] = round(batch_size / sec, 2)
    details["fused_online_step_ms"] = round(sec * 1000, 2)
    # step ms scales with the batch: without it a batch change would read
    # as a step-time regression
    details["fused_online_step_bs"] = batch_size


def bench_dense_inference(details: dict, device="cuda",
                          num_frames: int = 1280, frame_size: int = 256,
                          batch_size: int = 128, tiny: bool = False) -> None:
    """Dense teacher inference end to end from disk (the dataset-genesis
    workload): synthetic 256x256 JPEGs (written by ``data/images.py``'s
    writer before the clock starts) -> the port's threaded decoder (crop,
    gray, resize) -> pinned copies -> SENet50 forward; frames/s with the
    host, after one warm pass."""
    import torch

    from mcncrossmodalemotions_torch.data.images import save_synthetic_frame
    from mcncrossmodalemotions_torch.exp.compute_visual_feats import (
        VisualFeatureExtractor,
    )
    from mcncrossmodalemotions_torch.models.teacher_pipeline import (
        FaceTeacherPipeline,
    )
    from mcncrossmodalemotions_torch.zoo import build_teacher

    dev = _device(device)
    size = 48 if tiny else 224
    pipeline = FaceTeacherPipeline(
        teacher=build_teacher("senet50-ferplus", tiny=tiny), input_size=size,
        augment=False)
    pipeline.reset_parameters(torch.Generator().manual_seed(0))
    extractor = VisualFeatureExtractor(pipeline.eval(), pipeline.state_dict(),
                                       batch_size=batch_size, input_size=size,
                                       device=dev)
    with tempfile.TemporaryDirectory(prefix="bench_dense_") as tmp:
        paths = [Path(tmp) / f"frames/{i // 64:03d}/{i % 64:05d}.jpg"
                 for i in range(num_frames)]
        t0 = time.perf_counter()
        with ThreadPoolExecutor(max_workers=8) as pool:
            list(pool.map(lambda a: save_synthetic_frame(
                a[1], a[0] % 7, size=frame_size, seed=a[0]), enumerate(paths)))
        _log(f"dense: {num_frames} frames of {frame_size}x{frame_size} "
             f"written in {time.perf_counter() - t0:.1f} s")
        flat = [str(p) for p in paths]
        extractor.frame_logits(flat, verbose=False)  # cuDNN set-up, page cache
        t0 = time.perf_counter()
        logits = extractor.frame_logits(flat, verbose=False)
        sec = time.perf_counter() - t0
    if logits.shape != (num_frames, 8) or not np.isfinite(logits).all():
        raise RuntimeError(f"dense logits {logits.shape} not finite "
                           f"[{num_frames}, 8]")
    details["dense_inference_e2e_imgs_per_sec"] = round(num_frames / sec, 2)
    # uint8 gray faces: input_size^2 bytes each over the host link
    details["dense_inference_bytes_per_img"] = extractor.input_size ** 2


def audio_feats_wavs(root: Path, num_speakers: int = 8,
                     tracks_per_speaker: int = 25) -> list:
    """The audio-feats bench's tracks, written under ``root``: 8 x 25
    synthetic tracks of 2.0-9.5 s (``build_synthetic_imdb``'s seed);
    their paths."""
    from mcncrossmodalemotions_torch.data.emovox import build_synthetic_imdb

    imdb = build_synthetic_imdb(root / "wavs", num_speakers=num_speakers,
                                tracks_per_speaker=tracks_per_speaker,
                                duration_range=(2.0, 9.5))
    return [str(Path(imdb.wav_dir) / p) for p in imdb.wav_paths]


def bench_audio_feats(details: dict, device="cuda", num_speakers: int = 8,
                      tracks_per_speaker: int = 25, tiny: bool = False) -> None:
    """Bucketed whole-clip student extraction end to end from disk (the
    port's wav library's reads overlapped with the card; K1 and the
    index-free K2) over ``audio_feats_wavs``, after one warm pass."""
    import torch

    from mcncrossmodalemotions_torch.exp.compute_audio_feats import (
        AudioFeatureExtractor,
    )
    from mcncrossmodalemotions_torch.zoo import build_student

    dev = _device(device)
    model = build_student(with_frontend=False, tiny=tiny,
                          generator=torch.Generator().manual_seed(0))
    extractor = AudioFeatureExtractor(model, model.state_dict(), device=dev)
    with tempfile.TemporaryDirectory(prefix="bench_feats_") as tmp:
        paths = audio_feats_wavs(Path(tmp), num_speakers, tracks_per_speaker)
        extractor.track_logits(paths, verbose=False)  # every bucket's set-up
        t0 = time.perf_counter()
        out = extractor.track_logits(paths, verbose=False)
        sec = time.perf_counter() - t0
        # shipped bytes per track: bucket-padded int16 PCM (emit_int16)
        ship = sum(extractor.spec.crop_samples(extractor._meta(p)[2]) * 2
                   for p in paths)
    if any(o is None for o in out):
        raise RuntimeError("a track has no logits")
    details["audio_feats_tracks_per_sec"] = round(len(paths) / sec, 2)
    details["audio_feats_batch_size"] = extractor.batch_size
    details["audio_feats_bytes_per_track"] = int(ship / len(paths))


def bench_frontend(details: dict, device="cuda", batch_size: int = 128,
                   num_frames: int = 400, iters: int = 10) -> None:
    """The spectrogram frontend (``waveform_to_input``) at float32
    ``[128, 64384]``: the plain version and K1."""
    import torch

    from mcncrossmodalemotions_torch.ops.spectrogram import (
        DEFAULT_SPEC,
        waveform_to_input,
    )

    dev = _device(device)
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(
        batch_size, DEFAULT_SPEC.crop_samples(num_frames)).astype(
            np.float32)).to(dev)
    for name, use_kernel in (("plain", False), ("kernel", True)):
        sec = _best_of(lambda: waveform_to_input(x, use_kernel=use_kernel),
                       lambda: _sync(dev), iters=iters)
        details[f"frontend_{name}_ms"] = round(sec * 1000, 3)


# The numerics gate's tolerances against the CPU golden (bench.py's): the
# frontend is fp32 on both sides; the train-step losses go through bf16
# convolutions, where 1e-3..1e-2 relative drift is the expected envelope.
_NUMERICS_FRONTEND_RTOL = 1e-3
_NUMERICS_LOSS_RTOL = 5e-2


def _numerics_probe(device="cpu", variables: Optional[dict] = None) -> dict:
    """A small computation run alike on the CPU (the plain versions) and
    on the card (the kernels): the frontend over a fixed [2, 16,384] batch
    (seed 0, x 0.1) and 3 train-step losses of the tiny student at lr
    1e-4 (hot-cross-ent T=2, weight decay 0) on a fixed batch. The init
    is ``build_student(tiny=True)``'s from a CPU generator seeded 0, the
    same on every device, or ``variables``, a ``state_dict`` of the tiny
    student pipeline (the JAX init through ``zoo/bridge.py``)."""
    import torch

    from mcncrossmodalemotions_torch.ops.spectrogram import (
        DEFAULT_SPEC,
        waveform_to_input,
    )
    from mcncrossmodalemotions_torch.train.state import (
        SGDConfig,
        TrainState,
        make_train_step,
    )
    from mcncrossmodalemotions_torch.zoo import build_student, student_loss_fn

    dev = torch.device(device)
    rng = np.random.RandomState(0)
    wav = rng.randn(2, DEFAULT_SPEC.crop_samples(100)).astype(np.float32) * 0.1
    data = torch.from_numpy(wav).to(dev)
    with torch.no_grad():
        front = waveform_to_input(data).cpu().numpy().astype(np.float64)
    batch = {
        "data": data,
        "logit_target": torch.from_numpy(
            rng.randn(2, 8).astype(np.float32) * 2).to(dev),
        "max_label": torch.from_numpy(rng.randint(0, 8, 2)).to(dev),
    }
    model = build_student(tiny=True, generator=torch.Generator().manual_seed(0))
    if variables is not None:
        model.load_state_dict(variables)
    state = TrainState.create(model.to(dev),
                              torch.Generator(device=dev).manual_seed(1))
    step = make_train_step(student_loss_fn("hot-cross-ent", temperature=2.0),
                           SGDConfig(weight_decay=0.0))
    losses = []
    for _ in range(3):
        state, m = step(state, batch, 1e-4)
        losses.append(float(m["loss"]))
    return {"frontend": front, "losses": np.asarray(losses, np.float64)}


def _numerics_worker(out_path: str) -> None:
    """The CPU golden of the numerics gate (a fresh process, as the plain
    versions run there)."""
    np.savez(out_path, **_numerics_probe("cpu"))


def bench_numerics(details: dict, golden_path, device="cuda") -> None:
    """The card's numerics against the CPU golden: ``numerics_ok`` holds
    when the frontend and the losses are within the tolerances above. A
    missing golden records nothing (no false pass)."""
    if not golden_path or not Path(golden_path).exists():
        _log("numerics golden unavailable; skipping the numerics gate")
        return
    golden = np.load(golden_path)
    probe = _numerics_probe(device)
    scale = max(float(np.abs(golden["frontend"]).max()), 1e-6)
    frontend_rel = float(
        np.abs(probe["frontend"] - golden["frontend"]).max() / scale)
    loss_rel = float(np.max(
        np.abs(probe["losses"] - golden["losses"])
        / np.maximum(np.abs(golden["losses"]), 1e-6)))
    details["numerics_frontend_rel"] = round(frontend_rel, 8)
    details["numerics_loss_rel"] = round(loss_rel, 8)
    details["numerics_ok"] = bool(frontend_rel < _NUMERICS_FRONTEND_RTOL
                                  and loss_rel < _NUMERICS_LOSS_RTOL)
    if not details["numerics_ok"]:
        _log(f"NUMERICS GATE FAILED: frontend_rel={frontend_rel:.2e} "
             f"(tol {_NUMERICS_FRONTEND_RTOL}), loss_rel={loss_rel:.2e} "
             f"(tol {_NUMERICS_LOSS_RTOL})")


def _write_details(details: dict, out_dir: Path) -> None:
    """Merge-update ``bench_details.json`` (a default run keeps a --full
    run's sub-benchmark entries)."""
    out = out_dir / "bench_details.json"
    merged = {}
    if out.exists():
        try:
            merged = json.loads(out.read_text())
        except ValueError:
            merged = {}
    merged.update(details)
    out.write_text(json.dumps(merged, indent=2) + "\n")
    _log(f"details -> {out}: {json.dumps(details)}")


def _append_history(details: dict, argv: list, out_dir: Path) -> None:
    """One JSONL row per run."""
    row = {"timestamp": time.strftime("%Y-%m-%dT%H:%M:%S"), "argv": argv,
           **details}
    with (out_dir / "bench_history.jsonl").open("a") as f:
        f.write(json.dumps(row, default=float) + "\n")


_READER_PROBE = """
import os, sys, tempfile
import numpy as np
from mcncrossmodalemotions_torch.data import native, native_audio, native_faces
from mcncrossmodalemotions_torch.data.audio import write_wav
from mcncrossmodalemotions_torch.data.images import save_synthetic_frame
with tempfile.TemporaryDirectory() as d:
    wav, jpg = os.path.join(d, "probe.wav"), os.path.join(d, "probe.jpg")
    write_wav(wav, np.zeros(400, np.float32), 16000)
    assert native_audio.wav_info(wav)[0] == 400
    save_synthetic_frame(jpg, 1, size=32)
    assert native_faces.decode_faces([jpg], 16, 1.0).shape == (1, 16, 16, 1)
    try:  # the committed library, where this host loads it
        loads = native.available()
    except OSError as exc:  # e.g. no libjpeg.so.62 on the card's host
        loads = False
        print(f"native/libdataservice.so does not load here: {exc}",
              file=sys.stderr)
    if loads:
        assert native.read_crops([wav], [0], 400).shape == (1, 400)
        print("native/libdataservice.so loads and reads", file=sys.stderr)
"""


def _ensure_readers_built() -> None:
    """Build the port's wav reader and face decoder libraries
    (``csrc/dataservice_audio.cc``, ``csrc/dataservice_faces.cc``) here,
    before any worker needs them, then read a wav and decode a frame
    through them in a fresh process (a library that does not load or
    crashes cannot take this one down), and ``native/libdataservice.so``
    where ``data/native.py`` loads it. Raises on a failed build or
    probe; renames nothing."""
    from mcncrossmodalemotions_torch.exp.dense_chunked import worker_env
    from mcncrossmodalemotions_torch.ops import _build

    _build.load("dataservice_audio", "dataservice_faces")
    proc = subprocess.run([sys.executable, "-c", _READER_PROBE],
                          capture_output=True, text=True, timeout=300,
                          env=worker_env())
    if proc.returncode != 0:
        raise RuntimeError(f"the reader probe exited {proc.returncode}: "
                           f"{proc.stderr[-800:]}")
    _log(proc.stderr.strip())


SUB_BENCHMARKS = (("frontend", bench_frontend, False),
                  ("teacher", bench_teacher, True),
                  ("fused_online", bench_fused_online, True),
                  ("dense_inference", bench_dense_inference, True),
                  ("audio_feats", bench_audio_feats, True))
"""(name, function, --full only) of the in-process sub-benchmarks, in
``bench.py``'s order."""


def main(argv: Optional[list] = None, device="cuda") -> int:
    """The bench (``--quick``, default or ``--full``; ``--out-dir``);
    returns the exit code. ``device`` is the default of ``--device``."""
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--quick", action="store_true", help="headline only")
    mode.add_argument("--full", action="store_true",
                      help="every sub-benchmark")
    ap.add_argument("--out-dir", type=Path, default=DEFAULT_OUT_DIR)
    ap.add_argument("--device", default=str(device))
    ap.add_argument("--e2e-worker", choices=tuple(E2E_KEYMAPS),
                    help=argparse.SUPPRESS)
    ap.add_argument("--numerics-worker", help=argparse.SUPPRESS)
    argv = list(sys.argv[1:] if argv is None else argv)
    args = ap.parse_args(argv)

    if args.numerics_worker:
        _numerics_worker(args.numerics_worker)
        print(json.dumps({"golden": args.numerics_worker}))
        return 0
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        _log("bench: no CUDA device; pass --device cpu (cli: device=cpu) to "
             "run the plain versions on the CPU")
        return 2
    if args.e2e_worker:
        res = (_online_epoch_worker(args.device) if args.e2e_worker == "online"
               else _e2e_epoch_worker(args.e2e_worker == "mulaw8", args.device))
        print(json.dumps(res))
        return 0

    failures: list = []
    details: dict = {}
    numerics_golden = None
    try:
        _ensure_readers_built()
    except (OSError, RuntimeError, subprocess.TimeoutExpired) as exc:
        _log(f"reader build failed: {exc}")
        failures.append(f"reader build: {exc}")
    args.out_dir.mkdir(parents=True, exist_ok=True)
    if not args.quick:
        # the workers and the golden run before this process touches the
        # card: each takes it whole, with nothing of another's state
        _log("running end_to_end sub-benchmark (worker processes) ...")
        bench_end_to_end_epoch(details, args.device, failures)
        path = args.out_dir / "numerics_golden.npz"
        try:
            _run_worker(["--numerics-worker", str(path)], "cpu")
            numerics_golden = path
        except (OSError, RuntimeError, subprocess.TimeoutExpired) as exc:
            _log(f"numerics golden worker failed: {exc}")
            failures.append(f"numerics golden worker: {exc}")
    dev = torch.device(args.device)
    details.update({
        "device_kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                        else "cpu"),
        "backend": dev.type})

    def run(name: str, fn: Callable, *fargs):
        try:
            _log(f"running {name} ...")
            return fn(details, *fargs)
        except Exception as exc:  # every sub-benchmark runs; exit 1 after
            import traceback

            traceback.print_exc()
            failures.append(f"{name}: {type(exc).__name__}: {exc}")
            return None

    utts_per_sec = run("train_step", bench_train_step, dev)
    if not args.quick:
        run("numerics", bench_numerics, numerics_golden, dev)
        if details.get("numerics_ok") is not True:
            failures.append(f"numerics_ok is {details.get('numerics_ok')}")
        for name, fn, full_only in SUB_BENCHMARKS:
            if args.full or not full_only:
                run(name, fn, dev)
        _write_details(details, args.out_dir)
    _append_history(details, argv, args.out_dir)
    if utts_per_sec is not None:
        print(json.dumps({
            "metric": "distillation_train_throughput",
            "value": round(utts_per_sec, 2),
            "unit": "utts/sec/chip",
        }), flush=True)
    if failures:
        _log("bench FAILED: " + "; ".join(failures))
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
