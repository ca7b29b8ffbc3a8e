#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's two CUDA kernels from ``mcncrossmodalemotions_torch/csrc``
(nvcc -> ``build/kernels/``), holds each against its plain PyTorch version
on the card, then drives the port's main path -- whole-clip student
feature extraction (``compute_audio_feats``) with the full-width VGG-M
student and seeded weights -- over synthetic tracks in three duration
buckets, with and without the kernels. Phases:

1. device: the card's name and power limit (nvidia-smi); TF32 off.
2. build: nvcc seconds per kernel library.
3. data: 126 synthetic wavs (``data.synthetic_track_imdb``), grouped as
   the extractor groups them; each chunk's shapes are the shapes the
   main run launches the kernels at.
4. K1 spectrogram kernel vs the plain frontend, max rel error (max |diff|
   / max |plain|) <= 1e-4: at [64, 64384] (T=400, plus one row against a
   float64 numpy FFT within atol 5e-4), T=150 and T=1000, and at each
   chunk's int16 feed; kernel and plain times (CUDA events) there.
5. K2 3x3/2 max-pool kernel vs F.max_pool2d at each chunk's pool1 and
   pool2 input, bf16 and fp32, post-ReLU: bitwise equal; bf16 times.
6. slice: per-track logits finite and [1, 8]; the main run launched K1
   once and K2 twice per chunk; kernel-on logits within 2e-2 *
   max|logit| of the plain run; tracks/s.

Prints one JSON line of kernel results (``ms``/``plain_ms``: summed over
the main run's launch shapes; K1's at the int16 feed, whose decode both
versions run), then, last, the device line
``{"ok": true, "device": {...}}``. Exits non-zero, without the device
line, when any phase fails or no CUDA device is present. Imports no jax.
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 0
BATCH = 64
K1_REL_TOL = 1e-4             # fp32 vs fp32, summation order only
K1_GOLDEN_ATOL = 5e-4         # as tests/test_spectrogram.py
SLICE_REL_TOL = 2e-2          # bf16 convs over an fp32 frontend


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


@contextlib.contextmanager
def phase(name: str, walls: dict):
    t0 = time.perf_counter()
    print(f"[{name}] start", flush=True)
    yield
    walls[name] = time.perf_counter() - t0
    print(f"[{name}] ok in {walls[name]:.2f} s", flush=True)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device milliseconds per call, CUDA events around ``iters`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
        enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def paired_ms(kernel_fn, plain_fn) -> tuple:
    """(kernel ms, plain ms), timed in turns plain, kernel, kernel, plain."""
    p1, k1, k2, p2 = (cuda_ms(plain_fn), cuda_ms(kernel_fn),
                      cuda_ms(kernel_fn), cuda_ms(plain_fn))
    return (k1 + k2) / 2, (p1 + p2) / 2


def golden_row(x, cfg):
    """float64 runSpec of one waveform row: [nfft, T]."""
    import numpy as np

    x = np.asarray(x, np.float64)
    xe = np.concatenate([x[:1], x[1:] - cfg.preemph * x[:-1]])
    t = cfg.num_frames(len(x))
    idx = np.arange(t)[:, None] * cfg.hop_length + np.arange(cfg.win_length)
    n = cfg.win_length
    w = 0.54 - 0.46 * np.cos(2 * np.pi * np.arange(n) / (n - 1))
    return np.abs(np.fft.fft(xe[idx] * w, cfg.nfft, axis=-1)).T


def pool_inputs(rows: int, bucket: int, nfft: int) -> dict:
    """NHWC inputs of the student's pool1 and pool2 for a [rows, nfft,
    bucket, 1] spectrogram: conv1 7x7/2, pool1 3x3/2, conv2 5x5/2."""
    def out(n, k, s):
        return (n - k) // s + 1

    h1, w1 = out(nfft, 7, 2), out(bucket, 7, 2)
    h2, w2 = out(out(h1, 3, 2), 5, 2), out(out(w1, 3, 2), 5, 2)
    return {"pool1": (rows, h1, w1, 96), "pool2": (rows, h2, w2, 256)}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import mcncrossmodalemotions_torch as port

    check(Path(port.__file__).resolve().parent.parent == ROOT,
          f"imported {port.__file__}, not the package beside this script")
    import numpy as np
    import torch.nn.functional as F

    from mcncrossmodalemotions_torch.data import synthetic_track_imdb
    from mcncrossmodalemotions_torch.exp.compute_audio_feats import (
        AudioFeatureExtractor,
        compute_audio_feats,
    )
    from mcncrossmodalemotions_torch.ops import _build, pool
    from mcncrossmodalemotions_torch.ops.spectrogram import (
        DEFAULT_SPEC,
        spectrogram,
    )
    from mcncrossmodalemotions_torch.ops.spectrogram_kernel import spectrogram_cuda
    from mcncrossmodalemotions_torch.zoo import (
        build_student,
        random_student_variables,
        student_state_dict_from_flax,
    )

    walls: dict = {}
    cfg = DEFAULT_SPEC
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)

    with phase("device", walls):
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
        card = smi.stdout.strip().splitlines()[0]
        print(card, flush=True)
        name = torch.cuda.get_device_name(0)
        print(f"torch {torch.__version__} cuda {torch.version.cuda}, "
              f"device 0: {name}, {torch.cuda.device_count()} device(s)")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    with phase("build", walls):
        for lib in ("spectrogram", "max_pool_3x3s2"):
            _build.load(lib)
            log = _build.library_path(lib).with_suffix(".log").read_text()
            for line in log.splitlines():
                if "registers" in line or "spill" in line:
                    print(f"  {lib}: {line.strip()}")
            print(f"  {lib}: nvcc {_build.build_seconds[lib]:.2f} s", flush=True)

    with tempfile.TemporaryDirectory() as tmp:
        with phase("data", walls):
            imdb = synthetic_track_imdb(Path(tmp))
            paths = list(imdb.wav_paths)
            probe = AudioFeatureExtractor(None, {})
            groups: dict = {}
            for p in paths:
                _, bucket, t_pad = probe._meta(p)[:3]
                groups[(t_pad, bucket)] = groups.get((t_pad, bucket), 0) + 1
            # (rows, t_pad, bucket) of every chunk the extractor launches
            chunks = [(min(BATCH, count - k), t_pad, bucket)
                      for (t_pad, bucket), count in sorted(groups.items())
                      for k in range(0, count, BATCH)]
            print(f"  {len(paths)} tracks; chunks (rows, t_pad, bucket): "
                  f"{chunks}")
            check(len({b for _, _, b in chunks}) >= 3, "fewer than three buckets")

        timings = {"spectrogram": [0.0, 0.0], "max_pool_3x3s2": [0.0, 0.0]}
        k1_err, k2_err = 0.0, 0.0
        with phase("k1", walls):
            bench_n = cfg.crop_samples(400)
            cases = [("bench crop", BATCH, bench_n, torch.float32, False),
                     ("ragged tile", BATCH, cfg.crop_samples(150),
                      torch.float32, False),
                     ("t_pad=1000", BATCH, cfg.crop_samples(1000),
                      torch.float32, False)]
            cases += [(f"slice t_pad={t_pad}", rows, cfg.crop_samples(t_pad),
                       torch.int16, True) for rows, t_pad, _ in chunks]
            for label, rows, n, dtype, timed in cases:
                gen.manual_seed(SEED)
                x = torch.randn(rows, n, device=dev, generator=gen)
                if dtype == torch.int16:  # the slice's PCM16 feed
                    x = (x * 0.25 * 32767).round().clamp(-32768, 32767).to(dtype)
                got = spectrogram_cuda(x, cfg)
                ref = spectrogram(x, cfg)
                torch.cuda.synchronize()
                check(got.shape == ref.shape == (rows, cfg.nfft, cfg.num_frames(n)),
                      f"K1 {label}: shape {tuple(got.shape)} vs {tuple(ref.shape)}")
                err = (got - ref).abs().max().item()
                rel = err / ref.abs().max().item()
                k1_err = max(k1_err, err)
                print(f"  K1 {label} {tuple(x.shape)} {dtype} "
                      f"(T={cfg.num_frames(n)}): max abs {err:.3e}, "
                      f"max rel {rel:.3e}", flush=True)
                check(rel <= K1_REL_TOL,
                      f"K1 {label}: rel err {rel:.3e} > {K1_REL_TOL}")
                if label == "bench crop":
                    gold = golden_row(x[0].cpu().numpy(), cfg)
                    gerr = float(np.abs(got[0].cpu().numpy() - gold).max())
                    print(f"  K1 {label} row 0 vs float64 FFT: max abs {gerr:.3e}")
                    check(gerr <= K1_GOLDEN_ATOL, f"K1 golden: {gerr:.3e}")
                if timed:
                    k, p = paired_ms(lambda: spectrogram_cuda(x, cfg),
                                     lambda: spectrogram(x, cfg))
                    timings["spectrogram"][0] += k
                    timings["spectrogram"][1] += p
                    print(f"  {card}: K1 {label} {tuple(x.shape)} int16: "
                          f"kernel {k:.4f} ms, plain {p:.4f} ms")
            del x, got, ref

        with phase("k2", walls):
            for rows, _, bucket in chunks:
                for label, shape in pool_inputs(rows, bucket, cfg.nfft).items():
                    for dtype, ibits in ((torch.bfloat16, torch.int16),
                                         (torch.float32, torch.int32)):
                        gen.manual_seed(SEED)
                        x = torch.relu(torch.randn(shape, device=dev,
                                                   generator=gen)).to(dtype)
                        got = pool.max_pool_3x3s2_cuda(x)
                        ref = F.max_pool2d(x.permute(0, 3, 1, 2), 3, 2).permute(
                            0, 2, 3, 1).contiguous()
                        torch.cuda.synchronize()
                        same = got.shape == ref.shape and torch.equal(
                            got.view(ibits), ref.view(ibits))
                        err = (got.float() - ref.float()).abs().max().item()
                        k2_err = max(k2_err, err)
                        print(f"  K2 bucket {bucket} {label} {shape} {dtype}: "
                              f"bitwise {'equal' if same else 'DIFFERENT'} "
                              f"(max abs {err:.3e})", flush=True)
                        check(same, f"K2 bucket {bucket} {label} {dtype}: "
                              "not bitwise equal")
                        if dtype == torch.bfloat16:  # the slice's dtype
                            k, p = paired_ms(
                                lambda: pool.max_pool_3x3s2_cuda(x),
                                lambda: pool.max_pool_3x3s2(x))
                            timings["max_pool_3x3s2"][0] += k
                            timings["max_pool_3x3s2"][1] += p
                            print(f"  {card}: K2 bucket {bucket} {label} "
                                  f"{shape} bf16: kernel {k:.4f} ms, "
                                  f"plain {p:.4f} ms")
                        del x, got, ref
            torch.cuda.empty_cache()

        with phase("slice", walls):
            model = build_student(with_frontend=False)  # full width, bf16
            state = {k: v.to(dev) for k, v in student_state_dict_from_flax(
                random_student_variables(seed=SEED)).items()}

            t0 = time.perf_counter()
            compute_audio_feats(imdb, model, state, batch_size=BATCH,
                                verbose=False)
            torch.cuda.synchronize()
            first_s = time.perf_counter() - t0

            spectrogram_cuda.launches = 0
            pool.max_pool_3x3s2_cuda.launches = 0
            t0 = time.perf_counter()
            with contextlib.redirect_stderr(sys.stdout):
                logits = compute_audio_feats(imdb, model, state, batch_size=BATCH)
            torch.cuda.synchronize()
            main_s = time.perf_counter() - t0
            launches = {"spectrogram": spectrogram_cuda.launches,
                        "max_pool_3x3s2": pool.max_pool_3x3s2_cuda.launches}

            t0 = time.perf_counter()
            plain = compute_audio_feats(imdb, model, state, batch_size=BATCH,
                                        use_kernels=False, verbose=False)
            torch.cuda.synchronize()
            plain_s = time.perf_counter() - t0

            check(len(logits) == len(paths), "missing tracks")
            check(all(l.shape == (1, 8) and np.all(np.isfinite(l))
                      for l in logits), "logits not finite [1, 8]")
            expected = {"spectrogram": len(chunks),
                        "max_pool_3x3s2": 2 * len(chunks)}
            print(f"  launches in the main run: {launches}, "
                  f"expected {expected}")
            check(launches == expected,
                  f"the main path did not launch the kernels once per "
                  f"spectrogram and pool: {launches}")
            got, ref = np.concatenate(logits), np.concatenate(plain)
            scale = float(np.abs(ref).max())
            diff = float(np.abs(got - ref).max())
            print(f"  logits kernel vs plain: max abs {diff:.3e}, "
                  f"max |logit| {scale:.3f}, rel {diff / scale:.3e}")
            check(diff <= SLICE_REL_TOL * scale, "kernel-on logits disagree")
            print(f"  {card}: first run {first_s:.3f} s, main run {main_s:.3f} s "
                  f"= {len(paths) / main_s:.2f} tracks/s (kernels), plain run "
                  f"{plain_s:.3f} s = {len(paths) / plain_s:.2f} tracks/s",
                  flush=True)

    print("  phase walls (s): " + ", ".join(f"{k} {v:.2f}"
                                            for k, v in walls.items()))
    print(f"  {card}: kernel times summed over the main run's launch shapes "
          f"(ms, kernel / plain): " + ", ".join(
              f"{k} {v[0]:.4f} / {v[1]:.4f}" for k, v in timings.items()))
    kernels = [
        {"name": "spectrogram", "route": "cuda",
         "source": "mcncrossmodalemotions_torch/csrc/spectrogram.cu",
         "replaces": "mcncrossmodalemotions_tpu/ops/pallas_spectrogram.py:117",
         "launches": launches["spectrogram"], "max_abs_err": k1_err,
         "ms": timings["spectrogram"][0], "plain_ms": timings["spectrogram"][1]},
        {"name": "max_pool_3x3s2", "route": "cuda",
         "source": "mcncrossmodalemotions_torch/csrc/max_pool_3x3s2.cu",
         "replaces": "mcncrossmodalemotions_tpu/ops/pallas_pool.py:95",
         "launches": launches["max_pool_3x3s2"], "max_abs_err": k2_err,
         "ms": timings["max_pool_3x3s2"][0],
         "plain_ms": timings["max_pool_3x3s2"][1]},
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as exc:
        print(f"chip_smoke FAILED: {exc}", flush=True)
        sys.exit(1)
