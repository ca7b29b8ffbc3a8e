#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels and its wav reader library from
``mcncrossmodalemotions_torch/csrc`` (one nvcc or g++ per source, started
together -> ``build/kernels/``), holds each kernel against its plain
PyTorch version on the card, then drives the port's main paths, all but
the probes with the full-width VGG-M student: whole-clip feature
extraction (``compute_audio_feats``, seeded weights, synthetic tracks in
three duration buckets), the distillation train step at the headline
shape, offline ``run_distillation`` end to end, extraction through the
port's own wav reader, a released student loaded from a ``.mat`` file and
trained on from it, the student's statistics and external benchmarks,
and the two Mosaic probe tools; each path with and without the kernels
where a comparison applies. Phases:

1. device: the card's name and power limit (nvidia-smi); TF32 off.
2. build: nvcc seconds per kernel library (spectrogram, max_pool_3x3s2,
   probes) and g++ seconds for the wav reader (dataservice_audio).
3. data: 126 synthetic wavs (``data.synthetic_track_imdb``), grouped as
   the extractor groups them; each chunk's shapes are the shapes the
   main run launches the kernels at.
4. K1 spectrogram kernel (a real FFT a frame) vs the plain frontend, max
   rel error (max |diff| / max |plain|) <= 1e-4: at [64, 64384] (T=400,
   plus one row against a float64 numpy FFT within atol 5e-4), T=150,
   T=1000, T=1 and T=33 (one frame past two 16-frame tiles, int16), at each
   chunk's int16 feed and at the train step's int16 [128, 64384]; kernel
   and plain times (CUDA events) at the last two, beside ``torch.stft``
   (cuFFT) on the same pre-emphasised rows, whose magnitudes are held to
   the plain frontend's first nfft/2+1 bins within 1e-3 of the max.
5. K2 3x3/2 max-pool kernel vs F.max_pool2d at each chunk's pool1 and
   pool2 input, bf16 and fp32, post-ReLU: bitwise equal; bf16 times.
6. slice: ``compute_audio_feats`` given CPU weights runs on the card by
   default; per-track logits finite and [1, 8]; the main run launched K1
   once and K2 twice per chunk; kernel-on logits within 2e-2 *
   max|logit| of the plain run; tracks/s.
7. k2-backward at the train step's pool1 [128,253,197,96] and pool2
   [128,61,47,256] inputs, post-ReLU in bf16 and fp32 and tie-heavy
   (small integers) in bf16, then even H and W [16,254,198,96] post-ReLU
   in bf16 and fp32 and a narrow C=12 [16,61,47,12] tie-heavy bf16 input
   (one element a lane), random dy: the with-index forward's y bitwise
   equal to F.max_pool2d's and the index-free one's, its idx equal to the
   plain version's in-window code, and dx of the backward kernel bitwise
   equal to autograd of F.max_pool2d (same winners, fp32 sums in the same
   window order); bf16 post-ReLU times of both kernels at pool1 and pool2
   against the plain with-indices forward and backward.
8. train: the full-width pipeline at int16 [128, 64384], hot-cross-ent at
   T=2, weight decay 0 (``bench.py``'s train step), from one seeded init:
   3 steps with the kernels, then 3 plain. Losses finite and within 1e-2
   relative of each other (bf16 convs, cuDNN's non-deterministic weight
   gradients, K1's fp32 summation order), conv1's 3-step update within
   0.5 relative L2 of the plain one (a mis-routed pool gradient gave 1.10
   at tiny width on the CPU); per step K1 launched once, the
   with-index K2 forward twice, the K2 backward twice and the index-free
   K2 forward never; mean step ms and utts/s of each mode over 10 timed
   steps after 2 warm-up steps.
9. distill: ``run_distillation`` (full width, batch 64) on the port's
   ``build_synthetic_imdb`` with 8 speakers x 20 tracks (2 full train
   batches an epoch) for 2 epochs: checkpoints 1 and 2 and
   ``metrics.jsonl`` appear, losses finite, the exact kernel launch
   counts; a second call with ``num_epochs=3`` resumes at epoch 3;
   ``feed_bound_frac`` per epoch.
10. reader: the port's wav reader library (``csrc/dataservice_audio.cc``),
    not Python, serves extraction; its ``ds_read_crops`` and
    ``ds_read_crops_packed`` crops are bitwise the Python reads (and their
    ``pack_pcm16``) over the smoke's tracks, from 0 and from random
    starts; extraction's tracks/s with library reads and with Python reads
    (``MCNCME_DISABLE_NATIVE``), in turns, over windows of the smoke's
    tracks read 16 times (the window's seconds printed beside each rate),
    each run launching K1 once and K2 twice per chunk, their logits within
    the slice gate.
11. release: a classic (v5) MatConvNet ``.mat`` written from seeded
    full-width weights with nonzero conv biases (BN means moved by them),
    loaded on the card by ``load_pretrained_student``: extraction logits
    within 2e-2 x max|logit| of the seeded weights through the bridge;
    one ``run_distillation`` epoch with ``from_scratch=False`` from the
    file (exact launch counts), and ``load_student_from_exp(..., 'best')``
    bitwise equal to the checkpoint's state.
12. analysis: ``student_stats`` over the distill phase's imdb with the
    released student, extraction with the kernels and plain, in fp32
    (per-emotion AUCs within 0.02) and in bf16, the default (bf16 rounding
    swaps near-tied tracks, and a few swaps in a partition of 7 or 20
    tracks move an AUC by more than 0.02, so per partition the kernels may
    reorder at most 2n + 1 (positive, negative) track pairs, n the pairs
    that bf16 itself reorders on the plain path against fp32); each
    partition's largest AUC gap, ``meanAuc`` of each run and the first
    reordered pairs printed; ``emo_benchmarks`` over a synthetic external
    set (60 tracks, 6 classes, 5 folds): mean and std accuracy.
13. probes: both probe tools (``tools.probe_mosaic``, ``probe_mosaic2``)
    on the card: all 17 probes RUN with ``match=True``, launching
    ``probe_gather`` 15 times and the other two probe kernels once each;
    then every probe's kernel bitwise equal to its plain version (P9's
    also exactly numpy's ``expect``), P9 again on random inputs with a row
    stride, at the probe's shape and a ragged one, within 1e-5 of |a| @
    |b| of float64 (its split along K sums in another order), P12 again
    on small-integer inputs where both candidate branches fire (their
    nonzero shares printed, each above 0), and each probe's kernel, plain
    and library times, each beside its bound and the launch floor (a
    one-element ``probe_gather`` timed the same way: the least a launch
    takes on the card).

Prints one JSON line of kernel results (``launches``: the K1/K2 kernels'
counted over the main runs of the slice, train, distill, reader, release
and analysis phases, the probe kernels' over the probes run, each read between a reset just before and just after it;
``ms``/``plain_ms``/``library_ms``: summed over the main runs' launch
shapes, K1's at the int16 feed, which the kernel reads as it is and the
plain version decodes, the with-index forward and the backward at the
train step's, the probes' at the probes' own; ``bound_ms``: the least
time for the same work, from the bytes each input and output must move
and the operations the function needs (K1's: an FFT's), at H100 SXM
peaks; K2's library call is its plain version), then, last, the
device line ``{"ok": true, "device": {...}}``. Exits non-zero, without the
device line, when any phase fails or no CUDA device is present. Imports
nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import contextlib
import json
import math
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
TRAIN_BATCH = 128             # bench.py's train step
TRAIN_LOSS_RTOL = 1e-2        # bf16 convs, cuDNN wgrad order, K1 sum order
TRAIN_UPDATE_RTOL = 0.5       # conv1's 3-step update, relative L2: a
                              # mis-routed pool gradient gave 1.10 at
                              # tiny width on the CPU (0.087 unmutated)
TRAIN_LR = 1e-4               # bench.py's lr
TIMED_STEPS, WARMUP_STEPS = 10, 2
STFT_REL_TOL = 1e-3           # cuFFT vs the fp32 DFT product: order only
P9_RTOL = 1e-5                # of |a| @ |b|: P9 sums K in 8 slices, then
                              # the slices, another order than one chain
PROBE_ITERS = 200             # probe kernels take microseconds
QUEUE_CYCLES = 100_000_000    # ~50 ms of device sleep ahead of timed calls
N_PROBES = 17                 # P1-P11, P5b; P4r, P4s, P4b, P12, P1r
EVEN_POOL = (16, 254, 198, 96)  # k2-backward: even H and W, 16-byte vectors
NARROW_POOL = (16, 61, 47, 12)  # k2-backward: 24 bytes a bf16 pixel, one
                                # element a lane
AUC_TOL = 0.02                # per-emotion AUC, extraction kernels vs plain
READER_REPEATS = 16           # the reader phase's windows: the track list
                              # 16 times, seconds long
HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory
FP32_OPS_PER_S = 67e12        # H100 SXM fp32 outside the tensor cores


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
    """Mean device milliseconds per call, CUDA events around ``iters`` calls.

    The calls are queued behind a device-side sleep, so they run back to
    back on the card: a call shorter than the host's cost of issuing it
    (the probe kernels) is timed on the device, not at the host's pace."""
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
        enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(QUEUE_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def turns_ms(*fns, iters: int = 20) -> list:
    """Mean device ms per call of each fn, timed in turns: in order, then
    in reverse (plain, kernel, kernel, plain for two)."""
    first = [cuda_ms(f, iters) for f in fns]
    second = [cuda_ms(f, iters) for f in reversed(fns)][::-1]
    return [(a + b) / 2 for a, b in zip(first, second)]


def bound_ms(nbytes: float, ops: float) -> tuple:
    """(ms, "bytes" or "operations"): the least time an H100 could take to
    move ``nbytes`` through device memory and do ``ops`` fp32 operations,
    whichever is longer."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def spectrogram_ops(frames: int, cfg) -> tuple:
    """(least, as a DFT product): K1's function's operations over
    ``frames`` frames. The least is an FFT's 5 N log2 N a frame (N =
    nfft), which K1 does; the DFT computed as a product, 2 x win x 2
    (nfft/2+1) a frame, is printed beside it for comparison."""
    fft = frames * 5 * cfg.nfft * math.log2(cfg.nfft)
    return fft, frames * 2 * cfg.win_length * 2 * cfg.num_rbins


def stft_call(xe, cfg):
    """The library call that computes K1's magnitudes: ``torch.stft``
    (cuFFT on the card) of the pre-emphasised [B, N] rows ``xe``, Hamming
    window, ``center=False``, ``.abs()`` -> [B, nfft/2+1, T], the plain
    frontend's first nfft/2+1 bins. torch.stft centres the window in each
    nfft-sample frame, so the rows get (nfft - win) / 2 zeros on each side
    to frame the samples K1 frames."""
    import torch
    import torch.nn.functional as F

    pad = (cfg.nfft - cfg.win_length) // 2
    xp = F.pad(xe, (pad, cfg.nfft - cfg.win_length - pad))
    window = torch.hamming_window(cfg.win_length, periodic=False,
                                  dtype=xe.dtype, device=xe.device)
    return lambda: torch.stft(xp, cfg.nfft, cfg.hop_length, cfg.win_length,
                              window, center=False,
                              return_complex=True).abs()


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


def bits(t):
    """An integer view of a float tensor, for bitwise comparison."""
    import torch

    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


def reset_counts(wrappers) -> None:
    for w in wrappers.values():
        w.launches = 0


def read_counts(wrappers) -> dict:
    return {k: w.launches for k, w in wrappers.items()}


def add_timing(timings: dict, work: dict, name: str, ms: list,
               nbytes: float, ops: float) -> str:
    """Add one launch shape's (kernel, plain[, library]) ms and its work;
    a kernel whose plain version is its library call passes two times.
    Returns the shape's bound and its share, for the shape's line."""
    k, p = ms[0], ms[1]
    lib = ms[2] if len(ms) > 2 else p
    for i, v in enumerate((k, p, lib)):
        timings[name][i] += v
    work[name][0] += nbytes
    work[name][1] += ops
    bound, by = bound_ms(nbytes, ops)
    return f"bound {bound:.5f} ms ({by}), {bound / k:.1%} of it"


def k2_backward_phase(card: str, timings: dict, errs: dict,
                      work: dict) -> None:
    """K2 with-index forward and backward vs their plain versions at the
    train step's pool inputs (phase 7)."""
    import torch
    import torch.nn.functional as F

    from mcncrossmodalemotions_torch.ops import pool

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    # post-ReLU in both dtypes, then small integers cast to bf16: ties in
    # nearly every window, where only the first maximum in row-major window
    # order gives the plain version's idx
    cases = [(label, shape, kind, dtype)
             for label, shape in pool_inputs(TRAIN_BATCH, 400, 512).items()
             for kind, dtype in (("post-ReLU", torch.bfloat16),
                                 ("post-ReLU", torch.float32),
                                 ("tie-heavy", torch.bfloat16))]
    cases += [("even H and W", EVEN_POOL, "post-ReLU", torch.bfloat16),
              ("even H and W", EVEN_POOL, "post-ReLU", torch.float32),
              ("narrow", NARROW_POOL, "tie-heavy", torch.bfloat16)]
    for label, shape, kind, dtype in cases:
        gen.manual_seed(SEED)
        if kind == "tie-heavy":
            x = torch.randint(0, 3, shape, device=dev, generator=gen).to(dtype)
        else:
            x = torch.relu(torch.randn(shape, device=dev,
                                       generator=gen)).to(dtype)
        y, idx = pool.max_pool_3x3s2_idx_cuda(x)
        dy = torch.randn(y.shape, device=dev, generator=gen).to(dtype)
        dx = pool.max_pool_3x3s2_bwd_cuda(dy, idx, *shape[1:3])
        y_free = pool.max_pool_3x3s2_cuda(x)
        ref_y, ref_idx = pool.max_pool_3x3s2_with_index(x)
        ref_y = ref_y.contiguous()
        same_y = torch.equal(bits(y), bits(ref_y))
        same_free = torch.equal(bits(y), bits(y_free))
        errs["max_pool_3x3s2_idx"] = max(
            errs["max_pool_3x3s2_idx"],
            (y.float() - ref_y.float()).abs().max().item())
        same_idx = torch.equal(idx, ref_idx)
        ref = pool.max_pool_3x3s2_backward(x, dy).contiguous()
        torch.cuda.synchronize()
        same_dx = torch.equal(bits(dx), bits(ref))
        same_mask = torch.equal(dx != 0, ref != 0)
        err = (dx.float() - ref.float()).abs().max().item()
        errs["max_pool_3x3s2_bwd"] = max(errs["max_pool_3x3s2_bwd"], err)
        print(f"  K2 backward {label} {shape} {dtype} {kind}: with-index y "
              f"{'bitwise equal' if same_y else 'DIFFERENT'} to F.max_pool2d "
              f"and {'bitwise equal' if same_free else 'DIFFERENT'} to the "
              f"index-free kernel's, idx "
              f"{'equal to' if same_idx else 'DIFFERENT from'} the plain "
              f"code; dx {'bitwise equal' if same_dx else 'DIFFERENT'} "
              f"(winner mask {'identical' if same_mask else 'DIFFERENT'}, "
              f"max abs {err:.3e})", flush=True)
        check(same_y, f"K2 with-index {label} {dtype} {kind}: y not "
              "bitwise equal to F.max_pool2d")
        check(same_free, f"K2 with-index {label} {dtype} {kind}: y not "
              "bitwise equal to the index-free kernel's")
        check(same_idx, f"K2 with-index {label} {dtype} {kind}: idx not "
              "the plain version's code")
        check(same_dx, f"K2 backward {label} {dtype} {kind}: dx not "
              "bitwise equal to autograd of F.max_pool2d")
        if label in ("pool1", "pool2") and kind == "post-ReLU" \
                and dtype == torch.bfloat16:  # timed
            nchw = x.permute(0, 3, 1, 2)
            p, k = turns_ms(lambda: F.max_pool2d(nchw, 3, 2,
                                                 return_indices=True),
                            lambda: pool.max_pool_3x3s2_idx_cuda(x))
            b = add_timing(timings, work, "max_pool_3x3s2_idx", [k, p],
                           2 * x.numel() + 3 * y.numel(), 8 * y.numel())
            print(f"  {card}: K2 with-index {label} {shape} bf16: kernel "
                  f"{k:.4f} ms, plain (max_pool2d_with_indices) {p:.4f} "
                  f"ms; {b}")
            xg = x.detach().requires_grad_(True)
            yg = F.max_pool2d(xg.permute(0, 3, 1, 2), 3, 2).permute(0, 2, 3, 1)
            p, k = turns_ms(
                lambda: torch.autograd.grad(yg, xg, dy, retain_graph=True),
                lambda: pool.max_pool_3x3s2_bwd_cuda(dy, idx, *shape[1:3]))
            b = add_timing(timings, work, "max_pool_3x3s2_bwd", [k, p],
                           3 * dy.numel() + 2 * dx.numel(), 4 * dx.numel())
            print(f"  {card}: K2 backward {label} {shape} bf16: kernel "
                  f"{k:.4f} ms, plain (max_pool2d_with_indices_backward) "
                  f"{p:.4f} ms; {b}", flush=True)
            del xg, yg
        del x, y, y_free, ref_y, ref_idx, idx, dy, dx, ref
        torch.cuda.empty_cache()


def train_phase(card: str, wrappers: dict) -> dict:
    """The full-width train step with and without the kernels (phase 8);
    returns the kernel steps' launch counts."""
    import numpy as np
    import torch

    from mcncrossmodalemotions_torch.ops.spectrogram import DEFAULT_SPEC
    from mcncrossmodalemotions_torch.train.state import (
        SGDConfig,
        TrainState,
        make_train_step,
    )
    from mcncrossmodalemotions_torch.zoo import (
        build_student,
        random_student_variables,
        student_loss_fn,
        student_state_dict_from_flax,
    )

    dev = torch.device("cuda")
    v = random_student_variables(seed=SEED)
    init = student_state_dict_from_flax(
        {"params": {"net": v["params"]}, "batch_stats": {"net": v["batch_stats"]}})
    gen = torch.Generator(device=dev).manual_seed(SEED)
    n = DEFAULT_SPEC.crop_samples(400)
    batch = {
        "data": (torch.randn(TRAIN_BATCH, n, device=dev, generator=gen)
                 * 0.1 * 32767).round().clamp(-32768, 32767).to(torch.int16),
        "logit_target": torch.randn(TRAIN_BATCH, 8, device=dev,
                                    generator=gen) * 2,
        "max_label": torch.randint(0, 8, (TRAIN_BATCH,), device=dev,
                                   generator=gen, dtype=torch.int32),
        "pad_mask": torch.ones(TRAIN_BATCH, device=dev),
    }
    loss_fn = student_loss_fn("hot-cross-ent", temperature=2.0)
    runs = {}
    for mode in ("kernels", "plain"):
        model = build_student()  # full width, bf16 compute, fp32 params
        model.load_state_dict(init)
        state = TrainState.create(model.to(dev),
                                  torch.Generator(device=dev).manual_seed(SEED))
        step = make_train_step(loss_fn, SGDConfig(weight_decay=0.0),
                               pass_pad_mask=True,
                               use_kernels=mode == "kernels")
        w0 = state.model.net.conv1.weight.detach().clone()
        reset_counts(wrappers)
        losses = []
        for _ in range(3):
            state, m = step(state, batch, TRAIN_LR)
            losses.append(m["loss"].item())
        counts = read_counts(wrappers)
        update = state.model.net.conv1.weight.detach() - w0
        torch.cuda.reset_peak_memory_stats()
        for _ in range(WARMUP_STEPS):
            step(state, batch, TRAIN_LR)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(TIMED_STEPS):
            state, m = step(state, batch, TRAIN_LR)
        torch.cuda.synchronize()
        step_s = (time.perf_counter() - t0) / TIMED_STEPS
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        runs[mode] = dict(losses=losses, counts=counts, update=update,
                          step_s=step_s)
        print(f"  train {mode}: losses {losses}; launches over 3 steps "
              f"{counts}", flush=True)
        print(f"  {card}: train step {mode}: {1e3 * step_s:.3f} ms = "
              f"{TRAIN_BATCH / step_s:.2f} utts/s (mean of {TIMED_STEPS} steps "
              f"after {WARMUP_STEPS} warm-up), peak memory {peak:.2f} GiB",
              flush=True)
        del state, step, model
        torch.cuda.empty_cache()

    k, p = runs["kernels"], runs["plain"]
    check(all(np.isfinite(k["losses"] + p["losses"])), "non-finite train loss")
    rel = max(abs(a - b) / abs(b) for a, b in zip(k["losses"], p["losses"]))
    upd = ((k["update"] - p["update"]).norm() / p["update"].norm()).item()
    print(f"  train kernels vs plain: max loss rel diff {rel:.3e} (gate "
          f"{TRAIN_LOSS_RTOL}); conv1 update rel L2 {upd:.3e} (gate "
          f"{TRAIN_UPDATE_RTOL})")
    check(rel <= TRAIN_LOSS_RTOL, "kernel-on train losses disagree with plain")
    check(upd <= TRAIN_UPDATE_RTOL, "kernel-on conv1 update disagrees with plain")
    want = {k: 0 for k in wrappers} | {"spectrogram": 3,
                                       "max_pool_3x3s2_idx": 6,
                                       "max_pool_3x3s2_bwd": 6}
    check(k["counts"] == want, f"train launches {k['counts']}, expected {want}")
    check(not any(p["counts"].values()), f"plain steps launched {p['counts']}")
    return k["counts"]


def distill_phase(root: Path, wrappers: dict) -> tuple:
    """``run_distillation`` end to end, then its resume (phase 9); returns
    the first call's launch counts and the synthetic imdb."""
    import numpy as np

    from mcncrossmodalemotions_torch.data.emovox import build_synthetic_imdb
    from mcncrossmodalemotions_torch.exp.run_distillation import (
        DistillationConfig,
        run_distillation,
    )
    from mcncrossmodalemotions_torch.train.checkpoints import list_checkpoints

    imdb = build_synthetic_imdb(root / "wav", num_speakers=8,
                                tracks_per_speaker=20, seed=SEED)
    kw = dict(batch_size=64, mini_epoch_ratio=1.0, out_root=str(root / "exps"),
              seed=SEED)
    reset_counts(wrappers)
    t0 = time.perf_counter()
    _, history, exp_dir = run_distillation(DistillationConfig(num_epochs=2, **kw),
                                           imdb, device="cuda")
    wall = time.perf_counter() - t0
    counts = read_counts(wrappers)
    for h in history:
        tr = h["train"]
        print(f"  distill epoch {h['epoch']}: train loss {tr['loss']:.4f}, "
              f"{tr['num_samples']} samples, {tr['samples_per_sec']:.2f} "
              f"samples/s, feed_bound_frac {tr['feed_bound_frac']}, "
              f"feed_wait_s {tr['feed_wait_s']}, device_drain_s "
              f"{tr['device_drain_s']}; val loss {h['val']['loss']:.4f} "
              f"({h['val']['num_samples']} samples)", flush=True)
    print(f"  distill: 2 epochs in {wall:.2f} s; launches {counts}")
    check([h["epoch"] for h in history] == [1, 2], "distill epochs")
    check(all(h["train"]["num_samples"] == 128 for h in history),
          "an epoch did not run 2 full batches of 64")
    check(all(np.isfinite(h["train"]["loss"]) and np.isfinite(h["val"]["loss"])
              for h in history), "non-finite distill loss")
    check([e for e, _ in list_checkpoints(exp_dir)] == [1, 2],
          "checkpoints 1 and 2 missing")
    check(len((exp_dir / "metrics.jsonl").read_text().splitlines()) == 2,
          "metrics.jsonl lacks the two epochs")
    n_val = history[0]["val"]["num_samples"]
    val_batches = -(-n_val // 64)
    want = {k: 0 for k in wrappers} | {
        "spectrogram": 2 * (2 + val_batches),
        "max_pool_3x3s2": 2 * 2 * val_batches,
        "max_pool_3x3s2_idx": 2 * 2 * 2, "max_pool_3x3s2_bwd": 2 * 2 * 2}
    check(counts == want, f"distill launches {counts}, expected {want}")
    _, history, _ = run_distillation(DistillationConfig(num_epochs=3, **kw),
                                     imdb, device="cuda")
    print(f"  distill resume: ran epochs {[h['epoch'] for h in history]}, "
          f"feed_bound_frac {history[-1]['train']['feed_bound_frac']}")
    check([h["epoch"] for h in history] == [3], "resume did not start at epoch 3")
    check([e for e, _ in list_checkpoints(exp_dir)] == [1, 2, 3],
          "checkpoint 3 missing")
    return counts, imdb


def probe_work(probe) -> tuple:
    """(bytes, operations) a probe's kernel needs: each input element it
    reads (a gather reads only the rows its index names) and each output
    element once."""
    import numpy as np

    from mcncrossmodalemotions_torch.ops import probes

    if probe.kernel is probes.probe_gather:
        x, index, axis = probe.args
        n_out = index.values.numel()
        rows = x.numel() // x.shape[axis]
        used = len(np.unique(index.values.cpu().numpy()))
        return (used * rows * x.element_size() + 4 * n_out
                + 4 * rows * n_out, 0)
    if probe.kernel is probes.probe_select_matmul:
        (m, k), n = probe.args[0].shape, probe.args[1].shape[1]
        return 4 * (m * k + k * n + m * n), 2 * m * k * n
    # probe_col_candidates: 2 compares, 1 and and 2 adds per output
    x, y, dy = probe.args
    return 4 * (2 * x.numel() + y.numel() + dy.numel()), 5 * x.numel()


def probes_phase(card: str, wrappers: dict, timings: dict, errs: dict,
                 work: dict) -> dict:
    """Both probe tools on the card, then each probe kernel against its
    plain version and timed (phase 10); returns the tools' launch counts."""
    import numpy as np
    import torch

    from mcncrossmodalemotions_torch.ops import probes
    from mcncrossmodalemotions_torch.tools import probe_mosaic, probe_mosaic2

    dev = torch.device("cuda")
    reset_counts(wrappers)
    results = {**probe_mosaic.main(dev), **probe_mosaic2.main(dev)}
    counts = read_counts(wrappers)
    failed = [n for n, (ran, ok) in results.items() if not (ran and ok)]
    print(f"  probes: {len(results)} run, launches {counts}", flush=True)
    check(len(results) == N_PROBES and not failed,
          f"probes that failed or did not match numpy: {failed}")
    want = {k: 0 for k in wrappers} | {"probe_gather": N_PROBES - 2,
                                       "probe_select_matmul": 1,
                                       "probe_col_candidates": 1}
    check(counts == want, f"probe launches {counts}, expected {want}")

    one, one_index = torch.zeros(1, device=dev), probes.index_map([0], 1, dev)
    floor = cuda_ms(lambda: probes.probe_gather(one, one_index, 0), PROBE_ITERS)
    print(f"  {card}: launch floor (a one-element probe_gather, queued): "
          f"{floor:.5f} ms", flush=True)
    library = {probes.probe_gather: lambda x, index, axis: torch.index_select(
                   x, axis, index.values),
               probes.probe_select_matmul: torch.matmul}
    for p in probe_mosaic.make_probes(dev) + probe_mosaic2.make_probes(dev):
        name = p.kernel.__name__
        got, ref = p.run(), p.run(plain=True)
        torch.cuda.synchronize()
        same = got.shape == ref.shape and torch.equal(bits(got), bits(ref))
        err = (got - ref).abs().max().item()
        errs[name] = max(errs[name], err)
        exact = np.array_equal(got.cpu().numpy(), p.expect)
        fns = [lambda: p.run(plain=True), lambda: p.run()]
        if p.kernel in library:
            fns.append(lambda: library[p.kernel](*p.args))
        ms = turns_ms(*fns, iters=PROBE_ITERS)
        b = add_timing(timings, work, name, [ms[1], ms[0], *ms[2:]],
                       *probe_work(p))
        least = max(bound_ms(*probe_work(p))[0], floor)
        b += (f"; launch floor {floor:.5f} ms, {least / ms[1]:.1%} of "
              f"max(bound, floor)")
        print(f"  {card}: {p.name} ({name}): kernel "
              f"{'bitwise equal to' if same else 'DIFFERENT from'} plain, "
              f"{'exactly' if exact else 'not exactly'} numpy's expect; "
              f"kernel {ms[1]:.5f} ms, plain {ms[0]:.5f} ms"
              + (f", library {ms[2]:.5f} ms" if len(ms) > 2 else "")
              + f"; {b}", flush=True)
        check(same, f"{p.name}: kernel not bitwise equal to its plain version")
        if p.kernel is probes.probe_select_matmul:
            check(exact, f"{p.name}: kernel not exactly numpy's expect")

    gen = torch.Generator(device=dev)
    for m, k, n in ((16, 128, 256), (5, 37, 70)):  # the probe's, ragged
        gen.manual_seed(SEED)
        a = torch.randn(m, k + 3, device=dev, generator=gen)[:, :k]
        b = torch.randn(k, n, device=dev, generator=gen)
        got = probes.probe_select_matmul(a, b).double()
        a, b = a.double(), b.double()
        err = ((got - a @ b).abs() / (a.abs() @ b.abs())).max().item()
        print(f"  P9 on random [{m},{k}] (row stride {k + 3}) @ [{k},{n}]: "
              f"max |c - c64| / (|a| @ |b|) {err:.3e} (gate {P9_RTOL})",
              flush=True)
        check(err <= P9_RTOL, f"P9 random {m}x{k}x{n}: {err:.3e} > {P9_RTOL}")

    # P12's own inputs are independent normals, so x == y never holds and
    # its expect is all zeros; small integers make both branches fire.
    t, w, c, wh = probe_mosaic2.T, probe_mosaic2.W, probe_mosaic2.C, probe_mosaic2.WH
    gen.manual_seed(SEED)
    x = torch.randint(0, 3, (t, w, c), device=dev, generator=gen).float()
    y = torch.randint(0, 3, (t, wh, c), device=dev, generator=gen).float()
    dy = torch.randn(t, wh, c, device=dev, generator=gen)
    got = probes.probe_col_candidates(x, y, dy)
    ref = probes.col_candidates(x, y, dy)
    torch.cuda.synchronize()
    same = torch.equal(bits(got), bits(ref))
    even = (torch.arange(w, device=dev) % 2 == 0).view(1, w, 1)
    shares = []  # per branch: the share of outputs it adds a nonzero to
    for k2 in (0, 1):
        yc = torch.repeat_interleave(y[:, 1 - k2:], 2, dim=1)[:, :w]
        dyc = torch.repeat_interleave(dy[:, 1 - k2:], 2, dim=1)[:, :w]
        fired = (x == yc) & (dyc != 0)
        if k2:
            fired = fired & even
        shares.append(fired.float().mean().item())
    nonzero = (got != 0).float().mean().item()
    print(f"  P12 on small-integer inputs: kernel "
          f"{'bitwise equal to' if same else 'DIFFERENT from'} plain; "
          f"nonzero shares: branch k2=0 {shares[0]:.4f}, k2=1 {shares[1]:.4f}, "
          f"output {nonzero:.4f}", flush=True)
    check(same, "P12 on ties: kernel not bitwise equal to its plain version")
    check(min(shares) > 0 and nonzero > 0, "P12 on ties: a branch never fired")
    return counts


def sync(dev) -> None:
    import torch

    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def extraction_chunks(paths, batch: int = BATCH) -> list:
    """(rows, t_pad, bucket) of every chunk the extractor launches the
    kernels for over ``paths``: tracks grouped by (t_pad, bucket), cut
    into chunks of ``batch``."""
    from mcncrossmodalemotions_torch.exp.compute_audio_feats import (
        AudioFeatureExtractor,
    )

    meta = AudioFeatureExtractor(None, {})
    groups: dict = {}
    for p in paths:
        _, bucket, t_pad = meta._meta(str(p))[:3]
        groups[(t_pad, bucket)] = groups.get((t_pad, bucket), 0) + 1
    return [(min(batch, count - k), t_pad, bucket)
            for (t_pad, bucket), count in sorted(groups.items())
            for k in range(0, count, batch)]


def imdb_paths(imdb) -> list:
    """The wav paths ``compute_audio_feats`` reads for ``imdb``."""
    wav_dir = getattr(imdb, "wav_dir", "")
    return [str(Path(wav_dir) / p) for p in imdb.wav_paths]


def extraction_launches(wrappers: dict, imdb) -> dict:
    """The launches an extraction with kernels makes over ``imdb``: K1
    once and the index-free K2 twice per chunk."""
    n = len(extraction_chunks(imdb_paths(imdb)))
    return {k: 0 for k in wrappers} | {"spectrogram": n, "max_pool_3x3s2": 2 * n}


def add_counts(total: dict, counts: dict) -> None:
    for k, v in counts.items():
        total[k] += v


def student_release(path: Path, seed: int = SEED, fc6: int = 4096,
                    fc7: int = 1024) -> dict:
    """Write a classic (v5) MatConvNet student ``.mat`` from seeded weights,
    every conv and fc6 with a nonzero bias and its BN mean moved by that
    bias, so the release computes what the seeded weights compute (the
    importer folds the bias back: mean - bias). Returns the seeded weights
    in the Flax layout."""
    import numpy as np
    import scipy.io

    from mcncrossmodalemotions_torch.zoo import random_student_variables
    from mcncrossmodalemotions_torch.zoo.matconvnet import BN_EPSILON

    v = random_student_variables(seed=seed, fc6=fc6, fc7=fc7)
    p, s = v["params"], v["batch_stats"]
    rng = np.random.default_rng(seed + 1)
    named = {}
    for i, conv in enumerate(("conv1", "conv2", "conv3", "conv4", "conv5",
                              "fc6"), 1):
        kernel = p[conv]["kernel"]
        bias = rng.normal(0.0, 0.5, kernel.shape[-1]).astype(np.float32)
        named[f"{conv}f"], named[f"{conv}b"] = kernel, bias
        named[f"bn{i}f"], named[f"bn{i}b"] = p[f"bn{i}"]["scale"], p[f"bn{i}"]["bias"]
        sigma = np.sqrt(s[f"bn{i}"]["var"] + BN_EPSILON)
        named[f"bn{i}m"] = np.stack([s[f"bn{i}"]["mean"] + bias, sigma], axis=1)
    named["fc7f"], named["fc7b"] = p["fc7"]["kernel"][None, None], p["fc7"]["bias"]
    named["fc8f"] = p["prediction"]["kernel"][None, None]
    named["fc8b"] = p["prediction"]["bias"]
    arr = np.zeros((len(named),), dtype=[("name", object), ("value", object)])
    for i, item in enumerate(named.items()):
        arr[i] = item
    scipy.io.savemat(path, {"net": {"params": arr}})
    return v


def reader_phase(card: str, imdb, wrappers: dict, dev="cuda",
                 widths: tuple = (4096, 1024)) -> dict:
    """The port's own wav reader library (built in the build phase with the
    host's g++): it, not Python, serves extraction; its crops are bitwise
    the Python reads' over the smoke's tracks, through both
    ``ds_read_crops`` and ``ds_read_crops_packed``; extraction's tracks/s
    with it and with Python reads, in turns, over windows of the tracks
    read ``READER_REPEATS`` times. Returns the launches of the extractions
    that read through it."""
    import os

    import numpy as np

    from mcncrossmodalemotions_torch.data import audio, native_audio
    from mcncrossmodalemotions_torch.exp import compute_audio_feats as feats
    from mcncrossmodalemotions_torch.models.vggm import VGGMStudent
    from mcncrossmodalemotions_torch.ops.spectrogram import DEFAULT_SPEC
    from mcncrossmodalemotions_torch.zoo import (
        random_student_variables,
        student_state_dict_from_flax,
    )

    check(feats.wav_reader() is native_audio,
          "extraction does not read through the port's wav library")
    paths = imdb_paths(imdb)
    rng = np.random.default_rng(SEED)
    meta = feats.AudioFeatureExtractor(None, {})
    by_t_pad: dict = {}
    for p in paths:
        by_t_pad.setdefault(meta._meta(p)[2], []).append(p)
    for t_pad, group in sorted(by_t_pad.items()):
        need = DEFAULT_SPEC.crop_samples(t_pad)
        for starts in ([0] * len(group),
                       [int(rng.integers(0, audio.wav_info(p).num_samples))
                        for p in group]):
            crops = native_audio.read_crops(group, starts, need)
            packed = native_audio.read_crops_packed(group, starts, need)
            python = np.zeros_like(crops)
            for row, path, start in zip(python, group, starts):
                got, _ = audio.read_wav(path, start, need)
                row[:len(got)] = got
            same = crops.view(np.int32).tobytes() == python.view(np.int32).tobytes()
            same_packed = np.array_equal(packed, audio.pack_pcm16(python))
            print(f"  t_pad {t_pad}: {len(group)} tracks x {need} samples from "
                  f"{'0' if not any(starts) else 'random starts'}: ds_read_crops "
                  f"{'bitwise equal to' if same else 'DIFFERENT from'} the "
                  f"Python reads, ds_read_crops_packed "
                  f"{'bitwise equal to' if same_packed else 'DIFFERENT from'} "
                  f"their pack_pcm16", flush=True)
            check(same and same_packed,
                  f"the port's reader differs from Python at t_pad {t_pad}")

    fc6, fc7 = widths
    model = VGGMStudent(fc6_features=fc6, fc7_features=fc7)
    state = student_state_dict_from_flax(
        random_student_variables(seed=SEED, fc6=fc6, fc7=fc7))
    # each timed window reads the track list READER_REPEATS times over
    window = paths * READER_REPEATS
    chunks = len(extraction_chunks(window))
    want = {k: 0 for k in wrappers} | {"spectrogram": chunks,
                                        "max_pool_3x3s2": 2 * chunks}
    counts = {k: 0 for k in wrappers}
    runs = {"library": [], "python": []}
    logits = {}
    order = ("library", "python", "python", "library")
    for mode in order:
        if mode == "python":
            os.environ["MCNCME_DISABLE_NATIVE"] = "1"
        try:
            ex = feats.AudioFeatureExtractor(model, state, batch_size=BATCH,
                                             device=dev)
            reset_counts(wrappers)
            t0 = time.perf_counter()
            out = ex.track_logits(window, verbose=False)
            sync(dev)
            runs[mode].append(time.perf_counter() - t0)
        finally:
            os.environ.pop("MCNCME_DISABLE_NATIVE", None)
        got = read_counts(wrappers)
        check(got == want, f"reader {mode}: launches {got}, expected {want}")
        if mode == "library":
            add_counts(counts, got)
            check(ex.readers == {"native-packed"},
                  f"extraction read with {ex.readers}, not the port's library")
        else:
            check(ex.readers == {"python"}, f"python run read with {ex.readers}")
        logits.setdefault(mode, np.concatenate(out))
    a, b = logits["library"], logits["python"]
    diff = float(np.abs(a - b).max())
    print(f"  logits, library reads vs Python reads: max abs {diff:.3e} "
          f"({'bitwise equal' if np.array_equal(a, b) else 'not bitwise equal'})")
    check(diff <= SLICE_REL_TOL * float(np.abs(b).max()),
          "library-read logits disagree with Python-read ones")
    rates = {mode: ", ".join(f"{len(window) / w:.2f} in {w:.3f} s"
                             for w in walls) for mode, walls in runs.items()}
    print(f"  {card}: extraction tracks/s, library reads {rates['library']}; "
          f"Python reads {rates['python']} (in turns: {', '.join(order)}; "
          f"{len(paths)} tracks x {READER_REPEATS} a window, batch {BATCH})",
          flush=True)
    return counts


def release_phase(card: str, root: Path, imdb, distill_imdb, wrappers: dict,
                  dev="cuda", widths: tuple = (4096, 1024),
                  batch: int = 64) -> tuple:
    """A released student at full width: a classic ``.mat`` written from
    seeded weights with nonzero conv biases, loaded on the card by
    ``load_pretrained_student``; its extraction logits against the same
    weights through the bridge, biases already folded (the extraction
    gate); one ``run_distillation`` epoch from the file, and
    ``load_student_from_exp(..., 'best')`` bitwise equal to the
    checkpoint's state. Returns (launches, model, state)."""
    import numpy as np
    import torch

    from mcncrossmodalemotions_torch.exp.compute_audio_feats import (
        compute_audio_feats,
    )
    from mcncrossmodalemotions_torch.exp.run_distillation import (
        DistillationConfig,
        load_student_from_exp,
        run_distillation,
    )
    from mcncrossmodalemotions_torch.models.vggm import VGGMStudent
    from mcncrossmodalemotions_torch.train.checkpoints import (
        checkpoint_path,
        read_checkpoint,
    )
    from mcncrossmodalemotions_torch.zoo import (
        load_pretrained_student,
        student_state_dict_from_flax,
    )

    fc6, fc7 = widths
    mat = root / "emovoxceleb-student.mat"
    t0 = time.perf_counter()
    seeded = student_release(mat, fc6=fc6, fc7=fc7)
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    model, state = load_pretrained_student(mat, with_frontend=False, device=dev)
    load_s = time.perf_counter() - t0
    check(model.fc6.weight.shape[0] == fc6 and model.fc7.weight.shape[0] == fc7
          and model.prediction.weight.shape[0] == 8, "release widths")
    check(all(v.device.type == torch.device(dev).type for v in state.values()),
          "the release's state is not on the card")
    print(f"  release {mat.stat().st_size / 2**20:.1f} MiB written in "
          f"{write_s:.2f} s, loaded in {load_s:.2f} s (fc6 {fc6}, fc7 {fc7}, "
          "8 outputs)", flush=True)
    counts = {k: 0 for k in wrappers}
    reset_counts(wrappers)
    got = compute_audio_feats(imdb, model, state, batch_size=BATCH,
                              verbose=False, device=dev)
    sync(dev)
    launches = read_counts(wrappers)
    want = extraction_launches(wrappers, imdb)
    check(launches == want, f"release extraction launches {launches}, "
          f"expected {want}")
    add_counts(counts, launches)
    bare = VGGMStudent(fc6_features=fc6, fc7_features=fc7)
    ref = compute_audio_feats(imdb, bare, student_state_dict_from_flax(seeded),
                              batch_size=BATCH, verbose=False, device=dev)
    got, ref = np.concatenate(got), np.concatenate(ref)
    check(got.shape == (len(imdb.wav_paths), 8) and np.isfinite(got).all(),
          "release logits not finite [N, 8]")
    scale, diff = float(np.abs(ref).max()), float(np.abs(got - ref).max())
    print(f"  release logits vs the seeded weights through the bridge: max "
          f"abs {diff:.3e}, max |logit| {scale:.3f}, rel {diff / scale:.3e} "
          f"(gate {SLICE_REL_TOL})", flush=True)
    check(diff <= SLICE_REL_TOL * scale, "release logits disagree")

    cfg = DistillationConfig(num_epochs=1, from_scratch=False,
                             pretrained_student=str(mat), batch_size=batch,
                             mini_epoch_ratio=1.0, seed=SEED,
                             out_root=str(root / "exps-release"))
    reset_counts(wrappers)
    t0 = time.perf_counter()
    _, history, exp_dir = run_distillation(cfg, distill_imdb, device=dev)
    wall = time.perf_counter() - t0
    launches = read_counts(wrappers)
    h = history[0]
    print(f"  from-release epoch: train loss {h['train']['loss']:.4f} over "
          f"{h['train']['num_samples']} samples, val loss "
          f"{h['val']['loss']:.4f}, {wall:.2f} s; launches {launches}",
          flush=True)
    check([r["epoch"] for r in history] == [1]
          and np.isfinite(h["train"]["loss"]), "from-release epoch")
    val_batches = -(-h["val"]["num_samples"] // batch)
    train_batches = h["train"]["num_samples"] // batch
    want = {k: 0 for k in wrappers} | {
        "spectrogram": train_batches + val_batches,
        "max_pool_3x3s2": 2 * val_batches,
        "max_pool_3x3s2_idx": 2 * train_batches,
        "max_pool_3x3s2_bwd": 2 * train_batches}
    check(launches == want, f"from-release launches {launches}, expected {want}")
    add_counts(counts, launches)
    _, best = load_student_from_exp(exp_dir, "best", device=dev)
    saved = read_checkpoint(checkpoint_path(exp_dir, 1))["model"]
    same = (sorted(best) == sorted(k[len("net."):] for k in saved)
            and all(torch.equal(v.cpu(), saved["net." + k])
                    for k, v in best.items()))
    print(f"  load_student_from_exp(best): {len(best)} tensors "
          f"{'bitwise equal to' if same else 'DIFFERENT from'} checkpoint 1's",
          flush=True)
    check(same, "load_student_from_exp does not give back the checkpoint")
    return counts, model, state


def swapped_pairs(positive, a, b) -> list:
    """(positive, negative) row pairs of two score vectors whose order
    differs between ``a`` and ``b``; each such pair moves an AUC over
    these rows by 1 / (positives x negatives)."""
    import numpy as np

    pos, neg = np.flatnonzero(positive), np.flatnonzero(~positive)
    order_a = np.sign(a[pos][:, None] - a[neg][None, :])
    order_b = np.sign(b[pos][:, None] - b[neg][None, :])
    i, j = np.nonzero(order_a != order_b)
    return [(int(pos[x]), int(neg[y])) for x, y in zip(i, j)]


def compare_stats(a: tuple, b: tuple, imdb) -> dict:
    """Two ``student_stats`` runs, each (result, [N, C] logits), partition
    by partition: {partition: (largest per-emotion AUC gap, its emotion,
    [(emotion, imdb track pairs whose order differs)], pairs compared)},
    the pairs counted over every emotion with an AUC."""
    import numpy as np

    from mcncrossmodalemotions_torch import EMOTIONS
    from mcncrossmodalemotions_torch.exp.student_stats import (
        PARTITIONS,
        softmax_np,
        teacher_labels,
    )

    labels = teacher_labels(imdb)
    (res_a, logits_a), (res_b, logits_b) = a, b
    scores_a, scores_b = softmax_np(logits_a, axis=1), softmax_np(logits_b, axis=1)
    out = {}
    for part, row in res_a.items():
        check(list(row) == list(res_b[part]), f"{part}: other emotions")
        mask = imdb.set_id == PARTITIONS[part]
        tracks = np.flatnonzero(mask)
        gap, worst, swaps, pairs = 0.0, "no emotion", [], 0
        for emotion, auc in row.items():
            if emotion == "meanAuc":
                continue
            c = EMOTIONS.index(emotion)
            positive = labels[mask] == c
            pairs += int(positive.sum()) * int((~positive).sum())
            diff = abs(auc - res_b[part][emotion])
            if diff >= gap:
                gap, worst = diff, emotion
            swaps += [(emotion, (tracks[i], tracks[j])) for i, j in
                      swapped_pairs(positive, scores_a[mask, c],
                                    scores_b[mask, c])]
        out[part] = (gap, worst, swaps, pairs)
    return out


def analysis_phase(card: str, root: Path, model, state, distill_imdb,
                   wrappers: dict, dev="cuda",
                   widths: tuple = (4096, 1024)) -> dict:
    """The student's analysis on the card: ``student_stats`` over the
    distill phase's imdb with the released student, extraction with the
    kernels and plain. In fp32, where the two differ only by K1's
    summation order, each per-emotion AUC within 0.02. In bf16, the
    default, the rounding of the conv inputs moves logits by about 1e-2
    relative, which swaps near-tied tracks of the random student, and a
    few swaps in a partition of a few tracks move an AUC by more than
    0.02: there the kernels may reorder, partition by partition, at most
    twice as many (positive, negative) track pairs (and one) as bf16
    itself reorders on the plain path against fp32. Then
    ``emo_benchmarks`` (bf16) over a synthetic external set of 60 tracks
    in 6 classes with 5 folds. Returns the kernel runs' launches."""
    import numpy as np
    import torch

    from mcncrossmodalemotions_torch.data.external import (
        build_synthetic_track_imdb,
    )
    from mcncrossmodalemotions_torch.data.imdb import float_tracks
    from mcncrossmodalemotions_torch.exp.compute_audio_feats import (
        compute_audio_feats,
    )
    from mcncrossmodalemotions_torch.exp.emo_benchmarks import emo_benchmarks
    from mcncrossmodalemotions_torch.exp.student_stats import student_stats
    from mcncrossmodalemotions_torch.models.vggm import VGGMStudent

    counts = {k: 0 for k in wrappers}
    want = extraction_launches(wrappers, distill_imdb)
    fp32 = VGGMStudent(fc6_features=widths[0], fc7_features=widths[1],
                       dtype=torch.float32)
    runs = {}  # (precision, kernels) -> (student_stats result, logits)
    for label, m in (("fp32", fp32), ("bf16", model)):
        for kernels in (True, False):
            feats = root / f"feats-{label}-{'kernels' if kernels else 'plain'}.npz"
            reset_counts(wrappers)
            t0 = time.perf_counter()
            res = student_stats(distill_imdb, model=m, state=state,
                                feat_path=str(feats), verbose=False,
                                use_kernels=kernels, device=dev)
            sync(dev)
            wall = time.perf_counter() - t0
            launches = read_counts(wrappers)
            if kernels:
                check(launches == want, f"student_stats {label} launches "
                      f"{launches}, expected {want}")
                add_counts(counts, launches)
            else:
                check(not any(launches.values()), f"plain launched {launches}")
            runs[label, kernels] = (res, np.concatenate(
                float_tracks(np.load(feats, allow_pickle=True)["logits"])))
        print(f"  student_stats {label} over {distill_imdb.num_tracks} tracks, "
              f"{wall:.2f} s plain", flush=True)
    del fp32

    def rel(a, b):
        return float(np.abs(a - b).max() / np.abs(b).max())

    print(f"  logits max rel difference: bf16 kernels vs plain "
          f"{rel(runs['bf16', True][1], runs['bf16', False][1]):.3e}, bf16 vs "
          f"fp32 plain {rel(runs['bf16', False][1], runs['fp32', False][1]):.3e}"
          f", fp32 kernels vs plain "
          f"{rel(runs['fp32', True][1], runs['fp32', False][1]):.3e}", flush=True)
    fp32 = compare_stats(runs["fp32", True], runs["fp32", False], distill_imdb)
    bf16 = compare_stats(runs["bf16", True], runs["bf16", False], distill_imdb)
    noise = compare_stats(runs["bf16", False], runs["fp32", False], distill_imdb)
    for part, (gap, emotion, swaps, pairs) in fp32.items():
        print(f"  student_stats fp32 {part}: meanAuc "
              f"{runs['fp32', True][0][part]['meanAuc']:.4f} kernels, "
              f"{runs['fp32', False][0][part]['meanAuc']:.4f} plain; max "
              f"per-emotion AUC gap {gap:.4f} ({emotion}; gate {AUC_TOL}), "
              f"{len(swaps)} of {pairs} track pairs reordered", flush=True)
        check(gap <= AUC_TOL, f"fp32 {part}: AUC kernels vs plain {gap:.4f}")
    for part, (gap, emotion, swaps, pairs) in bf16.items():
        ref_gap, ref_emotion, ref_swaps, _ = noise[part]
        print(f"  student_stats bf16 {part}: meanAuc "
              f"{runs['bf16', True][0][part]['meanAuc']:.4f} kernels, "
              f"{runs['bf16', False][0][part]['meanAuc']:.4f} plain; max "
              f"per-emotion AUC gap {gap:.4f} ({emotion}); {len(swaps)} of "
              f"{pairs} track pairs reordered (gate {2 * len(ref_swaps) + 1}); "
              f"bf16 vs fp32 plain: max AUC gap {ref_gap:.4f} ({ref_emotion}), "
              f"{len(ref_swaps)} pairs reordered", flush=True)
        if swaps:
            print(f"    kernels vs plain reorder (emotion: positive, negative "
                  "track): " + ", ".join(f"{e}: {i}, {j}"
                                         for e, (i, j) in swaps[:8])
                  + (", ..." if len(swaps) > 8 else ""), flush=True)
        check(len(swaps) <= 2 * len(ref_swaps) + 1,
              f"bf16 {part}: kernels vs plain reorder {len(swaps)} track "
              f"pairs, bf16 itself {len(ref_swaps)}")

    ext = build_synthetic_track_imdb(root / "external", tracks_per_class=10,
                                     duration=2.0, seed=SEED)
    reset_counts(wrappers)
    logits = compute_audio_feats(ext, model, state, batch_size=BATCH,
                                 verbose=False, device=dev)
    sync(dev)
    launches = read_counts(wrappers)
    want = extraction_launches(wrappers, ext)
    check(launches == want, f"benchmark extraction launches {launches}, "
          f"expected {want}")
    add_counts(counts, launches)
    with contextlib.redirect_stdout(sys.stderr):
        res = emo_benchmarks({"synthetic-rml": dict(
            track_logits=logits, labels=ext.labels,
            classes=list(ext.classes))}, num_folds=5)["synthetic-rml"]
    print(f"  emo_benchmarks over {len(logits)} tracks, 6 classes, 5 folds: "
          f"accuracy {res.mean_accuracy:.4f} +/- {res.std_accuracy:.4f} "
          f"(folds {', '.join(f'{a:.3f}' for a in res.fold_accuracies)})",
          flush=True)
    check(len(res.fold_accuracies) == 5
          and all(0.0 <= a <= 1.0 for a in res.fold_accuracies),
          "emo_benchmarks folds")
    return counts


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
        compute_audio_feats,
    )
    from mcncrossmodalemotions_torch.ops import _build, pool, probes
    from mcncrossmodalemotions_torch.ops.spectrogram import (
        DEFAULT_SPEC,
        preemphasis,
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
    wrappers = {"spectrogram": spectrogram_cuda,
                "max_pool_3x3s2": pool.max_pool_3x3s2_cuda,
                "max_pool_3x3s2_idx": pool.max_pool_3x3s2_idx_cuda,
                "max_pool_3x3s2_bwd": pool.max_pool_3x3s2_bwd_cuda,
                "probe_gather": probes.probe_gather,
                "probe_select_matmul": probes.probe_select_matmul,
                "probe_col_candidates": probes.probe_col_candidates}

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
        libs = ("spectrogram", "max_pool_3x3s2", "probes", "dataservice_audio")
        _build.load(*libs)  # one compiler each, all started together
        for lib in libs:
            log = _build.library_path(lib).with_suffix(".log").read_text()
            for line in log.splitlines():
                if any(w in line for w in ("entry function", "registers",
                                           "spill")):
                    print(f"  {lib}: {line.strip()}")
            compiler = "g++" if lib == "dataservice_audio" else "nvcc"
            print(f"  {lib}: {compiler} {_build.build_seconds[lib]:.2f} s",
                  flush=True)

    with tempfile.TemporaryDirectory() as tmp:
        with phase("data", walls):
            imdb = synthetic_track_imdb(Path(tmp))
            paths = list(imdb.wav_paths)
            # (rows, t_pad, bucket) of every chunk the extractor launches
            chunks = extraction_chunks(paths)
            print(f"  {len(paths)} tracks; chunks (rows, t_pad, bucket): "
                  f"{chunks}")
            check(len({b for _, _, b in chunks}) >= 3, "fewer than three buckets")

        timings = {k: [0.0, 0.0, 0.0] for k in wrappers}  # kernel, plain, library
        work = {k: [0.0, 0.0] for k in wrappers}  # bytes, operations
        errs = {k: 0.0 for k in wrappers}
        with phase("k1", walls):
            bench_n = cfg.crop_samples(400)
            cases = [("bench crop", BATCH, bench_n, torch.float32, False),
                     ("ragged tile", BATCH, cfg.crop_samples(150),
                      torch.float32, False),
                     ("t_pad=1000", BATCH, cfg.crop_samples(1000),
                      torch.float32, False),
                     ("one frame", BATCH, cfg.crop_samples(1), torch.float32,
                      False),
                     ("ragged FT tile", BATCH, cfg.crop_samples(33),
                      torch.int16, False)]
            cases += [(f"slice t_pad={t_pad}", rows, cfg.crop_samples(t_pad),
                       torch.int16, True) for rows, t_pad, _ in chunks]
            cases.append(("train crop", TRAIN_BATCH, bench_n, torch.int16, True))
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
                errs["spectrogram"] = max(errs["spectrogram"], err)
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
                    stft = stft_call(preemphasis(x, cfg.preemph), cfg)
                    mag = stft()
                    half = ref[:, :cfg.num_rbins]
                    srel = ((mag - half).abs().max() / half.abs().max()).item()
                    print(f"  K1 {label}: torch.stft magnitudes vs plain: max "
                          f"rel {srel:.3e}")
                    check(mag.shape == half.shape and srel <= STFT_REL_TOL,
                          f"torch.stft {label}: {tuple(mag.shape)}, rel {srel:.3e}")
                    p, k, lib = turns_ms(lambda: spectrogram(x, cfg),
                                         lambda: spectrogram_cuda(x, cfg), stft)
                    nbytes = 2 * x.numel() + 4 * got.numel()
                    ops, dft_ops = spectrogram_ops(rows * cfg.num_frames(n), cfg)
                    b = add_timing(timings, work, "spectrogram", [k, p, lib],
                                   nbytes, ops)
                    dft, dft_by = bound_ms(nbytes, dft_ops)
                    print(f"  {card}: K1 {label} {tuple(x.shape)} int16: "
                          f"kernel {k:.4f} ms, plain {p:.4f} ms, torch.stft "
                          f"(pre-emphasised f32 rows) {lib:.4f} ms; {b}; "
                          f"with a DFT product's operations the bound would "
                          f"be {dft:.5f} ms ({dft_by})")
                    del stft, mag, half
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
                        errs["max_pool_3x3s2"] = max(
                            errs["max_pool_3x3s2"], err)
                        print(f"  K2 bucket {bucket} {label} {shape} {dtype}: "
                              f"bitwise {'equal' if same else 'DIFFERENT'} "
                              f"(max abs {err:.3e})", flush=True)
                        check(same, f"K2 bucket {bucket} {label} {dtype}: "
                              "not bitwise equal")
                        if dtype == torch.bfloat16:  # the slice's dtype
                            p, k = turns_ms(lambda: pool.max_pool_3x3s2(x),
                                            lambda: pool.max_pool_3x3s2_cuda(x))
                            b = add_timing(timings, work, "max_pool_3x3s2",
                                           [k, p], 2 * (x.numel() + got.numel()),
                                           8 * got.numel())
                            print(f"  {card}: K2 bucket {bucket} {label} "
                                  f"{shape} bf16: kernel {k:.4f} ms, "
                                  f"plain {p:.4f} ms; {b}")
                        del x, got, ref
            torch.cuda.empty_cache()

        with phase("slice", walls):
            # full width, bf16; weights on the host: the extractor moves
            # them to the card, its default device
            model = build_student(with_frontend=False)
            state = student_state_dict_from_flax(
                random_student_variables(seed=SEED))

            t0 = time.perf_counter()
            compute_audio_feats(imdb, model, state, batch_size=BATCH,
                                verbose=False)
            torch.cuda.synchronize()
            first_s = time.perf_counter() - t0

            reset_counts(wrappers)
            t0 = time.perf_counter()
            with contextlib.redirect_stderr(sys.stdout):
                logits = compute_audio_feats(imdb, model, state, batch_size=BATCH)
            torch.cuda.synchronize()
            main_s = time.perf_counter() - t0
            launches = read_counts(wrappers)

            t0 = time.perf_counter()
            plain = compute_audio_feats(imdb, model, state, batch_size=BATCH,
                                        use_kernels=False, verbose=False)
            torch.cuda.synchronize()
            plain_s = time.perf_counter() - t0

            check(len(logits) == len(paths), "missing tracks")
            check(all(l.shape == (1, 8) and np.all(np.isfinite(l))
                      for l in logits), "logits not finite [1, 8]")
            expected = {k: 0 for k in wrappers} | {
                "spectrogram": len(chunks), "max_pool_3x3s2": 2 * len(chunks)}
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
            del model, state
            torch.cuda.empty_cache()

        with phase("k2-backward", walls):
            k2_backward_phase(card, timings, errs, work)

        with phase("train", walls):
            train_counts = train_phase(card, wrappers)

        with phase("distill", walls):
            distill_counts, distill_imdb = distill_phase(Path(tmp), wrappers)

        with phase("reader", walls):
            reader_counts = reader_phase(card, imdb, wrappers)

        with phase("release", walls):
            release_counts, student, student_state = release_phase(
                card, Path(tmp), imdb, distill_imdb, wrappers)

        with phase("analysis", walls):
            analysis_counts = analysis_phase(card, Path(tmp), student,
                                             student_state, distill_imdb,
                                             wrappers)
            del student, student_state

        with phase("probes", walls):
            probe_counts = probes_phase(card, wrappers, timings, errs, work)

    print("  phase walls (s): " + ", ".join(f"{k} {v:.2f}"
                                            for k, v in walls.items()))
    print(f"  {card}: kernel times summed over the main runs' launch shapes "
          f"(ms, kernel / plain / library): " + ", ".join(
              f"{k} {v[0]:.5f} / {v[1]:.5f} / {v[2]:.5f}"
              for k, v in timings.items()))
    source = "mcncrossmodalemotions_torch/csrc/"
    probe_tools = "tools/probe_mosaic.py:39"
    replaces = {
        "spectrogram": ("spectrogram.cu",
                        "mcncrossmodalemotions_tpu/ops/pallas_spectrogram.py:117"),
        "max_pool_3x3s2": ("max_pool_3x3s2.cu",
                           "mcncrossmodalemotions_tpu/ops/pallas_pool.py:95"),
        "max_pool_3x3s2_idx": ("max_pool_3x3s2.cu",
                               "mcncrossmodalemotions_tpu/ops/pallas_pool.py:95"),
        "max_pool_3x3s2_bwd": ("max_pool_3x3s2.cu",
                               "mcncrossmodalemotions_tpu/ops/pallas_pool.py:144"),
        "probe_gather": ("probes.cu", f"{probe_tools}, "
                         "tools/probe_mosaic2.py:32,111"),
        "probe_select_matmul": ("probes.cu", f"{probe_tools} (P9)"),
        "probe_col_candidates": ("probes.cu", "tools/probe_mosaic2.py:32 (P12)"),
    }
    library = {"spectrogram": "torch.stft", "probe_gather": "index_select",
               "probe_select_matmul": "torch.matmul"}
    library |= dict.fromkeys(("max_pool_3x3s2", "max_pool_3x3s2_idx",
                              "max_pool_3x3s2_bwd"), "its plain version")
    kernels = []
    for name, (src, rep) in replaces.items():
        bound, bound_by = bound_ms(*work[name])
        kernels.append({
            "name": name, "route": "cuda", "source": source + src,
            "replaces": rep,
            "launches": (launches[name] + train_counts[name]
                         + distill_counts[name] + reader_counts[name]
                         + release_counts[name] + analysis_counts[name]
                         + probe_counts[name]),
            "max_abs_err": errs[name], "ms": timings[name][0],
            "plain_ms": timings[name][1], "bound_ms": bound,
            "bound_by": bound_by,
            "library_ms": timings[name][2] if name in library else None})
        print(f"  {card}: {name}: {timings[name][0]:.5f} ms against a bound "
              f"of {bound:.5f} ms ({bound_by}; {bound / timings[name][0]:.1%} "
              f"of it), library call: {library.get(name)}")
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
