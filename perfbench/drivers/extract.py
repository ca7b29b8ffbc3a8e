"""Whole-clip student extraction: ``exp/compute_audio_feats.
AudioFeatureExtractor.track_logits`` at batch 64 with the int16 feed,
called directly, so no feature cache answers a repeated pass.

Set-up writes the tracks, builds the extractor with the benchmark's
weights and makes one pass (every bucket's shapes). The window makes
whole passes over every track until its seconds are spent; each pass
reads, buckets, pads and scores every track. The check: every answer of
every pass against the plain reference's logits for that track (read
from the file, normalised over the whole clip, centre-cropped to its
bucket, the student in eval mode), by the largest gap over the
reference's RMS logit.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from perfbench.counts import kernels, vggm as vggm_counts
from perfbench.drivers.common import card_peaks, checks, load_weights, release, weights_seed
from perfbench.reference import vggm as ref
from perfbench.reference.common import exact_fp32, make_weights
from perfbench.traffic import generate
from perfbench.traffic.wav import read_pcm16



def _track_shapes(cfg: dict, num_samples: np.ndarray):
    """Per track: (valid frames, bucket width) as extraction defines them."""
    fs = cfg["spectrogram"]["sample_rate"]
    cap = int(cfg["max_clip_seconds"] * fs)
    out = []
    for n in num_samples:
        t = min(max(ref.num_frames(cfg, min(int(n), cap)), 1), cfg["extract_max_frames"])
        fit = [b for b in cfg["extract_buckets"] if b <= t]
        out.append((t, fit[-1] if fit else cfg["extract_buckets"][0]))
    return out


def setup(run):
    cfg, wl = run.cfg, run.workload
    t0 = time.perf_counter()
    tracks = generate.wav_tracks(run.cell.mix, run.seed, run.tmp / "wavs", run.device)
    if run.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(run.device)
    print(f"side: traffic {len(tracks.rel_paths)} tracks, "
          f"{tracks.durations.sum():.1f} s of audio, {tracks.bytes_written} bytes "
          f"written in {time.perf_counter() - t0:.2f} s", flush=True)

    from mcncrossmodalemotions_torch.exp.compute_audio_feats import AudioFeatureExtractor
    from mcncrossmodalemotions_torch.zoo import build_student

    model = build_student("emovoxceleb-student", num_outputs=cfg["num_outputs"],
                          with_frontend=False, tiny=run.rehearse)
    if (model.fc6.out_channels, model.fc7.out_features) != (cfg["fc6"]["out"], cfg["fc7"]):
        raise ValueError("the program's student does not have the config's widths")
    model.to(run.device)
    load_weights(model, make_weights(ref.leaves(cfg), weights_seed(run.seed), run.device))
    model.eval()
    extractor = AudioFeatureExtractor(model, model.state_dict(),
                                      batch_size=wl["batch_size"],
                                      num_threads=wl["threads"], device=run.device)
    paths = tracks.paths()
    extractor.track_logits(paths, verbose=False)  # every bucket's shapes
    return {"tracks": tracks, "extractor": extractor, "model": model, "paths": paths}


def window(run, ctx, t0, tracer):
    cfg = run.cfg
    tracks, extractor, paths = ctx["tracks"], ctx["extractor"], ctx["paths"]
    shapes = _track_shapes(cfg, tracks.num_samples)
    fs = cfg["spectrogram"]["sample_rate"]
    audio_s = float(np.minimum(tracks.num_samples / fs, cfg["max_clip_seconds"]).sum())
    passes, answers, failed, traced, free, marks = 0, [], 0, 0, 0, []
    while True:
        on = tracer.boundary(t0)
        out = extractor.track_logits(paths, verbose=False)
        failed += sum(o is None for o in out)
        answers.append([None if o is None else np.asarray(o, np.float64).reshape(-1)
                        for o in out])
        passes += 1
        traced += on
        free += not on
        now = time.perf_counter() - t0
        marks.append((now, passes * audio_s))
        if now >= run.seconds:
            break
    tracer.finish()
    nfft = cfg["spectrogram"]["nfft"]
    k1b = sum(kernels.k1_bytes(ref.crop_samples(cfg, t), t, nfft, 2) for t, _ in shapes)
    k1f = sum(kernels.k1_flops(t, nfft) for t, _ in shapes)
    k2b = sum(kernels.k2_bytes(vggm_counts.pool_shapes(cfg, b), 2, backward=False)
              for _, b in shapes)
    flops = sum(vggm_counts.forward_flops(cfg, b) for _, b in shapes)
    ctx["answers"] = answers
    return {"count": passes * audio_s, "attempted": passes * len(paths), "failed": failed,
            "passes": passes, "traced_count": traced * audio_s, "progress": marks,
            "free_flops": free * flops,
            "peaks": card_peaks(run),
            "traced_work": {"passes": traced, "k1_bytes": traced * k1b,
                            "k1_flops": traced * k1f, "k2_bytes": traced * k2b}}


def reference_logits(run, ctx, precision: str = "fp32") -> np.ndarray:
    """[tracks, C] reference logits, one track at a time."""
    cfg, tracks = run.cfg, ctx["tracks"]
    cap = int(cfg["max_clip_seconds"] * cfg["spectrogram"]["sample_rate"])
    with exact_fp32():
        weights = make_weights(ref.leaves(cfg), weights_seed(run.seed), run.device)
        out = []
        for path in tracks.paths():
            pcm, _ = read_pcm16(path, 0, cap)
            out.append(ref.track_logits(cfg, weights, pcm, cfg["extract_buckets"],
                                        cfg["extract_max_frames"], run.device, precision))
    return np.stack(out)


def logit_gap(answers, refr: np.ndarray) -> float:
    """The largest |answer - reference| over every answer of every pass,
    over the reference logits' RMS; a missing answer counts as failed in
    the window, not here."""
    scale = float(np.sqrt((refr ** 2).mean()))
    gap = 0.0
    for answer in answers:
        for got, want in zip(answer, refr):
            if got is not None:
                gap = max(gap, float(np.abs(got - want).max()) / scale)
    return gap


def check(run, ctx, win, variant=None):
    answers = ctx.get("answers")
    release(run, ctx, "extractor", "model")
    if "reference" not in ctx:
        ctx["reference"] = reference_logits(run, ctx)
    refr = ctx["reference"]
    if variant in ("control", "bf16"):
        answers = [list(reference_logits(run, ctx, "fp8" if variant == "control" else "bf16"))]
    elif variant == "fault:altered_answer":
        answers = [list(refr.copy())]
        answers[0][0] = answers[0][0] + 0.25 * np.abs(refr).max()
    elif variant is not None:
        raise ValueError(f"unknown variant {variant!r}")
    return checks(run, variant, {"logit_gap": logit_gap(answers, refr)})
