"""Dense teacher inference, the dataset-genesis pass:
``exp/compute_visual_feats.VisualFeatureExtractor.frame_logits`` at batch
128 and 8 decoder threads over face JPEGs on disk, with no
``partial_path``, so no fingerprinted partial answers a repeated pass.

Set-up writes the frames, builds the SENet50 face pipeline with the
benchmark's weights and makes one pass (cuDNN's choices for the batch).
The window makes whole passes over every frame until its seconds are
spent: each decodes, crops, grays and resizes every frame on the host and
scores it on the card, and CUDA events time each forward on the card
(``device_s``). In a traced run the decoder alone
(``data/images.load_frame_batch``) is then timed over the same files at
the extractor's thread count, after the window's wall is taken. The check: every answer of every pass
against the plain reference's logits for the frame's source image
(decoded from its quantised coefficients, cropped, grayed and resized,
then SE-ResNet-50 in float32), by the largest gap over the reference's
RMS logit.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from perfbench.counts import senet50 as senet_counts
from perfbench.drivers.common import (DeviceTimer, card_peaks, checks, load_weights, release,
                                      weights_seed)
from perfbench.reference import faces, senet50 as ref
from perfbench.reference.common import Ops, exact_fp32, make_weights
from perfbench.traffic import generate



def _weights(run):
    return make_weights(ref.leaves(run.cfg), weights_seed(run.seed), run.device,
                        stem_var=run.cfg["stem_running_var"])


def setup(run):
    cfg, wl = run.cfg, run.workload
    t0 = time.perf_counter()
    frames = generate.jpeg_frames(run.cell.mix, run.seed, run.tmp)
    print(f"side: traffic {len(frames.paths)} JPEGs ({len(frames.pixels)} distinct), "
          f"{frames.bytes_written} bytes written in {time.perf_counter() - t0:.2f} s",
          flush=True)

    from mcncrossmodalemotions_torch.exp.compute_visual_feats import VisualFeatureExtractor
    from mcncrossmodalemotions_torch.models.teacher_pipeline import FaceTeacherPipeline
    from mcncrossmodalemotions_torch.zoo import build_teacher

    teacher = build_teacher("senet50-ferplus", num_outputs=cfg["num_outputs"],
                            tiny=run.rehearse)
    pipeline = FaceTeacherPipeline(teacher=teacher, input_size=cfg["input_size"],
                                   mean_rgb=cfg["mean_rgb"], augment=False)
    pipeline.to(run.device)
    load_weights(pipeline, _weights(run), prefix="teacher.")
    pipeline.eval()
    extractor = VisualFeatureExtractor(pipeline, pipeline.state_dict(),
                                       batch_size=wl["batch_size"],
                                       num_threads=wl["threads"],
                                       input_size=cfg["input_size"],
                                       crop_ratio=cfg["face_crop_ratio"], device=run.device)
    extractor.frame_logits(frames.paths, verbose=False)  # cuDNN's choices, page cache
    return {"frames": frames, "extractor": extractor, "pipeline": pipeline}


def window(run, ctx, t0, tracer):
    cfg, wl = run.cfg, run.workload
    frames, extractor = ctx["frames"], ctx["extractor"]
    n = len(frames.paths)
    passes, free, answers, failed, marks = 0, 0, [], 0, []
    with DeviceTimer(ctx["pipeline"], run.device) as forwards:
        while True:
            on = tracer.boundary(t0)
            out = extractor.frame_logits(frames.paths, verbose=False)
            if out is None or len(out) != n:
                failed += n
            else:
                answers.append(np.asarray(out, np.float64))
            passes += 1
            free += not on
            now = time.perf_counter() - t0
            marks.append((now, passes * n))
            if now >= run.seconds:
                break
    tracer.finish()
    ctx["answers"] = answers
    return {"count": passes * n, "attempted": passes * n, "failed": failed,
            "passes": passes, "traced_count": (passes - free) * n, "progress": marks,
            "device_s": forwards.seconds(),
            "free_flops": free * n * senet_counts.forward_flops(cfg, cfg["input_size"]),
            "peaks": card_peaks(run)}


def after_window(run, ctx, win):
    """In a traced run, the decoder alone over the cell's files."""
    if not run.trace:
        return
    from mcncrossmodalemotions_torch.data.images import load_frame_batch

    cfg, wl, paths = run.cfg, run.workload, ctx["frames"].paths
    t = time.perf_counter()
    for i in range(0, len(paths), wl["batch_size"]):
        load_frame_batch(paths[i:i + wl["batch_size"]], cfg["input_size"],
                         wl["threads"], cfg["face_crop_ratio"])
    run.record["decode_frames_per_s"] = len(paths) / (time.perf_counter() - t)


def reference_logits(run, ctx, precision: str = "fp32") -> np.ndarray:
    """[distinct, C]: the reference's logits of each source image."""
    cfg, frames = run.cfg, ctx["frames"]
    if "reference_frames" not in ctx:
        ctx["reference_frames"] = np.stack([
            faces.face_frame(p, cfg["input_size"], cfg["face_crop_ratio"])
            for p in frames.pixels])
    out = []
    with exact_fp32(), torch.no_grad():
        weights = _weights(run)
        for i in range(0, len(frames.pixels), 64):
            x = torch.as_tensor(ctx["reference_frames"][i:i + 64], device=run.device)
            out.append(ref.forward(cfg, weights, x, False, Ops(precision)).double().cpu())
    return torch.cat(out).numpy()


def logit_gap(answers, refr: np.ndarray, source: np.ndarray) -> float:
    """The largest |answer - reference| over every frame of every pass,
    over the reference logits' RMS."""
    scale = float(np.sqrt((refr ** 2).mean()))
    want = refr[source]
    return max((float(np.abs(a - want).max()) for a in answers), default=0.0) / scale


def check(run, ctx, win, variant=None):
    release(run, ctx, "extractor", "pipeline")
    if "reference" not in ctx:
        ctx["reference"] = reference_logits(run, ctx)
    refr, source = ctx["reference"], ctx["frames"].source
    answers = ctx["answers"]
    if variant in ("control", "bf16"):
        answers = [reference_logits(run, ctx, "fp8" if variant == "control" else "bf16")[source]]
    elif variant == "fault:altered_answer":
        answers = [refr[source].copy()]
        answers[0][0] += 0.25 * np.abs(refr).max()
    elif variant is not None:
        raise ValueError(f"unknown variant {variant!r}")
    return checks(run, variant, {"logit_gap": logit_gap(answers, refr, source)})
