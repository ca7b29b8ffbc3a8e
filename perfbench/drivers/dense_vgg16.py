"""Dense teacher inference with the VGG-VD-16 face teacher: the
dataset-genesis pass of ``drivers/dense.py`` with ``vgg-vd-face-fer`` in
SENet50's place, over the same frames, batch and decoder threads.

Set-up writes the frames, builds the VGG-VD-16 face pipeline with the
benchmark's weights and makes one pass (cuDNN's choices for the batch,
the fused path's prepared weights). The window makes whole passes of
``exp/compute_visual_feats.VisualFeatureExtractor.frame_logits`` until
its seconds are spent, CUDA events timing each forward on the card
(``device_s``); the traced passes also count the block-end epilogue's
launches (``ops/epilogue.affine_relu_pool2x2.launches``, where the
program has it) for its roofline, and the 3x3 convolutions' FLOPs for
their share of the peak. The check: every answer of every pass
against the plain reference's logits for the frame's source image
(``reference/vgg16.py`` in float32), by the largest gap over the
reference's RMS logit.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from perfbench.counts import vgg16 as counts
from perfbench.drivers.common import (DeviceTimer, card_peaks, checks, load_weights, release,
                                      weights_seed)
from perfbench.drivers.dense import after_window, logit_gap
from perfbench.harness.cli import side
from perfbench.reference import faces, vgg16 as ref
from perfbench.reference.common import Ops, exact_fp32, make_weights
from perfbench.traffic import generate

__all__ = ["setup", "window", "after_window", "check"]


def _weights(run):
    return make_weights(ref.leaves(run.cfg), weights_seed(run.seed), run.device)


def _pool_launches() -> Optional[int]:
    """The block-end epilogue's launches so far; None in a program
    without it."""
    try:
        from mcncrossmodalemotions_torch.ops import epilogue
    except ImportError:
        return None
    fn = getattr(epilogue, "affine_relu_pool2x2", None)
    return None if fn is None else fn.launches


def setup(run):
    cfg, wl = run.cfg, run.workload
    t0 = time.perf_counter()
    frames = generate.jpeg_frames(run.cell.mix, run.seed, run.tmp)
    side(f"traffic {len(frames.paths)} JPEGs ({len(frames.pixels)} distinct), "
         f"{frames.bytes_written} bytes written in {time.perf_counter() - t0:.2f} s")

    from mcncrossmodalemotions_torch.exp.compute_visual_feats import VisualFeatureExtractor
    from mcncrossmodalemotions_torch.models.teacher_pipeline import FaceTeacherPipeline
    from mcncrossmodalemotions_torch.zoo import build_teacher

    teacher = build_teacher(cfg["teacher"], num_outputs=cfg["num_outputs"],
                            use_bnorm=cfg["batchnorm"], tiny=run.rehearse,
                            input_size=cfg["input_size"])
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


def _pass_pool_bytes(run, n: int) -> int:
    """The block-end epilogue's least bytes over one pass of ``n`` frames."""
    cfg, b = run.cfg, run.workload["batch_size"]
    size, elem = cfg["input_size"], 2 if cfg["dtype"] == "bfloat16" else 4
    full, rest = divmod(n, b)
    return (full * counts.pool_bytes(cfg, size, b, elem)
            + (counts.pool_bytes(cfg, size, rest, elem) if rest else 0))


def window(run, ctx, t0, tracer):
    cfg = run.cfg
    frames, extractor = ctx["frames"], ctx["extractor"]
    n = len(frames.paths)
    passes, free, answers, failed, marks, traced_launches = 0, 0, [], 0, [], 0
    with DeviceTimer(ctx["pipeline"], run.device) as forwards:
        while True:
            on = tracer.boundary(t0)
            before = _pool_launches()
            out = extractor.frame_logits(frames.paths, verbose=False)
            if on and before is not None:
                traced_launches += _pool_launches() - before
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
    traced = passes - free
    flops = counts.forward_flops(cfg, cfg["input_size"])
    teacher = ctx["pipeline"].teacher
    builds = getattr(getattr(teacher, "prepared", None), "builds", None)
    side(f"teacher: prepared weights built {builds} time(s) in the process; "
         f"{traced_launches if _pool_launches() is not None else None} block-end "
         f"epilogue launches over {traced} traced pass(es)")
    return {"count": passes * n, "attempted": passes * n, "failed": failed,
            "passes": passes, "traced_count": traced * n, "progress": marks,
            "device_s": forwards.seconds(), "device_flops": passes * n * flops,
            "free_flops": free * n * flops, "prepared_builds": builds,
            "peaks": card_peaks(run),
            "traced_work": {
                "passes": traced, "pool_bytes": traced * _pass_pool_bytes(run, n),
                "conv_flops": traced * n * counts.conv3x3_flops(cfg, cfg["input_size"]),
                "pool_launches": (traced_launches if _pool_launches() is not None
                                  else None)}}


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
        for i in range(0, len(frames.pixels), 32):
            x = torch.as_tensor(ctx["reference_frames"][i:i + 32], device=run.device)
            out.append(ref.forward(cfg, weights, x, Ops(precision)).double().cpu())
    return torch.cat(out).numpy()


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
