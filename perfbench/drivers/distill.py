"""Distillation training of the VGG-M student, as ``run_distillation``
configures it: ``train/engine.Trainer.run_epoch`` over
``data/emovox.EmoVoxBatcher`` (int16 crops read from disk by the port's
wav library, the engine's pinned prefetch), the step with the masked
BatchNorm, hot cross-entropy at T = 2 and MatConvNet SGD.

Set-up builds one trainer and one state, drives the first three steps
through ``run_epoch`` (one batch each, epoch 1's first three batches,
all different rows), keeps the program's readings and hands the same
state to the window: whole epochs from epoch 2 until the window's
seconds are spent. The check: each step's loss, the first gradient as
the optimizer got it (-v / lr - wd p0 from the velocity after step one),
and the parameters' change after step three, against the plain
reference's three steps from the same weights on the batches it works
out again from the files.
"""

from __future__ import annotations

import itertools
import time

import numpy as np
import torch

from perfbench.counts import kernels, vggm as vggm_counts
from perfbench.drivers.common import card_peaks, load_weights, training_check, weights_seed
from perfbench.reference import vggm as ref
from perfbench.reference.batches import epoch_batches
from perfbench.reference.common import (
    exact_fp32, leaf_gaps, make_weights, negligible_leaves, rel_gap)
from perfbench.traffic import generate

SETUP_STEPS = 3



def setup(run):
    cfg, wl = run.cfg, run.workload
    t0 = time.perf_counter()
    tracks = generate.wav_tracks(run.cell.mix, run.seed, run.tmp / "wavs", run.device)
    if run.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(run.device)
    print(f"side: traffic {len(tracks.rel_paths)} tracks, "
          f"{tracks.durations.sum():.1f} s of audio, {tracks.bytes_written} bytes "
          f"written in {time.perf_counter() - t0:.2f} s", flush=True)

    from mcncrossmodalemotions_torch import EMOTIONS
    from mcncrossmodalemotions_torch.data.emovox import BatchConfig, EmoVoxBatcher
    from mcncrossmodalemotions_torch.data.imdb import SET_TRAIN, EmoVoxImdb
    from mcncrossmodalemotions_torch.train.engine import (
        TrainConfig, Trainer, logspace_lr, lr_for_epoch)
    from mcncrossmodalemotions_torch.zoo import build_student, student_loss_fn

    n = len(tracks.rel_paths)
    imdb = EmoVoxImdb(wav_paths=np.asarray(tracks.rel_paths, dtype=object),
                      speaker=np.asarray([p.split("/")[0] for p in tracks.rel_paths],
                                         dtype=object),
                      set_id=np.full(n, SET_TRAIN, np.int32),
                      wav_logits=tracks.logits, wav_dir=str(tracks.root),
                      classes=EMOTIONS[:cfg["num_outputs"]])
    bcfg = BatchConfig(num_seconds=cfg["crop_seconds"], batch_size=wl["batch_size"],
                       loss_type=cfg["loss"], logit_aggregator=cfg["logit_aggregator"],
                       num_pred_emotions=cfg["num_outputs"])
    batcher = EmoVoxBatcher(imdb, bcfg, train=True, seed=run.seed)
    lr0, lr1 = cfg["learning_rate_log10"]
    tcfg = TrainConfig(num_epochs=cfg["num_epochs"], batch_size=wl["batch_size"],
                       epoch_size=None, learning_rate=logspace_lr(lr0, lr1, cfg["num_epochs"]),
                       momentum=cfg["momentum"], weight_decay=cfg["weight_decay"],
                       seed=run.seed, exp_dir=str(run.tmp / "exp"), resume=False)
    model = build_student("emovoxceleb-student", num_outputs=cfg["num_outputs"],
                          dropout=cfg["assumed"]["dropout"], loss_type=cfg["loss"],
                          tiny=run.rehearse)
    if (model.net.fc6.out_channels, model.net.fc7.out_features) != (
            cfg["fc6"]["out"], cfg["fc7"]):
        raise ValueError("the program's student does not have the config's widths")
    model.to(run.device)
    load_weights(model.net, make_weights(ref.leaves(cfg), weights_seed(run.seed),
                                         run.device))
    trainer = Trainer(model, student_loss_fn(cfg["loss"], temperature=cfg["temperature"],
                                             num_classes=cfg["num_outputs"]),
                      tcfg, class_names=EMOTIONS[:cfg["num_outputs"]], device=run.device)
    state = trainer.init_state(scratch=False)

    # the first three steps, through the window's own call and feed
    names = [n for n, _ in model.named_parameters()]
    p0 = {n: p.detach().clone() for n, p in model.named_parameters()}
    lr = lr_for_epoch(tcfg, 1)
    losses, grad_norms = [], {}
    for k in range(SETUP_STEPS):
        state, stats = trainer.run_epoch(
            state, itertools.islice(batcher.batches(epoch=1), k, k + 1), 1, True)
        losses.append(float(stats["loss"]))
        if k == 0:
            for n in names:
                g = -state.velocity[n].double() / lr - cfg["weight_decay"] * p0[n].double()
                grad_norms[n[len("net."):]] = float(g.norm())
    params = dict(model.named_parameters())
    change = {n[len("net."):]: float((params[n].detach().double() - p0[n].double()).norm())
              for n in names}
    del p0
    return {"tracks": tracks, "trainer": trainer, "state": state, "batcher": batcher,
            "lr": lr, "program": {"losses": losses, "grad_norms": grad_norms,
                                  "change_norms": change}}


def window(run, ctx, t0, tracer):
    cfg, wl = run.cfg, run.workload
    trainer, batcher = ctx["trainer"], ctx["batcher"]
    frames = cfg["crop_frames"]
    need = ref.crop_samples(cfg, frames)
    items, free_items, free_wait, epoch, traced_steps, marks = 0, 0, 0.0, 2, 0, []
    while True:
        traced = tracer.boundary(t0)
        ctx["state"], stats = trainer.run_epoch(ctx["state"], batcher.batches(epoch=epoch),
                                                epoch, True)
        items += stats["num_samples"]
        if traced:
            traced_steps += -(-stats["num_samples"] // wl["batch_size"])
        else:
            free_items += stats["num_samples"]
            free_wait += stats["feed_wait_s"]
        epoch += 1
        now = time.perf_counter() - t0
        marks.append((now, items))
        if now >= run.seconds:
            break
    tracer.finish()
    b = wl["batch_size"]
    pools = vggm_counts.pool_shapes(cfg, frames)
    return {"count": items, "attempted": items, "failed": 0,
            "epochs": epoch - 2, "free_feed_wait_s": free_wait,
            "traced_count": items - free_items, "progress": marks,
            "free_flops": free_items * vggm_counts.train_flops(cfg, frames),
            "peaks": card_peaks(run),
            "traced_work": {
                "steps": traced_steps,
                "k2_bytes": traced_steps * b * kernels.k2_bytes(pools, 2, backward=True),
                "k2_launches": {"forward": 2 * traced_steps, "backward": 2 * traced_steps},
                "k1_bytes": traced_steps * b * kernels.k1_bytes(need, frames,
                                                                cfg["spectrogram"]["nfft"], 2),
                "k1_flops": traced_steps * b * kernels.k1_flops(frames,
                                                                cfg["spectrogram"]["nfft"]),
                "k1_launches": traced_steps}}


def reference_readings(run, ctx, precision: str, fault: str | None) -> dict:
    """The reference's three steps (``fault``: ``half_batch`` takes the
    loss over the first half of each batch only)."""
    cfg, wl, tracks = run.cfg, run.workload, ctx["tracks"]
    batches = epoch_batches(cfg, tracks.paths(), tracks.num_samples, tracks.logits,
                            run.seed, 1, wl["batch_size"], SETUP_STEPS)
    dev = [{"pcm": torch.as_tensor(b["pcm"], device=run.device),
            "teacher": torch.as_tensor(b["teacher"], device=run.device)} for b in batches]
    if fault == "half_batch":
        half = wl["batch_size"] // 2
        dev = [{k: v[:half] for k, v in b.items()} for b in dev]
    with exact_fp32():
        weights = make_weights(ref.leaves(cfg), weights_seed(run.seed), run.device)
        return ref.distill_steps(cfg, weights, dev, [ctx["lr"]] * SETUP_STEPS, precision)


def compare(prog: dict, refr: dict) -> dict:
    """Each step's loss; by leaf, the first gradient's norm and the
    change's norm, by the worst leaf and by the median leaf (the workload's
    limits name the numbers compared)."""
    skip = negligible_leaves(refr["grad_norms"])
    grad = leaf_gaps(prog["grad_norms"], refr["grad_norms"], skip)
    change = leaf_gaps(prog["change_norms"], refr["change_norms"], skip)
    print("side: gradient norm gaps by leaf: "
          + ", ".join(f"{n} {g:.4g}" for n, g in grad.items()), flush=True)
    print(f"side: worst leaves: gradient {max(grad, key=grad.get)}, change "
          f"{max(change, key=change.get)}; left out (reference gradient under 1e-3 of "
          f"the median leaf's): {sorted(skip)}", flush=True)
    return {"loss_gap": max(rel_gap(a, b) for a, b in zip(prog["losses"], refr["losses"])),
            "loss1_gap": rel_gap(prog["losses"][0], refr["losses"][0]),
            "grad_gap": max(grad.values()), "update_gap": max(change.values()),
            "median_grad_gap": float(np.median(list(grad.values()))),
            "median_update_gap": float(np.median(list(change.values())))}


def check(run, ctx, win, variant=None):
    return training_check(run, ctx, variant, reference_readings, compare)
