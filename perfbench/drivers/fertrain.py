"""FER+ teacher training of SE-ResNet-50, as ``exp/ferplus_baselines``
builds it: ``train/engine.Trainer.run_epoch`` over
``data/ferplus.ferplus_batches(augment=True)`` (the host warps a random
half of each batch at 48x48), the face pipeline's device fliplr, resize
to 224 and mean subtraction, SE-ResNet-50 in bf16 with fp32 BatchNorm
statistics, dropout 0.5 before the head, the vote-distribution loss and
SGD with the backbone at a tenth of the head's rate.

Set-up builds one trainer and one state, drives the first three steps
through ``run_epoch`` (epoch 1's first three batches, one a call), keeps
the program's readings and hands the same state to the window: epoch 2
on, each cut where the window's seconds run out (the loader stops
yielding; the batches already queued complete). The check is
``distill``'s: each step's loss, the first gradient as the optimizer got
it and the change after step three, against the plain reference's three
steps from the same weights, batches worked out again from the faces and
the seeds. The gradient and the change are compared by the median leaf:
the worst leaf is most often the stem's ``conv1.weight``, whose gradient
sums 1.6M products a weight and swings from seed to seed in bfloat16 as
in the reference's own bfloat16 form.
"""

from __future__ import annotations

import itertools
import time

import numpy as np

from perfbench.counts import senet50 as senet_counts
from perfbench.drivers.common import card_peaks, load_weights, training_check, weights_seed
from perfbench.drivers.distill import compare as compare_steps
from perfbench.reference import fer, senet50 as ref
from perfbench.reference.common import exact_fp32, make_weights
from perfbench.traffic import generate

SETUP_STEPS = 3
TRACED_STEPS = 16


def _weights(run):
    """The benchmark's weights, each bottleneck's last BatchNorm scale
    times ``residual_bn_scale``: at the plain draw the train-mode network
    is chaotic (any rounding grows block by block to half the last
    stage's activations), which no trained network is."""
    w = make_weights(ref.leaves(run.cfg), weights_seed(run.seed), run.device,
                     stem_var=run.cfg["stem_running_var"])
    for name in w:
        if name.endswith(".bn3.weight"):
            w[name] = w[name] * run.workload["residual_bn_scale"]
    return w


def _loader_seed(seed: int) -> int:
    """``ferplus_batches`` seeds a numpy ``RandomState`` with seed + epoch."""
    return seed % (2 ** 32 - 1024)


def _until(batches, deadline: float, marks: list, t0: float, done: int, size: int):
    """``batches`` until ``deadline``, marking (seconds into the window,
    images handed over) every 16 batches."""
    for i, b in enumerate(batches):
        now = time.perf_counter()
        if now >= deadline:
            return
        if i % 16 == 0:
            marks.append((now - t0, done + i * size))
        yield b


def setup(run):
    cfg, wl = run.cfg, run.workload
    t0 = time.perf_counter()
    faces = generate.ferplus_faces(run.cell.mix, run.seed)
    print(f"side: traffic {len(faces.data)} faces made in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    from mcncrossmodalemotions_torch import EMOTIONS
    from mcncrossmodalemotions_torch.data.ferplus import ferplus_batches
    from mcncrossmodalemotions_torch.data.imdb import FerPlusImdb
    from mcncrossmodalemotions_torch.models.teacher_pipeline import FaceTeacherPipeline
    from mcncrossmodalemotions_torch.train.engine import TrainConfig, Trainer, lr_for_epoch
    from mcncrossmodalemotions_torch.train.state import finetune_lr_scale_fn
    from mcncrossmodalemotions_torch.zoo import build_teacher, teacher_loss_fn

    n = len(faces.data)
    imdb = FerPlusImdb(data=faces.data, hard_labels=faces.votes[:, :8].argmax(1).astype(np.int32),
                       votes=faces.votes, set_id=np.ones(n, np.int32), classes=EMOTIONS)
    tcfg = TrainConfig(num_epochs=180, batch_size=wl["batch_size"],
                       learning_rate=cfg["learning_rate"], momentum=cfg["momentum"],
                       weight_decay=cfg["weight_decay"], seed=run.seed,
                       exp_dir=str(run.tmp / "exp"), resume=False)
    teacher = build_teacher("senet50-ferplus", num_outputs=cfg["num_outputs"],
                            dropout=cfg["dropout"], tiny=run.rehearse,
                            input_size=cfg["input_size"])
    pipeline = FaceTeacherPipeline(teacher, input_size=cfg["input_size"],
                                   mean_rgb=cfg["mean_rgb"], augment=True,
                                   flip_prob=cfg["flip_prob"])
    pipeline.to(run.device)
    load_weights(pipeline, _weights(run), prefix="teacher.")
    scale_fn = finetune_lr_scale_fn(backbone_scale=cfg["backbone_lr_scale"])
    base_loss = teacher_loss_fn("distributions", cfg["num_outputs"])
    first_logits = []

    def loss_fn(outputs, batch):
        """The program's loss, keeping the first step's logits."""
        if not first_logits:
            first_logits.append(outputs.detach().double().cpu().numpy())
        return base_loss(outputs, batch)

    trainer = Trainer(pipeline, loss_fn, tcfg, class_names=EMOTIONS, device=run.device,
                      lr_scale_fn=scale_fn)
    state = trainer.init_state(scratch=False)
    loader_seed = _loader_seed(run.seed)

    def batches(epoch):
        return ferplus_batches(imdb, 1, wl["batch_size"], shuffle=True,
                               seed=loader_seed + epoch, drop_remainder=True,
                               augment=True)

    names = [n for n, _ in pipeline.named_parameters()]
    p0 = {n: p.detach().clone() for n, p in pipeline.named_parameters()}
    lr = lr_for_epoch(tcfg, 1)
    losses, grad_norms = [], {}
    for k in range(SETUP_STEPS):
        state, stats = trainer.run_epoch(state, itertools.islice(batches(1), k, k + 1), 1)
        losses.append(float(stats["loss"]))
        if k == 0:
            for n in names:
                s = lr * scale_fn(tuple(n.split(".")))
                g = -state.velocity[n].double() / s - cfg["weight_decay"] * p0[n].double()
                grad_norms[n[len("teacher."):]] = float(g.norm())
    params = dict(pipeline.named_parameters())
    change = {n[len("teacher."):]: float((params[n].detach().double() - p0[n].double()).norm())
              for n in names}
    del p0
    return {"faces": faces, "trainer": trainer, "state": state, "batches": batches,
            "lr": lr, "loader_seed": loader_seed,
            "program": {"losses": losses, "grad_norms": grad_norms, "change_norms": change,
                        "logits1": first_logits[0]}}


def window(run, ctx, t0, tracer):
    cfg = run.cfg
    trainer, batches = ctx["trainer"], ctx["batches"]
    deadline = t0 + run.seconds
    counts = {True: 0, False: 0}
    free_wait, epoch, first, marks = 0.0, 2, True, []

    def segment(source, traced: bool) -> bool:
        """Train on ``source`` (one ``run_epoch``); False when it is empty."""
        nonlocal free_wait
        it = iter(source)
        head = next(it, None)
        if head is None:
            return False
        ctx["state"], stats = trainer.run_epoch(ctx["state"], itertools.chain([head], it),
                                                epoch, True)
        counts[traced] += stats["num_samples"]
        if not traced:
            free_wait += stats["feed_wait_s"]
        return True

    while first or time.perf_counter() < deadline:
        source = iter(batches(epoch))
        if first and tracer.boundary(t0):
            segment(itertools.islice(source, TRACED_STEPS), True)
            tracer.finish()
        first = False
        segment(_until(source, deadline, marks, t0, counts[True] + counts[False],
                       run.workload["batch_size"]), False)
        epoch += 1
    tracer.finish()
    items = counts[True] + counts[False]
    marks.append((time.perf_counter() - t0, items))
    return {"count": items, "attempted": items, "failed": 0, "epochs": epoch - 2,
            "free_feed_wait_s": free_wait, "traced_count": counts[True], "progress": marks,
            "free_flops": counts[False] * senet_counts.train_flops(cfg, cfg["input_size"]),
            "peaks": card_peaks(run)}


def reference_readings(run, ctx, precision: str, fault: str | None) -> dict:
    cfg, wl, faces = run.cfg, run.workload, ctx["faces"]
    batches = fer.epoch_batches(faces.data, faces.votes, ctx["loader_seed"], 1,
                                wl["batch_size"], SETUP_STEPS)
    if fault == "half_batch":
        half = wl["batch_size"] // 2
        batches = [{k: v[:half] for k, v in b.items()} for b in batches]
    with exact_fp32():
        return fer.train_steps(cfg, _weights(run), batches, ctx["lr"], run.seed + 1,
                               run.device, precision)


def compare(prog: dict, refr: dict) -> dict:
    """``distill``'s numbers and the first step's largest logit gap over
    the reference logits' RMS (over the rows both have)."""
    out = compare_steps(prog, refr)
    a, b = prog["logits1"], refr["logits1"]
    n = min(len(a), len(b))
    out["logit1_gap"] = float(np.abs(a[:n] - b[:n]).max() / np.sqrt((b ** 2).mean()))
    return out


def check(run, ctx, win, variant=None):
    return training_check(run, ctx, variant, reference_readings, compare)
