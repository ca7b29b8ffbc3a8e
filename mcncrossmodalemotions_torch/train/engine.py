"""Epoch-loop training engine (``cnn_train_dag`` equivalent), PyTorch.

Port of ``mcncrossmodalemotions_tpu/train/engine.py`` for one device:
per-epoch LR schedule arrays, the engine-level ``epoch_size`` cap
("mini-epochs", run_distillation.m:77,154), separate train/val passes,
running loss averages + per-class accuracy/population stats
(run_distillation.m:186-207), per-epoch atomic checkpoints with
``continue`` resume (``train/checkpoints.py``), JSONL metrics and the NaN
tripwire.

The feed overlaps the host with the device: a producer thread runs the
host batch iterator (wav reads, int16 packing) and pins each batch's
arrays; the consumer starts their host-to-device copies ``non_blocking`` on
a side stream one batch ahead and records an event that the compute stream
waits on before the step reads the batch. Each epoch records where its
wall went: ``feed_wait_s`` (the loop waiting on the host feed),
``device_drain_s`` (the epoch-end sync that drains queued device work) and
``feed_bound_frac`` (feed wait / wall).
"""

from __future__ import annotations

import contextlib
import dataclasses
import queue
import threading
import time
from pathlib import Path
from typing import Any, Callable, Dict, Iterable, Optional, Sequence

import numpy as np
import torch
from torch import nn

from mcncrossmodalemotions_torch.train import checkpoints as ckpt_lib
from mcncrossmodalemotions_torch.train.state import (
    LossFn,
    SGDConfig,
    TrainState,
    make_eval_step,
    make_train_step,
)
from mcncrossmodalemotions_torch.utils.logging import MetricsLogger


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """cnn_train_dag options (run_distillation.m:71-89 defaults)."""

    num_epochs: int = 300
    batch_size: int = 64
    learning_rate: Sequence[float] | float = 1e-4
    momentum: float = 0.9
    weight_decay: float = 5e-4
    # samples per "mini-epoch" (None = all): the engine stops each train
    # pass at the first batch that reaches it; batchers shuffle per epoch,
    # so that is a random subset. Data-layer subsampling composes.
    epoch_size: Optional[int] = None
    seed: int = 0
    exp_dir: str = "exp"
    resume: bool = True  # the reference's 'continue' option
    checkpoint_every: int = 1
    log_every: int = 20
    # torch.profiler trace of the first train epoch, and a NaN tripwire
    # replacing the reference's `keyboard` drop (getBatchEmoVoxCeleb.m:189-192)
    profile_dir: Optional[str] = None
    nan_check: bool = True
    remat_policy: Optional[str] = None  # not ported: anything but None raises


def lr_for_epoch(cfg: TrainConfig, epoch: int) -> float:
    """Index the per-epoch LR array (1-based epochs, MATLAB convention)."""
    lr = cfg.learning_rate
    if isinstance(lr, (int, float)):
        return float(lr)
    return float(lr[min(epoch - 1, len(lr) - 1)])


def logspace_lr(start_exp: float, stop_exp: float, num: int) -> tuple:
    """``logspace(-4, -5, numEpochs)`` equivalent (run_distillation.m:82)."""
    return tuple(np.logspace(start_exp, stop_exp, num).tolist())


class MetricAverager:
    """Running batch-weighted averages + summed per-class stat vectors.

    Sums stay on the device (no sync per step); ``result()`` copies them
    to the host once, at epoch end.
    """

    def __init__(self):
        self.sums: Dict[str, torch.Tensor] = {}
        self.count = 0

    def update(self, metrics: Dict[str, torch.Tensor], batch_size: int) -> None:
        self.count += batch_size
        for key, value in metrics.items():
            value = value.detach().double()
            if value.ndim == 0:
                value = value * batch_size  # mean metric -> weighted sum
            prev = self.sums.get(key)
            self.sums[key] = value if prev is None else prev + value

    def result(self) -> Dict[str, Any]:
        out = {}
        for key, value in self.sums.items():
            value = value.cpu().numpy()  # the epoch's one sync
            if value.ndim == 0:
                out[key] = float(value / max(self.count, 1))
            else:
                out[key] = value  # summed vectors (e.g. per-class counts)
        return out


def summarize_class_stats(result: Dict[str, Any],
                          class_names: Sequence[str]) -> Dict[str, float]:
    """ErrorStats flattening: meanAcc, per-emotion acc, per-emotion
    population share (run_distillation.m:186-207)."""
    out = {k: v for k, v in result.items() if np.ndim(v) == 0}
    correct = result.get("class_correct")
    pop = result.get("class_pop")
    if correct is not None and pop is not None:
        acc = np.divide(correct, np.maximum(pop, 1.0))
        present = pop > 0
        out["meanAcc"] = float(acc[present].mean()) if present.any() else 0.0
        total = max(pop.sum(), 1.0)
        for i, name in enumerate(class_names):
            out[name] = float(acc[i])
            out[f"{name}Pop"] = float(pop[i] / total)
    return out


class Trainer:
    """Epoch orchestrator around the train/eval steps, on one device.

    ``model`` is a port module whose forward takes ``train`` and
    ``generator`` (dropout and the teachers' fliplr draw from the state's
    generator) and any of ``pad_mask`` and ``use_kernels``, which the step
    passes where the signature has them: the zoo's students take both, the
    face teachers' ``FaceTeacherPipeline`` only ``pad_mask``. It has
    ``reset_parameters(generator)`` for the scratch init. ``lr_scale_fn``
    maps a parameter's name split at the dots to its learning-rate
    multiplier (``train.state.finetune_lr_scale_fn``: 1.0 for the head,
    ``teacher.prediction.weight`` included, less for the backbone).
    """

    def __init__(self, model: nn.Module, loss_fn: LossFn, cfg: TrainConfig,
                 class_names: Sequence[str] = (),
                 device: torch.device | str = "cuda",
                 lr_scale_fn: Optional[Callable] = None):
        self.model = model
        self.cfg = cfg
        self.class_names = class_names
        self.device = torch.device(device)
        sgd = SGDConfig(momentum=cfg.momentum, weight_decay=cfg.weight_decay)
        self._train_step = make_train_step(loss_fn, sgd,
                                           lr_scale_fn=lr_scale_fn,
                                           remat_policy=cfg.remat_policy,
                                           pass_pad_mask=True)
        self._eval_step = make_eval_step(loss_fn)
        self._copy_stream = (torch.cuda.Stream(self.device)
                             if self.device.type == "cuda" else None)

    # -- device feed -------------------------------------------------------
    @staticmethod
    def _host_batch(batch: Dict[str, np.ndarray], pin: bool):
        """Attach ``pad_mask`` and wrap the arrays as (pinned) tensors.

        Every batch carries a [B] float ``pad_mask`` (1 = real sample), so
        the loss/metric stack and train-mode BatchNorm exclude padded rows
        exactly; the returned count is the number of valid samples.
        """
        bsz = int(np.shape(batch["data"])[0])
        if "pad_mask" in batch:
            n_valid = int(np.sum(batch["pad_mask"]))
        else:
            n_valid = bsz
            batch = dict(batch, pad_mask=np.ones(bsz, np.float32))
        host = {k: torch.from_numpy(np.ascontiguousarray(v))
                for k, v in batch.items()}
        if pin:
            host = {k: v.pin_memory() for k, v in host.items()}
        return n_valid, host

    def _to_device(self, item):
        """Start the batch's host-to-device copies; returns (n_valid,
        tensors, event). On the card the copies run ``non_blocking`` on the
        side stream and ``event`` marks their end."""
        n_valid, host = item
        if self._copy_stream is None:
            return n_valid, {k: v.to(self.device) for k, v in host.items()}, None
        with torch.cuda.stream(self._copy_stream):
            out = {k: v.to(self.device, non_blocking=True)
                   for k, v in host.items()}
            event = torch.cuda.Event()
            event.record(self._copy_stream)
        return n_valid, out, event

    def _wait(self, tensors: Dict[str, torch.Tensor], event) -> None:
        """Make the compute stream wait for the copies, and tell the
        allocator that the compute stream uses the side stream's memory."""
        if event is None:
            return
        compute = torch.cuda.current_stream(self.device)
        compute.wait_event(event)
        for t in tensors.values():
            t.record_stream(compute)

    def _prefetched(self, batches: Iterable[Dict[str, np.ndarray]]):
        """Yield (n_valid, device batch, event), batch k+1's copies started
        before batch k is handed to the step."""
        q: "queue.Queue" = queue.Queue(maxsize=2)
        sentinel = object()
        stop = threading.Event()
        error: list = []
        pin = self._copy_stream is not None

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.5)
                    return True
                except queue.Full:
                    continue
            return False

        def produce():
            try:
                for batch in batches:
                    if not put(self._host_batch(batch, pin)):
                        return
            except BaseException as exc:  # surfaced on the consumer side
                error.append(exc)
            finally:
                put(sentinel)  # until delivered or the consumer has left

        thread = threading.Thread(target=produce, daemon=True)
        thread.start()

        def host_items():
            while True:
                item = q.get()
                if item is sentinel:
                    if error:
                        raise error[0]
                    return
                yield item

        try:
            it = host_items()
            try:
                pending = self._to_device(next(it))
            except StopIteration:
                return
            for nxt in it:
                current = pending
                pending = self._to_device(nxt)  # async copy starts now
                yield current
            yield pending
        finally:
            # consumer left mid-epoch (cap, NaN tripwire, exception): end
            # the producer instead of leaving it parked on a full queue
            stop.set()
            while True:
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
            thread.join(timeout=10)

    # -- state ------------------------------------------------------------
    def init_state(self, scratch: bool = True) -> TrainState:
        """The state at epoch 0: the model moves to the device (after
        Flax's scratch init from ``cfg.seed``, on the CPU so the weights do
        not depend on the device, unless ``scratch`` is False and the model
        holds weights to start from); the dropout generator lives on the
        device, seeded ``cfg.seed + 1``."""
        if scratch:
            self.model.reset_parameters(
                torch.Generator().manual_seed(self.cfg.seed))
        gen = torch.Generator(device=self.device).manual_seed(self.cfg.seed + 1)
        return TrainState.create(self.model.to(self.device), gen)

    # -- epochs -----------------------------------------------------------
    def run_epoch(self, state: TrainState,
                  batches: Iterable[Dict[str, np.ndarray]], epoch: int,
                  train: bool = True):
        """One pass; returns (state, stats dict). ``batches`` yields dicts of
        numpy arrays with at least 'data'."""
        avg = MetricAverager()
        lr = lr_for_epoch(self.cfg, epoch)
        t0 = time.monotonic()
        n_batches = 0
        feed_wait = 0.0
        max_samples = self.cfg.epoch_size if (train and self.cfg.epoch_size) else None
        samples_done = 0
        with contextlib.ExitStack() as stack:
            if train and epoch == 1 and self.cfg.profile_dir:
                stack.enter_context(self._profiler())
            feed_iter = iter(self._prefetched(batches))
            stack.callback(feed_iter.close)  # ends the producer on any exit
            while max_samples is None or samples_done < max_samples:
                t_wait = time.monotonic()
                try:
                    bsz, device_batch, event = next(feed_iter)
                except StopIteration:
                    feed_wait += time.monotonic() - t_wait
                    break
                feed_wait += time.monotonic() - t_wait
                self._wait(device_batch, event)
                if train:
                    state, metrics = self._train_step(state, device_batch, lr)
                else:
                    metrics = self._eval_step(state, device_batch)
                avg.update(metrics, bsz)
                samples_done += bsz
                n_batches += 1
                if n_batches % self.cfg.log_every == 0:
                    loss_val = float(metrics["loss"])  # syncs
                    hz = avg.count / max(time.monotonic() - t0, 1e-9)
                    mode = "train" if train else "val"
                    print(f"epoch {epoch} [{mode}] batch {n_batches}: "
                          f"loss={loss_val:.4f} ({hz:.1f} samples/s)", flush=True)
                    if self.cfg.nan_check and not np.isfinite(loss_val):
                        raise FloatingPointError(
                            f"non-finite loss at epoch {epoch} batch "
                            f"{n_batches} (train={train}, lr={lr}): the "
                            "reference's NaN tripwire "
                            "(getBatchEmoVoxCeleb.m:189-192) as a hard error")
        if train and n_batches == 0:
            raise ValueError(
                f"epoch {epoch}: the train iterator yielded ZERO batches "
                "— batch_size likely exceeds the (mini-)epoch's sample "
                "count with drop_remainder=True; shrink batch_size or "
                "raise mini_epoch_ratio/dataset size")
        t_drain = time.monotonic()
        stats = summarize_class_stats(avg.result(), self.class_names)
        wall = max(time.monotonic() - t0, 1e-9)
        stats["samples_per_sec"] = avg.count / wall
        stats["num_samples"] = avg.count
        # wall = feed_wait (host feed not hidden by the device) + host
        # dispatch + device_drain (the epoch-end sync on queued work)
        stats["feed_wait_s"] = round(feed_wait, 3)
        stats["device_drain_s"] = round(time.monotonic() - t_drain, 3)
        stats["feed_bound_frac"] = round(feed_wait / wall, 3)
        if self.cfg.nan_check and not np.isfinite(stats.get("loss", 0.0)):
            raise FloatingPointError(
                f"non-finite epoch-{epoch} loss {stats['loss']} "
                f"(train={train}, lr={lr})")
        return state, stats

    @contextlib.contextmanager
    def _profiler(self):
        """torch.profiler over the epoch; the Chrome trace goes to
        ``profile_dir/trace.json``."""
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=acts) as prof:
            yield
        out = Path(self.cfg.profile_dir)
        out.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(out / "trace.json"))

    def fit(self, train_batches_fn: Callable[[int], Iterable],
            val_batches_fn: Optional[Callable[[int], Iterable]] = None,
            state: Optional[TrainState] = None):
        """Full training run with resume; returns (state, history).

        ``train_batches_fn(epoch)`` / ``val_batches_fn(epoch)`` build the
        per-epoch batch iterators. ``state`` None: scratch init.
        """
        cfg = self.cfg
        if state is None:
            state = self.init_state()
        start_epoch = 1
        if cfg.resume:
            last, state = ckpt_lib.load_latest(cfg.exp_dir, state)
            start_epoch = last + 1
        logger = MetricsLogger(Path(cfg.exp_dir) / "metrics.jsonl")
        history = []
        for epoch in range(start_epoch, cfg.num_epochs + 1):
            state, train_stats = self.run_epoch(
                state, train_batches_fn(epoch), epoch, train=True)
            record = {"epoch": epoch, "lr": lr_for_epoch(cfg, epoch),
                      "train": train_stats}
            if val_batches_fn is not None:
                state, val_stats = self.run_epoch(
                    state, val_batches_fn(epoch), epoch, train=False)
                record["val"] = val_stats
            logger.log(record)
            history.append(record)
            if epoch % cfg.checkpoint_every == 0 or epoch == cfg.num_epochs:
                ckpt_lib.save_checkpoint(cfg.exp_dir, epoch, state, record)
            print(f"epoch {epoch}/{cfg.num_epochs} done: " + " ".join(
                f"{k}={v:.4f}" for k, v in train_stats.items()
                if isinstance(v, float) and k in ("loss", "meanAcc", "classerror")),
                flush=True)
        return state, history
