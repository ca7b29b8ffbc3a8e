"""Student distillation training (``run_distillation.m``).

Port of ``mcncrossmodalemotions_tpu/exp/run_distillation.py``: trains the
VGG-M speech student to predict the teacher's 8 emotion logits (cached in
the imdb's ``wav_logits``) from audio alone. Defaults mirror
run_distillation.m:71-89: 4 s crops, batch 64, 300 epochs, LR
logspace(-4, -5), 'hot-cross-ent' loss at temperature 2, 'max' logit
aggregation, mini-val subsampling with seed 0, mini-epochs, an experiment
directory named from the config (the same name as the JAX module gives) with
run metadata dumped alongside (:95-105, :227-240).

On the card the host ships int16 crops (uint8 mu-law with ``mulaw_feed``);
decode, spectrogram (the K1 kernel), instance norm, the student (K2
forward-with-index and backward at pool1/pool2), the loss, the backward and
the SGD update run on one device. Every option of the JAX driver is here
but a multi-device ``mesh``:

- ``online_teacher``: the fused step (``train/distill.py``): the batches
  carry each crop's face frames and the frozen ``teacher_model`` computes
  the targets inside the step; the val pass ships no frames and scores
  against the cached ``wav_logits``;
- ``remat_policy``: the student recomputes activations in the backward
  (``train/state.py`` ``resolve_remat_policy``), in either step;
- ``mulaw_feed``, ``speed_aug``, ``noise_num``/``noise_dir``/``noise_vol``
  and ``time_offsets`` (fixedSegments): the batcher's options
  (``data/emovox.py``), each part of the experiment's identity.

``from_scratch=False`` starts from a released student ``.mat``
(``pretrained_student`` is its path or a registry name, resolved by
``zoo.resolve_release``), and
``load_student_from_exp`` rebuilds a trained student from an experiment
directory of either package for evaluation. ``use_pallas_frontend`` only
chose the JAX frontend's implementation; the port always runs the K1
wrapper, with the same function.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from mcncrossmodalemotions_torch import EMOTIONS
from mcncrossmodalemotions_torch.data.emovox import (
    BatchConfig,
    EmoVoxBatcher,
    NoiseConfig,
)
from mcncrossmodalemotions_torch.data.imdb import (
    SET_HEARD_VAL,
    SET_TRAIN,
    SET_UNHEARD_VAL,
    EmoVoxImdb,
)
from mcncrossmodalemotions_torch.models.pipeline import AudioStudentPipeline
from mcncrossmodalemotions_torch.models.vggm import VGGMStudent
from mcncrossmodalemotions_torch.train.checkpoints import read_from_exp
from mcncrossmodalemotions_torch.train.distill import make_online_distill_step
from mcncrossmodalemotions_torch.train.engine import (
    TrainConfig,
    Trainer,
    logspace_lr,
)
from mcncrossmodalemotions_torch.train.state import SGDConfig
from mcncrossmodalemotions_torch.utils.config import (
    config_hash,
    read_latest_run_config,
    write_run_meta,
)
from mcncrossmodalemotions_torch.utils.device import resolve_device
from mcncrossmodalemotions_torch.zoo import (
    STUDENT_MODELS,
    build_student,
    load_pretrained_student,
    student_loss_fn,
)


@dataclasses.dataclass(frozen=True)
class DistillationConfig:
    """run_distillation.m:71-89 defaults; the fields and defaults of the
    JAX ``DistillationConfig``."""

    teacher: str = "senet50-ferplus"
    student: str = "emovoxceleb-student"
    loss_type: str = "hot-cross-ent"
    temperature: float = 2.0
    num_seconds: float = 4.0
    num_pred_emotions: int = 8
    logit_aggregator: str = "max"
    batch_size: int = 64
    num_epochs: int = 300
    lr_start_exp: float = -4.0
    lr_stop_exp: float = -5.0
    mini_val: float = 0.2        # fraction of val kept (rng seed 0, :141-146)
    mini_epoch_ratio: float = 0.05  # epochSize fraction (:77,154)
    weight_decay: float = 5e-4   # cnn_train_dag default
    dropout: float = 0.0
    seed: int = 0
    data_root: str = "data/emovoxceleb"
    out_root: str = "exps"
    tiny_model: bool = False     # dev pattern
    use_pallas_frontend: bool = False
    remat_policy: Optional[str] = None
    from_scratch: bool = True
    pretrained_student: str = "emovoxceleb-student"
    online_teacher: bool = False
    frames_per_crop: int = 4
    frame_size: int = 224
    mulaw_feed: bool = False
    speed_aug: bool = False
    noise_dir: Optional[str] = None
    noise_num: int = 0
    noise_vol: float = 0.3

    def exp_name(self) -> str:
        """Experiment identity encoding (run_distillation.m:95-105) + hash;
        the string the JAX ``exp_name()`` gives for the same config. Only
        identity-defining fields are hashed, so a longer schedule resumes
        the same directory."""
        base = (
            f"{self.teacher}-{self.student}-{self.loss_type}"
            f"-{self.num_seconds:g}s-{self.num_pred_emotions}emo"
            f"-{self.logit_aggregator}-T{self.temperature:g}"
        )
        identity = (self.teacher, self.student, self.loss_type,
                    self.temperature, self.num_seconds,
                    self.num_pred_emotions, self.logit_aggregator,
                    self.dropout, self.seed, self.tiny_model,
                    self.online_teacher, self.lr_start_exp,
                    self.lr_stop_exp, self.weight_decay)
        if not self.from_scratch:
            identity += ("from-release", self.pretrained_student)
        if self.speed_aug or self.noise_num > 0:
            identity += ("speed" if self.speed_aug else "",
                         self.noise_num, self.noise_vol,
                         self.noise_dir or "")
        if self.mulaw_feed:
            identity += ("mulaw8",)
        suffix = "-online" if self.online_teacher else ""
        return f"{base}{suffix}-{config_hash(identity)}"


def mini_epoch_size(num_tracks: int, ratio: float, num_devices: int,
                    batch_size: int):
    """epochSize from miniEpochRatio (run_distillation.m:77,154), scaled by
    the data-parallel width; None (= full epoch) once that reaches 1."""
    scaled = ratio * num_devices
    if scaled >= 1:
        return None
    return max(int(round(num_tracks * scaled)), batch_size)


def split_imdb(imdb: EmoVoxImdb, mini_val: float, seed: int = 0):
    """Train/val split from set ids, with mini-val subsampling (:137-146).
    Returns (train_imdb, val_imdb, train_idx, val_idx)."""
    train_idx = np.where(imdb.set_id == SET_TRAIN)[0]
    val_idx = np.where(
        (imdb.set_id == SET_UNHEARD_VAL) | (imdb.set_id == SET_HEARD_VAL))[0]
    if 0 < mini_val < 1 and len(val_idx) > 1:
        rng = np.random.RandomState(seed)
        keep = max(int(round(len(val_idx) * mini_val)), 1)
        val_idx = np.sort(rng.permutation(val_idx)[:keep])
    return imdb.subset(train_idx), imdb.subset(val_idx), train_idx, val_idx


def run_distillation(cfg: DistillationConfig,
                     imdb: Optional[EmoVoxImdb] = None,
                     resume: bool = True, time_offsets=None,
                     device: torch.device | str = "cuda", *,
                     mesh="auto", teacher_model: Optional[nn.Module] = None):
    """Returns (final_state, history, exp_dir).

    On one ``device``. ``imdb`` None loads
    ``cfg.data_root/emovoxceleb-imdb.npz``. The offline mode trains on the
    imdb's cached ``wav_logits``; ``cfg.online_teacher`` needs an imdb with
    ``dense_frames`` and ``teacher_model``, a face teacher with its weights
    (``load_pretrained_teacher(..., with_pipeline=True)`` or
    ``exp.ferplus_baselines.load_teacher_from_exp``), which is moved to
    ``device`` and frozen. ``time_offsets`` ([num_tracks] seconds) is the
    reference's fixedSegments mode (run_distillation.m:86): pinned crop
    starts, whole-track targets, and an experiment directory keyed on the
    offsets. ``cfg.from_scratch=False`` starts from the released student
    ``cfg.pretrained_student``, a path or a registry name
    (``load_pretrained_student``;
    the widths are the release's), with the run's dropout rate. ``mesh``
    None or ``"auto"`` is the one device; a multi-device mesh raises.
    """
    if mesh is not None and mesh != "auto":
        raise NotImplementedError(
            "multi-card training (mesh=) is not ported yet; see ROADMAP.md "
            "item 15 (torch.distributed)")
    if cfg.online_teacher and teacher_model is None:
        raise ValueError("online_teacher=True requires teacher_model")
    if imdb is None:
        imdb_path = Path(cfg.data_root) / "emovoxceleb-imdb.npz"
        if not imdb_path.exists():
            raise FileNotFoundError(
                f"{imdb_path} not found — build it with "
                "exp/fetch_emovoxceleb_imdb (or pass a synthetic imdb)")
        imdb = EmoVoxImdb.load(imdb_path)

    train_imdb, val_imdb, train_idx, val_idx = split_imdb(
        imdb, cfg.mini_val, cfg.seed)
    train_offsets = val_offsets = None
    if time_offsets is not None:
        time_offsets = np.asarray(time_offsets, np.float64)
        train_offsets = time_offsets[train_idx]
        val_offsets = time_offsets[val_idx]
    noise = None
    if cfg.noise_num > 0:
        if cfg.noise_dir is None:
            raise ValueError("noise_num > 0 requires noise_dir "
                             "(meta.noise.noisedir)")
        noise = NoiseConfig(noise_dir=cfg.noise_dir, num_files=cfg.noise_num,
                            noise_vol=cfg.noise_vol)
    bcfg = BatchConfig(num_seconds=cfg.num_seconds, batch_size=cfg.batch_size,
                       loss_type=cfg.loss_type,
                       logit_aggregator=cfg.logit_aggregator,
                       num_pred_emotions=cfg.num_pred_emotions,
                       speed_aug=cfg.speed_aug, noise=noise,
                       frames_per_crop=(cfg.frames_per_crop
                                        if cfg.online_teacher else 0),
                       frame_size=cfg.frame_size, emit_mulaw=cfg.mulaw_feed)
    train_batcher = EmoVoxBatcher(train_imdb, bcfg, train=True, seed=cfg.seed,
                                  time_offsets=train_offsets)
    # the val pass scores against the cached wav_logits in either mode:
    # frames would more than double its feed for data it never reads
    val_batcher = EmoVoxBatcher(val_imdb,
                                dataclasses.replace(bcfg, frames_per_crop=0),
                                train=False, seed=cfg.seed,
                                time_offsets=val_offsets)
    epoch_size = mini_epoch_size(train_imdb.num_tracks, cfg.mini_epoch_ratio,
                                 1, cfg.batch_size)

    exp_dir = Path(cfg.out_root) / cfg.exp_name()
    if time_offsets is not None:
        # fixedSegments trains on other crops and targets: keyed on the
        # offsets, so a plain run's checkpoints are never resumed
        exp_dir = exp_dir.with_name(
            exp_dir.name + f"-fixedseg-{config_hash(tuple(time_offsets))}")
    tcfg = TrainConfig(
        num_epochs=cfg.num_epochs,
        batch_size=cfg.batch_size,
        epoch_size=epoch_size,  # engine cap; the batcher also subsamples
        learning_rate=logspace_lr(cfg.lr_start_exp, cfg.lr_stop_exp,
                                  cfg.num_epochs),
        weight_decay=cfg.weight_decay,
        seed=cfg.seed,
        exp_dir=str(exp_dir),
        resume=resume,
        # the fused step takes the policy from its builder below
        remat_policy=None if cfg.online_teacher else cfg.remat_policy,
    )
    if cfg.from_scratch:
        model = build_student(cfg.student, num_outputs=cfg.num_pred_emotions,
                              dropout=cfg.dropout, tiny=cfg.tiny_model,
                              loss_type=cfg.loss_type)
    else:
        # fromScratch=false (emoVoxZoo.m:25-44): the release's weights; the
        # run's parameter-free options still apply
        model, _ = load_pretrained_student(cfg.pretrained_student,
                                           with_frontend=True, device=device)
        model.net.dropout_rate = cfg.dropout
    loss_fn = student_loss_fn(cfg.loss_type, temperature=cfg.temperature,
                              num_classes=cfg.num_pred_emotions)
    step_override = None
    if cfg.online_teacher:
        step_override = make_online_distill_step(
            teacher_model.to(device), loss_type=cfg.loss_type,
            temperature=cfg.temperature, aggregator=cfg.logit_aggregator,
            num_classes=cfg.num_pred_emotions,
            sgd=SGDConfig(weight_decay=cfg.weight_decay),
            remat_policy=cfg.remat_policy)
    trainer = Trainer(model, loss_fn, tcfg,
                      class_names=EMOTIONS[: cfg.num_pred_emotions],
                      device=device, train_step_override=step_override)
    write_run_meta(exp_dir, cfg,
                   num_train_tracks=int(train_imdb.num_tracks),
                   num_val_tracks=int(val_imdb.num_tracks))
    state, history = trainer.fit(
        lambda epoch: train_batcher.batches(epoch, epoch_size=epoch_size,
                                            drop_remainder=True),
        val_batches_fn=lambda epoch: val_batcher.batches(epoch),
        state=trainer.init_state(scratch=cfg.from_scratch))
    return state, history, exp_dir


def load_student_from_exp(exp_dir, epoch: int | str | None = None,
                          with_frontend: bool = False,
                          device: torch.device | str = "cuda"
                          ) -> Tuple[nn.Module, Dict[str, torch.Tensor]]:
    """Rebuild the trained student of an experiment directory for eval.

    The reference's dev-checkpoint flow (emoVoxZoo.m:46-63). The
    directory is the port's (``net-epoch-N.pt``) or the JAX package's
    (``net-epoch-N.msgpack``, read by ``load_flax_checkpoint``); its newest
    run-metadata dump must name a ``DistillationConfig`` run of a known
    student. ``epoch`` None takes the latest readable checkpoint
    (last-good fallback), ``'best'`` ``find_best_epoch``'s pick, an int
    that epoch. The widths are the checkpoint's, so a from-release run
    needs no ``.mat`` file.

    Returns ``(model, state_dict)`` on ``device`` (the card unless the
    caller asks for the CPU), dropout off. With the default
    ``with_frontend=False`` the pipeline's ``net.`` prefix is stripped and
    the model is the bare ``VGGMStudent``, which ``compute_audio_feats``
    and ``student_stats`` take.
    """
    device = resolve_device(device, "load_student_from_exp")
    cfg = read_latest_run_config(exp_dir, DistillationConfig)
    if cfg.student not in STUDENT_MODELS:
        raise KeyError(f"{exp_dir}: unknown student {cfg.student!r}")
    _, record = read_from_exp(exp_dir, epoch)
    state = record["model"]
    if with_frontend:
        model_cls, prefix = AudioStudentPipeline, "net."
    else:
        model_cls, prefix = VGGMStudent, ""
        state = {k[len("net."):]: v for k, v in state.items()
                 if k.startswith("net.")}
    model = model_cls(fc6_features=state[prefix + "fc6.weight"].shape[0],
                      fc7_features=state[prefix + "fc7.weight"].shape[0],
                      num_outputs=state[prefix + "prediction.weight"].shape[0])
    model.load_state_dict(state, strict=True)
    return model.to(device), {k: v.to(device) for k, v in state.items()}
