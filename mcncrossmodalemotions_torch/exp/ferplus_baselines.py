"""FER2013+ teacher training and evaluation (``ferplus_baselines.m``).

Port of ``mcncrossmodalemotions_tpu/exp/ferplus_baselines.py`` on one
device (the card unless the caller passes ``device="cpu"``). Defaults
mirror ferplus_baselines.m:71-92: the senet50 teacher, the 'distributions'
loss against the rater votes (8-class 'CNTK' dataType), dropout 0.5, batch
128, the step LR schedule [0.01 x60, 0.001 x60, 0.0001 x60] with the
backbone at 0.1 of it, the zoom/rotate/skew affine warp on half of each
batch on the host and the random fliplr on the device. ``FerPlusConfig``
has the JAX config's fields and defaults, and ``exp_name()`` gives the same
directory name, so both packages resolve one experiment directory.

- ``ferplus_baselines``: train (with ``continue`` resume), or
  ``evaluate_only`` a subset from the latest or the best checkpoint
  (findBestEpoch, :120-136), on the 'CNTK', 'clean' or 'full' dataType;
  ``pretrained_mat`` fine-tunes from a base release (VGGFace2 or classic:
  head-resize surgery, a fresh head, which eval-only refuses) or runs a
  released FER+ teacher as it is.
- ``benchmark_ferplus_models``: the val/test accuracy table
  (``benchmark_ferplus_models.m``) with its per-config cache.
- ``load_teacher_from_exp``: the trained teacher of an experiment directory
  of either package, for ``compute_visual_feats`` and the dense build.

Multi-card training (``mesh``) is not ported: ``None`` and ``"auto"`` mean
the one device, any other mesh raises.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from mcncrossmodalemotions_torch import EMOTIONS
from mcncrossmodalemotions_torch.data.ferplus import (
    FerPlusImdb,
    clean_subset,
    ferplus_batches,
)
from mcncrossmodalemotions_torch.models.teacher_pipeline import (
    FaceTeacherPipeline,
)
from mcncrossmodalemotions_torch.train import checkpoints as ckpt_lib
from mcncrossmodalemotions_torch.train.engine import TrainConfig, Trainer
from mcncrossmodalemotions_torch.train.state import finetune_lr_scale_fn
from mcncrossmodalemotions_torch.utils.config import (
    config_hash,
    read_latest_run_config,
    write_run_meta,
)
from mcncrossmodalemotions_torch.utils.device import resolve_device
from mcncrossmodalemotions_torch.zoo import (
    CLASSIC_MODELS,
    VGGFACE2_MODELS,
    build_teacher,
    load_pretrained_teacher,
    prepare_classic_from_base,
    prepare_teacher_from_base,
    teacher_loss_fn,
)
from mcncrossmodalemotions_torch.zoo.matconvnet import mat_cache_scope
from mcncrossmodalemotions_torch.zoo.registry import release_mean_rgb

_SUBSET_IDS = {"train": 1, "val": 2, "test": 3}


def step_lr(values, epochs_each) -> tuple:
    """[0.01*60 0.001*60 0.0001*60]-style schedule (ferplus_baselines.m:79)."""
    out = []
    for v, n in zip(values, epochs_each):
        out.extend([v] * n)
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class FerPlusConfig:
    """ferplus_baselines.m:71-92 defaults; the fields and defaults of the
    JAX ``FerPlusConfig``."""

    model: str = "senet50-ferplus"
    loss_type: str = "distributions"
    num_classes: int = 8          # 8 = 'CNTK'/'clean', 10 = 'full' (:87-92)
    # dataType override 'CNTK' | 'clean' | 'full' (:62); None derives it from
    # num_classes; 'clean' filters with data/ferplus.clean_subset first
    data_type: Optional[str] = None
    batch_size: int = 128
    dropout: float = 0.5
    lr_values: tuple = (0.01, 0.001, 0.0001)
    lr_epochs: tuple = (60, 60, 60)
    momentum: float = 0.9
    weight_decay: float = 5e-4
    finetune_lr: float = 0.1  # backbone LR multiplier (:74)
    # useBnorm retrofit of the BN-less classics (:60, ferPlusZoo.m:123);
    # None keeps each model's default ('-bn' names on); ResNets ignore it
    use_bnorm: Optional[bool] = None
    augment: bool = True
    # warp straight to input_size on the host in one bilinear sample (the
    # reference's composition, :194-213) instead of warp@48 + device resize
    augment_at_target: bool = False
    input_size: int = 224
    seed: int = 0
    out_root: str = "exps"
    tiny_model: bool = False
    dev: bool = False             # opts.dev: 1000 train/val, 1 epoch (:59,112-118)
    # a MatConvNet teacher .mat: a base release is fine-tuned after
    # head-resize surgery, a released FER+ teacher is used as it is
    pretrained_mat: Optional[str] = None

    def exp_name(self) -> str:
        """The JAX ``exp_name()`` of the same config: identity fields only
        (the schedule and paths stay out), so a longer schedule resumes the
        same directory (buildExpDirName, ferplus_baselines.m:297-309)."""
        identity = (self.model, self.loss_type, self.num_classes,
                    self.dropout, self.augment, self.input_size,
                    self.seed, self.tiny_model, self.dev, self.finetune_lr,
                    self.pretrained_mat)
        if self.augment_at_target:
            identity += ("aug-at-target",)
        if self.use_bnorm is not None:
            identity += ("bnorm" if self.use_bnorm else "nobnorm",)
        if self.data_type is not None:
            identity += (self.data_type,)
        return f"ferplus-{self.model}-{self.loss_type}-{config_hash(identity)}"


def _one_device(mesh) -> None:
    if mesh is not None and mesh != "auto":
        raise NotImplementedError(
            "multi-card teacher training (mesh=) is not ported yet; see "
            "ROADMAP.md queue 1, item 15 (scale-out)")


def build_pipeline(cfg: FerPlusConfig) -> FaceTeacherPipeline:
    """The scratch pipeline of ``cfg``: ``build_teacher`` with the run's
    dropout, useBnorm and input size, the head init at 1/100."""
    teacher = build_teacher(cfg.model, num_outputs=cfg.num_classes,
                            dropout=cfg.dropout, tiny=cfg.tiny_model,
                            use_bnorm=cfg.use_bnorm,
                            input_size=cfg.input_size)
    teacher.head_init_scale = 0.01
    return FaceTeacherPipeline(teacher, input_size=cfg.input_size,
                               augment=cfg.augment)


def _from_release(cfg: FerPlusConfig, augment: bool, dropout: float,
                  device: torch.device
                  ) -> Tuple[FaceTeacherPipeline, Dict[str, torch.Tensor], bool]:
    """(pipeline, state_dict, fresh_head) of ``cfg.pretrained_mat``: a base
    release after head-resize surgery (ferPlusZoo.m:116-199), normalised
    with the release's own mean image, with ``dropout``; or a released FER+
    teacher as it is (ferPlusZoo.m:103-114)."""
    path = cfg.pretrained_mat
    if cfg.model not in VGGFACE2_MODELS + CLASSIC_MODELS:
        model, state = load_pretrained_teacher(
            path, with_pipeline=True, input_size=cfg.input_size,
            augment=augment, device=device)
        return model, state, False
    with mat_cache_scope():  # params and meta from one parse
        if cfg.model in VGGFACE2_MODELS:
            teacher, state = prepare_teacher_from_base(
                path, num_outputs=cfg.num_classes, seed=cfg.seed,
                device=device)
        else:
            teacher, state = prepare_classic_from_base(
                path, cfg.model, num_outputs=cfg.num_classes, seed=cfg.seed,
                use_bnorm=cfg.use_bnorm, input_size=cfg.input_size,
                device=device)
        mean = release_mean_rgb(path)
    teacher.dropout_rate = dropout
    kw = {"mean_rgb": mean} if mean is not None else {}
    model = FaceTeacherPipeline(teacher, input_size=cfg.input_size,
                                augment=augment, **kw)
    return model, {f"teacher.{k}": v for k, v in state.items()}, True


def _data_type(cfg: FerPlusConfig) -> str:
    data_type = cfg.data_type or ("CNTK" if cfg.num_classes == 8 else "full")
    if data_type not in ("CNTK", "clean", "full"):
        raise ValueError(f"unknown dataType {data_type!r}; known: "
                         "CNTK | clean | full (ferplus_baselines.m:62)")
    expected = 10 if data_type == "full" else 8
    if cfg.num_classes != expected:
        raise ValueError(
            f"dataType {data_type!r} is {expected}-class but "
            f"num_classes={cfg.num_classes} (ferplus_baselines.m:87-92)")
    return data_type


def ferplus_baselines(cfg: FerPlusConfig, imdb: FerPlusImdb,
                      evaluate_only: Optional[str] = None,
                      use_best_epoch: bool = False, mesh="auto",
                      resume: bool = True,
                      device: torch.device | str = "cuda"):
    """Train (or evaluate) the teacher; returns ``(state, history)``, or
    ``(state, stats)`` with ``evaluate_only``.

    ``evaluate_only`` in {'val', 'test'} runs one evaluation pass over that
    subset (ferplus_baselines.m:120-136) from the experiment directory's
    latest checkpoint, or with ``use_best_epoch`` the one with the lowest
    val classerror; ``stats['accuracy']`` is 1 - classerror. An experiment
    directory without a checkpoint, or a base release's fresh head, raises
    ``ValueError``: an untrained teacher is never reported. Training writes
    the run metadata (``load_teacher_from_exp`` rebuilds from it) and
    resumes from the newest readable checkpoint unless ``resume`` is
    False."""
    _one_device(mesh)
    device = resolve_device(device, "ferplus_baselines")
    if cfg.dev:
        keep = np.concatenate([np.where(imdb.set_id == s)[0][:1000]
                               for s in (1, 2, 3)])
        imdb = imdb.subset(np.sort(keep))
    data_type = _data_type(cfg)
    if data_type == "clean":
        imdb = clean_subset(imdb)

    exp_dir = Path(cfg.out_root) / cfg.exp_name()
    tcfg = TrainConfig(
        num_epochs=1 if cfg.dev else sum(cfg.lr_epochs),
        batch_size=cfg.batch_size,
        learning_rate=step_lr(cfg.lr_values, cfg.lr_epochs),
        momentum=cfg.momentum,
        weight_decay=cfg.weight_decay,
        seed=cfg.seed,
        exp_dir=str(exp_dir),
        resume=resume,
    )
    released = fresh_head = False
    if cfg.pretrained_mat is not None:
        model, weights, fresh_head = _from_release(cfg, cfg.augment,
                                                   cfg.dropout, device)
        model.load_state_dict(weights, strict=True)
        released = True
    else:
        model = build_pipeline(cfg)
    lr_scale = (finetune_lr_scale_fn(backbone_scale=cfg.finetune_lr)
                if cfg.finetune_lr != 1.0 else None)
    trainer = Trainer(model, teacher_loss_fn(cfg.loss_type, cfg.num_classes),
                      tcfg, class_names=EMOTIONS, device=device,
                      lr_scale_fn=lr_scale)

    if evaluate_only is not None:
        subset = _SUBSET_IDS[evaluate_only]
        if released and fresh_head:
            raise ValueError(
                f"{cfg.model!r} is a base model whose classifier was just "
                "re-initialised (head-resize surgery): there is nothing "
                "trained to evaluate. Fine-tune first, or evaluate a "
                "released ferplus model or a checkpoint.")
        state = trainer.init_state(scratch=False)
        if not released:
            epoch = (ckpt_lib.find_best_epoch(
                exp_dir, suffix=ckpt_lib.exp_suffix(exp_dir))
                if use_best_epoch else None)
            try:
                state = ckpt_lib.restore_from_exp(exp_dir, state, epoch)
            except FileNotFoundError as exc:
                raise ValueError(
                    f"evaluate_only={evaluate_only!r}: no trained checkpoint "
                    f"in {exp_dir} ({exc}); train first, or evaluate a "
                    "released model through pretrained_mat") from exc
        _, stats = trainer.run_epoch(
            state, ferplus_batches(imdb, subset, cfg.batch_size,
                                   data_type=data_type),
            epoch=1, train=False)
        stats["accuracy"] = 1.0 - stats["classerror"]  # benchmark_ferplus_models.m:51-56
        return state, stats

    write_run_meta(exp_dir, cfg, data_type=data_type,
                   num_images=int(imdb.data.shape[0]))
    out_size = cfg.input_size if cfg.augment_at_target else None
    return trainer.fit(
        lambda epoch: ferplus_batches(imdb, 1, cfg.batch_size, shuffle=True,
                                      seed=cfg.seed + epoch,
                                      drop_remainder=True,
                                      data_type=data_type,
                                      augment=cfg.augment,
                                      augment_out_size=out_size),
        val_batches_fn=lambda epoch: ferplus_batches(
            imdb, 2, cfg.batch_size, data_type=data_type),
        state=trainer.init_state(scratch=not released))


def benchmark_ferplus_models(imdb: FerPlusImdb, out_root: str = "exps",
                             models=(("resnet50-ferplus", "softmaxlog"),
                                     ("senet50-ferplus", "distributions")),
                             tiny_model: bool = False,
                             base_cfg: Optional[FerPlusConfig] = None,
                             cache_dir: Optional[str] = None,
                             pretrained_mats: Optional[dict] = None,
                             refresh: bool = False,
                             device: torch.device | str = "cuda") -> dict:
    """``benchmark_ferplus_models.m``: {model: {'valAcc', 'testAcc'}} from
    eval-only runs on FER+ val and test.

    ``base_cfg`` carries the training-time options, so each eval resolves
    its training run's experiment directory; ``pretrained_mats`` maps a
    model name to a released ``.mat`` path, evaluated as it is. Each row is
    cached in ``cache_dir`` under the eval configuration's ``exp_name()``
    (:40-60); ``refresh`` evaluates past the cache (:22)."""
    results = {}
    for model_name, loss_type in models:
        mat = (pretrained_mats or {}).get(model_name)
        kw = dict(model=model_name, loss_type=loss_type, out_root=out_root,
                  tiny_model=tiny_model, pretrained_mat=mat)
        cfg = (dataclasses.replace(base_cfg, **kw) if base_cfg is not None
               else FerPlusConfig(**kw))
        cache = (Path(cache_dir) / f"{cfg.exp_name()}.json") if cache_dir \
            else None
        if cache and cache.exists() and not refresh:
            results[model_name] = json.loads(cache.read_text())
            continue
        row = {}
        for subset in ("val", "test"):
            _, stats = ferplus_baselines(cfg, imdb, evaluate_only=subset,
                                         device=device)
            row[f"{subset}Acc"] = stats["accuracy"]
        results[model_name] = row
        if cache:
            cache.parent.mkdir(parents=True, exist_ok=True)
            cache.write_text(json.dumps(row))
        print(f"{model_name}: val {row['valAcc']:.3f} test {row['testAcc']:.3f}")
    return results


def load_teacher_from_exp(exp_dir, epoch: int | str | None = None,
                          with_pipeline: bool = True,
                          device: torch.device | str = "cuda"
                          ) -> Tuple[nn.Module, Dict[str, torch.Tensor]]:
    """Rebuild the trained teacher of a ``ferplus_baselines`` experiment
    directory, the port's (``net-epoch-N.pt``) or the JAX package's
    (``net-epoch-N.msgpack``), for evaluation (the dev-checkpoint flow,
    ferPlusZoo.m:63-92).

    The newest run-metadata dump gives the run's ``FerPlusConfig``; the
    module is rebuilt (a run fine-tuned from ``pretrained_mat`` through the
    same surgery, with the release's own mean image, so the recorded
    ``.mat`` must still be readable) and the checkpoint loaded: ``epoch``
    None the latest readable one, ``'best'`` ``find_best_epoch``'s pick, an
    int that epoch. Returns ``(model, state_dict)`` on ``device`` (the card
    unless the caller asks for the CPU), in eval mode, fliplr and dropout
    off: the ``FaceTeacherPipeline`` that ``compute_visual_feats`` takes, or
    with ``with_pipeline=False`` the bare teacher (keys without the
    ``teacher.`` prefix)."""
    device = resolve_device(device, "load_teacher_from_exp")
    cfg = read_latest_run_config(exp_dir, FerPlusConfig)
    if cfg.pretrained_mat is not None:
        model, _, _ = _from_release(cfg, False, 0.0, torch.device("cpu"))
    else:
        model = build_pipeline(cfg)
        model.augment = False
        model.teacher.dropout_rate = 0.0
    _, record = ckpt_lib.read_from_exp(exp_dir, epoch, kind="teacher")
    state = record["model"]
    model.load_state_dict(state, strict=True)
    if not with_pipeline:
        model = model.teacher
        state = {k[len("teacher."):]: v for k, v in state.items()}
    return model.to(device).eval(), {k: v.to(device) for k, v in state.items()}
