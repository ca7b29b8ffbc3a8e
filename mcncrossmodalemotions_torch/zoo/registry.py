"""The port's zoo (``mcncrossmodalemotions_tpu/zoo/registry.py``): the student's
``build_student`` (emoVoxZoo.m:25-31, scratch init :202-243),
``load_pretrained_student`` (the released weights, emoVoxZoo.m:25-44) and
``student_loss_fn`` (emoVoxZoo.m:137-169); the face teachers'
``build_teacher`` for every name of the reference's teacher zoo
(ferPlusZoo.m:37-92: the ResNet/SENet teachers and bases, the classic VGG
face models), ``load_pretrained_teacher`` (ferPlusZoo.m:103-114), the
fine-tuning entry points ``prepare_teacher_from_base`` and
``prepare_classic_from_base`` (head-resize surgery, ferPlusZoo.m:116-199),
``release_mean_rgb``, the conv-bias folds, ``teacher_loss_fn``
(ferPlusZoo.m:239-255) and the dev-checkpoint registry (ferPlusZoo.m:63-92).

Released ``.mat`` files are read by the port's own copy of the MatConvNet
importer (``zoo/matconvnet.py``) and reach the model through the weight
bridge (``zoo/bridge.py``). Every loader takes a path or a registry name
(``resolve_release``: ``zoo/artifacts.py``, download on a miss unless the
caller passes ``download=False``).
"""

from __future__ import annotations

from pathlib import Path
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from mcncrossmodalemotions_torch.losses import (
    class_error,
    distillation_ce,
    distribution_ce,
    euclidean_loss,
    huber_loss,
    per_class_stats,
    softmax_ce,
)
from mcncrossmodalemotions_torch.models.pipeline import AudioStudentPipeline
from mcncrossmodalemotions_torch.models.resnet import ResNet, ResNet50, SENet50
from mcncrossmodalemotions_torch.models.surgery import reinit_head
from mcncrossmodalemotions_torch.models.teacher_pipeline import (
    FaceTeacherPipeline,
)
from mcncrossmodalemotions_torch.models.vggface import VGGFace
from mcncrossmodalemotions_torch.models.vggm import VGGMStudent
from mcncrossmodalemotions_torch.ops.spectrogram import DEFAULT_SPEC, SpecConfig
from mcncrossmodalemotions_torch.utils.device import resolve_device
from mcncrossmodalemotions_torch.zoo.bridge import (
    student_state_dict_from_flax,
    teacher_state_dict_from_flax,
)

STUDENT_MODELS = ("emovoxceleb-student",)
TEACHER_MODELS = ("resnet50-ferplus", "senet50-ferplus")
# VGGFace2-pretrained bases (ferPlusZoo.m:37-42), the starting points of
# FER+ fine-tuning: the same architectures (prepare_teacher_from_base)
VGGFACE2_MODELS = ("resnet50_ft-dag", "resnet50_scratch-dag",
                   "senet50_ft-dag", "senet50_scratch-dag")
# classic pre-ResNet face models (ferPlusZoo.m:44-59): VGG-VD-16 and VGG-M
# stacks (models/vggface.py); '-bn' names carry BatchNorm, the rest take the
# useBnorm retrofit (build_teacher(use_bnorm=True)). 'resnet50-face-sfew' is
# a plain ResNet50 and goes with the ResNet names.
CLASSIC_MODELS = ("vgg_face", "vgg-vd-face", "vgg-vd-face-fer",
                  "vgg-vd-face-sfew", "vgg-vd-face-sfew-dag",
                  "vgg-m-face-bn", "vgg-m-face-bn-fer")


def resolve_release(name_or_path, download: bool = True):
    """Map a released-model NAME to a local .mat path (download on a miss,
    emoVoxZoo.m:74-102 / ferPlusZoo fetchModel); an existing path passes
    through untouched, and any other string is left for the loader to
    reject."""
    if Path(str(name_or_path)).exists():
        return name_or_path
    from mcncrossmodalemotions_torch.zoo.artifacts import (
        ARTIFACTS,
        fetch_artifact,
    )

    if str(name_or_path) in ARTIFACTS:
        return fetch_artifact(str(name_or_path), download=download)
    return name_or_path


def _release_file(mat_path: str | Path, download: bool) -> Path:
    """``resolve_release``, then a check that the result is a file."""
    path = Path(resolve_release(mat_path, download=download))
    if not path.is_file():
        raise FileNotFoundError(f"{mat_path}: no such release file, and not "
                                "a name of zoo.artifacts.ARTIFACTS")
    return path


def build_student(name: str = "emovoxceleb-student", *,
                  num_outputs: int = 8,
                  dropout: float = 0.0,
                  spec: SpecConfig = DEFAULT_SPEC,
                  with_frontend: bool = True,
                  loss_type: Optional[str] = None,
                  use_bnorm: bool = True,
                  tiny: bool = False,
                  dtype: torch.dtype = torch.bfloat16,
                  generator: Optional[torch.Generator] = None):
    """The waveform->logits pipeline (``with_frontend``) or the bare
    spectrogram-input VGG-M, with Flax's scratch init drawn from
    ``generator``. ``tiny`` gives the JAX zoo's width-reduced test variant
    (fc6 64, fc7 32). For ``loss_type='euclidean'`` the head init is scaled
    down a further 10x (emoVoxZoo.m:140-144)."""
    if name not in STUDENT_MODELS:
        raise KeyError(f"unknown student {name!r}; known: {STUDENT_MODELS}")
    kw = dict(num_outputs=num_outputs, dropout_rate=dropout, dtype=dtype,
              generator=generator)
    if loss_type == "euclidean":
        kw["head_init_scale"] = 1e-4 / 10.0
    if tiny:
        kw.update(fc6_features=64, fc7_features=32)
    if with_frontend:
        if not use_bnorm:
            raise ValueError("use_bnorm=False is only supported for the "
                             "bare model (with_frontend=False)")
        return AudioStudentPipeline(spec=spec, **kw)
    return VGGMStudent(use_batchnorm=use_bnorm, **kw)


def fold_conv_biases(variables: dict) -> dict:
    """Fold the release's conv and fc6 biases into the BN running means,
    in place, and return ``variables``.

    The student's convs are bias-free (the following BN absorbs the bias):
    a released bias b shifts the BN input, and the release's running mean
    mu was estimated on conv(x)+b, so dropping b shifts the mean to mu-b
    to keep (z-mu)/sigma identical (the JAX ``load_pretrained_student``).
    """
    bn_for = {f"conv{i}": f"bn{i}" for i in range(1, 6)}
    bn_for["fc6"] = "bn6"
    for conv_name, bn_name in bn_for.items():
        conv = variables["params"].get(conv_name, {})
        bias = conv.pop("bias", None)
        if bias is not None and bn_name in variables["batch_stats"]:
            stats = variables["batch_stats"][bn_name]
            stats["mean"] = np.asarray(stats["mean"]) - np.asarray(bias)
    return variables


def load_pretrained_student(mat_path: str | Path, *,
                            with_frontend: bool = True,
                            spec: SpecConfig = DEFAULT_SPEC,
                            download: bool = True,
                            device: torch.device | str = "cuda"
                            ) -> Tuple[nn.Module, Dict[str, torch.Tensor]]:
    """Load a released MatConvNet student ``.mat`` (classic or ``-v7.3``).

    The fromScratch=False path of emoVoxZoo (emoVoxZoo.m:25-44): returns
    ``(model, state_dict)`` with the imported weights, the model on
    ``device`` (the card unless the caller asks for the CPU) and the
    ``state_dict`` a separate copy of them there. The widths (fc6, fc7,
    head) come from the release; the conv biases are folded into the BN
    means (``fold_conv_biases``). With ``with_frontend`` the model is the
    waveform pipeline and the keys carry its ``net.`` prefix; without it,
    the bare spectrogram-input VGG-M that ``compute_audio_feats`` takes.
    ``mat_path`` may be a registry name ('emovoxceleb-student'), resolved
    by ``resolve_release``.
    """
    from mcncrossmodalemotions_torch.zoo.matconvnet import (
        import_vggm_student,
        mat_cache_scope,
    )

    device = resolve_device(device, "load_pretrained_student")
    mat_path = _release_file(mat_path, download)
    with mat_cache_scope():
        variables = fold_conv_biases(import_vggm_student(mat_path))
    params = variables["params"]
    dims = dict(fc6_features=int(params["fc6"]["kernel"].shape[-1]),
                fc7_features=int(params["fc7"]["kernel"].shape[-1]),
                num_outputs=int(params["prediction"]["kernel"].shape[-1]))
    if with_frontend:
        model = AudioStudentPipeline(spec=spec, **dims)
        variables = {"params": {"net": variables["params"]},
                     "batch_stats": {"net": variables["batch_stats"]}}
    else:
        model = VGGMStudent(**dims)
    state = student_state_dict_from_flax(variables)
    model.load_state_dict(state, strict=True)
    return model.to(device), {k: v.to(device) for k, v in state.items()}


def build_teacher(name: str = "senet50-ferplus", *,
                  num_outputs: int = 8,
                  dropout: float = 0.0,
                  use_bnorm: Optional[bool] = None,
                  tiny: bool = False,
                  input_size: int = 224) -> nn.Module:
    """Teacher zoo (ferPlusZoo.m:37-92 registry, 8-way CNTK head).

    The ResNet/SENet names build ``models.resnet.ResNet`` (``tiny``:
    ``stage_sizes=(1, 1)``, ``width=8``), the classic VGG face names
    (``CLASSIC_MODELS``) ``models.vggface.VGGFace`` (``tiny``: width 1/16,
    fc 64) for ``input_size`` inputs (fc6's kernel covers the extent left
    there). ``dropout`` is the reference's insert_dropout option
    (ferPlusZoo.m:213-233): the ResNet's single pooled-embedding dropout,
    VGGFace's after fc6 and fc7. ``use_bnorm`` is the useBnorm retrofit
    (ferPlusZoo.m:123) of the classics: on for the '-bn' names by default,
    off for the rest; the ResNets carry BatchNorm and ignore it."""
    if name in CLASSIC_MODELS:
        bn = ("-bn" in name) if use_bnorm is None else use_bnorm
        kw = dict(arch="m" if name.startswith("vgg-m") else "vd",
                  use_batchnorm=bn, num_outputs=num_outputs,
                  dropout_rate=dropout, input_size=input_size)
        if tiny:
            kw.update(width_multiplier=1 / 16, fc_features=64)
        return VGGFace(**kw)
    known = TEACHER_MODELS + VGGFACE2_MODELS + ("resnet50-face-sfew",)
    if name not in known:
        raise KeyError(f"unknown teacher {name!r}; known: "
                       f"{known + CLASSIC_MODELS}")
    use_se = name.startswith("senet")
    kw = dict(num_outputs=num_outputs, dropout_rate=dropout)
    if tiny:
        return ResNet(stage_sizes=(1, 1), width=8, use_se=use_se, **kw)
    return SENet50(**kw) if use_se else ResNet50(**kw)


def fold_teacher_conv_biases(arch: dict, variables: dict) -> dict:
    """Fold any released conv bias into the following BatchNorm's running
    mean, in place, and return ``variables``: the ResNet convs are
    bias-free, and mean' = mean - bias keeps (z - mean) / sigma identical
    (the JAX ``_fold_teacher_conv_biases``)."""

    def fold(node_params, node_stats, conv_name, bn_name):
        conv = node_params.get(conv_name)
        if conv is None:
            return
        bias = conv.pop("bias", None)
        if bias is not None and bn_name in node_stats:
            stats = node_stats[bn_name]
            stats["mean"] = np.asarray(stats["mean"]) - np.asarray(bias)

    fold(variables["params"], variables["batch_stats"], "conv1", "bn1")
    for s, num_blocks in enumerate(arch["stage_sizes"], start=1):
        for b in range(num_blocks):
            block = f"layer{s}_{b}"
            bp = variables["params"].get(block, {})
            bs = variables["batch_stats"].get(block, {})
            for conv_name, bn_name in (("conv1", "bn1"), ("conv2", "bn2"),
                                       ("conv3", "bn3"),
                                       ("downsample", "bn_down")):
                fold(bp, bs, conv_name, bn_name)
    return variables


def release_mean_rgb(mat_path: str | Path, download: bool = True
                     ) -> Optional[Tuple[float, ...]]:
    """Per-channel mean from a release's ``normalization.averageImage``, an
    RGB 3-tuple, or None without one. A full HxWx3 average image (the
    classic releases) is reduced to its per-channel means; the VGGFace2
    dags store a 3-vector. ``mat_path`` may be a registry name."""
    from mcncrossmodalemotions_torch.zoo.matconvnet import (
        load_mat_meta,
        mat_cache_scope,
    )

    with mat_cache_scope():
        avg = load_mat_meta(_release_file(mat_path, download)).get(
            "averageImage")
    if avg is None:
        return None
    avg = np.asarray(avg, np.float64)
    if avg.size <= 3:
        return tuple(float(v) for v in avg.reshape(-1)[:3])
    return tuple(float(v) for v in avg.reshape(-1, avg.shape[-1])
                 .mean(axis=0)[:3])


def load_pretrained_teacher(mat_path: str | Path, *,
                            with_pipeline: bool = False,
                            input_size: int = 224,
                            augment: bool = False,
                            download: bool = True,
                            device: torch.device | str = "cuda"
                            ) -> Tuple[nn.Module, Dict[str, torch.Tensor]]:
    """Load a released MatConvNet teacher ``.mat`` (classic or ``-v7.3``)
    into the ResNet/SENet.

    The pretrained path of ferPlusZoo (ferPlusZoo.m:103-114). The
    architecture (stage sizes, SE blocks, width, head) is inferred from the
    parameter names and shapes; conv biases are folded into the BN means.
    Returns ``(model, state_dict)``, the model on ``device`` (the card
    unless the caller asks for the CPU) in eval mode and the ``state_dict``
    a separate copy there. With ``with_pipeline`` the model is a
    ``FaceTeacherPipeline`` whose ``mean_rgb`` is the release's
    ``normalization.averageImage`` where it has one, its train-mode fliplr
    on with ``augment``, and the keys carry its ``teacher.`` prefix. The
    ResNet computes in bf16; an fp32 caller
    sets its ``dtype`` (the pipeline's ``teacher.dtype``). ``mat_path`` may
    be a registry name ('senet50-ferplus'), resolved by ``resolve_release``.
    """
    from mcncrossmodalemotions_torch.zoo.matconvnet import (
        import_teacher,
        mat_cache_scope,
    )

    device = resolve_device(device, "load_pretrained_teacher")
    mat_path = _release_file(mat_path, download)
    with mat_cache_scope():  # params and meta from one parse
        arch, variables = import_teacher(mat_path)
        fold_teacher_conv_biases(arch, variables)
        model: nn.Module = ResNet(stage_sizes=arch["stage_sizes"],
                                  use_se=arch["use_se"], width=arch["width"],
                                  num_outputs=arch["num_outputs"])
        if with_pipeline:
            mean = release_mean_rgb(mat_path)
            kw = {"mean_rgb": mean} if mean is not None else {}
            model = FaceTeacherPipeline(model, input_size=input_size,
                                        augment=augment, **kw)
            variables = {"params": {"teacher": variables["params"]},
                         "batch_stats": {"teacher": variables["batch_stats"]}}
    state = teacher_state_dict_from_flax(variables)
    model.load_state_dict(state, strict=True)
    return (model.to(device).eval(),
            {k: v.to(device) for k, v in state.items()})


def _loaded(model: nn.Module, state: Dict[str, torch.Tensor],
            device: torch.device) -> Tuple[nn.Module, Dict[str, torch.Tensor]]:
    model.load_state_dict(state, strict=True)
    return model.to(device), {k: v.to(device) for k, v in state.items()}


def prepare_teacher_from_base(mat_path: str | Path, *, num_outputs: int = 8,
                              seed: int = 0, download: bool = True,
                              device: torch.device | str = "cuda"
                              ) -> Tuple[nn.Module, Dict[str, torch.Tensor]]:
    """Fine-tune entry point: a VGGFace2 base ``.mat`` (e.g. the 8631-way
    ``senet50_ft-dag``) -> a FER+-ready ResNet/SENet.

    The reference's surgery path (ferPlusZoo.m:116-199 prepareFromDagNN):
    the importer reads the conv/BN stack (the loss layers stay behind),
    conv biases fold into the BN means, and the classifier is resized to
    ``num_outputs`` and re-initialised at scale 1/100 with zero biases
    (``models/surgery.reinit_head``, drawn from a generator seeded by
    ``seed``). Returns ``(model, state_dict)`` on ``device`` (the card
    unless the caller asks for the CPU); the backbone's learning-rate
    scaling comes from ``train.state.finetune_lr_scale_fn``."""
    from mcncrossmodalemotions_torch.zoo.matconvnet import (
        import_teacher,
        mat_cache_scope,
    )

    device = resolve_device(device, "prepare_teacher_from_base")
    mat_path = _release_file(mat_path, download)
    with mat_cache_scope():
        arch, variables = import_teacher(mat_path)
    fold_teacher_conv_biases(arch, variables)
    state = reinit_head(teacher_state_dict_from_flax(variables), num_outputs,
                        seed, scale=1.0 / 100.0)
    model = ResNet(stage_sizes=arch["stage_sizes"], use_se=arch["use_se"],
                   width=arch["width"], num_outputs=num_outputs)
    return _loaded(model, state, device)


def fold_classic_conv_biases(variables: dict) -> dict:
    """Fold the released conv and fc biases into their BN running means, in
    place, and return ``variables``, for a classic model built with
    BatchNorm (its convs are bias-free): mean' = mean - bias, the
    invariance of ``fold_teacher_conv_biases`` (the JAX
    ``_fold_classic_conv_biases``)."""
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    for k in list(params):
        bn = f"bn_{k}"
        if bn in stats:
            bias = params[k].pop("bias", None)
            if bias is not None:
                stats[bn]["mean"] = (np.asarray(stats[bn]["mean"])
                                     - np.asarray(bias))
    return variables


def prepare_classic_from_base(mat_path: str | Path, name: str, *,
                              num_outputs: int = 8, seed: int = 0,
                              use_bnorm: Optional[bool] = None,
                              input_size: int = 224, download: bool = True,
                              device: torch.device | str = "cuda"
                              ) -> Tuple[nn.Module, Dict[str, torch.Tensor]]:
    """A classic VGG face base ``.mat`` (e.g. the 2622-way ``vgg_face``) ->
    a FER+-ready ``VGGFace`` (ferPlusZoo.m:44-59 names, :116-199 surgery):
    ``build_teacher(name, use_bnorm=..., input_size=...)``, the release
    imported into it (identity BatchNorm retrofitted where the model wants
    BN and the release has none), the conv biases folded into the BN means
    for a model with BatchNorm, the classifier resized to ``num_outputs``
    with the 1/100 re-init and zero biases from ``seed``. Returns
    ``(model, state_dict)`` on ``device``."""
    from mcncrossmodalemotions_torch.zoo.matconvnet import (
        import_classic_teacher,
        mat_cache_scope,
    )

    device = resolve_device(device, "prepare_classic_from_base")
    mat_path = _release_file(mat_path, download)
    model = build_teacher(name, num_outputs=num_outputs, use_bnorm=use_bnorm,
                          input_size=input_size)
    with mat_cache_scope():
        variables = import_classic_teacher(mat_path, model)
    if model.use_batchnorm:
        fold_classic_conv_biases(variables)
    state = reinit_head(teacher_state_dict_from_flax(variables), num_outputs,
                        seed, scale=1.0 / 100.0)
    return _loaded(model, state, device)


def student_loss_fn(loss_type: str = "hot-cross-ent", *,
                    temperature: float = 2.0,
                    num_classes: int = 8) -> Callable:
    """Student distillation loss stack: ``loss_fn(logits, batch) ->
    (loss, metrics)``, metrics ``classerror`` (against the teacher's max
    label), ``class_correct`` and ``class_pop`` (ErrorStats). Rows with
    ``batch['pad_mask'] == 0`` drop out of loss and metrics; under data
    parallelism ``batch['pad_total']`` (the whole batch's valid rows) is
    the means' denominator, so each rank returns its share of them."""

    def loss_fn(logits, batch):
        labels = batch["max_label"]
        w = dict(sample_weight=batch.get("pad_mask"),
                 total_weight=batch.get("pad_total"))
        if loss_type == "hot-cross-ent":
            loss = distillation_ce(logits, batch["logit_target"], temperature,
                                   **w)
        elif loss_type == "euclidean":
            loss = euclidean_loss(logits, batch["logit_target"],
                                  batch.get("instance_weights"), **w)
        elif loss_type == "huber":
            loss = huber_loss(logits, batch["logit_target"], sigma=1.0,
                              instance_weights=batch.get("instance_weights"),
                              **w)
        elif loss_type == "softmaxlog":
            loss = softmax_ce(logits, labels, **w)
        else:
            raise ValueError(f"unknown loss_type {loss_type!r}")
        correct, pop = per_class_stats(logits, labels, num_classes,
                                       sample_weight=w["sample_weight"])
        metrics = {
            "classerror": class_error(logits, labels, **w),
            "class_correct": correct,
            "class_pop": pop,
        }
        return loss, metrics

    return loss_fn


def teacher_loss_fn(loss_type: str = "distributions",
                    num_classes: int = 8) -> Callable:
    """Teacher loss stack (ferPlusZoo.m:239-255): ``'distributions'``, the
    cross-entropy against the rater-vote distributions
    (``batch['label_dist']``), or ``'softmaxlog'`` against the hard label;
    metrics ``classerror`` (against the hard label), ``class_correct`` and
    ``class_pop``. Rows with ``batch['pad_mask'] == 0`` drop out;
    ``batch['pad_total']`` as in ``student_loss_fn``."""

    def loss_fn(logits, batch):
        hard = batch["hard_label"]
        w = dict(sample_weight=batch.get("pad_mask"),
                 total_weight=batch.get("pad_total"))
        if loss_type == "distributions":
            loss = distribution_ce(logits, batch["label_dist"], **w)
        elif loss_type == "softmaxlog":
            loss = softmax_ce(logits, hard, **w)
        else:
            raise ValueError(f"unknown loss_type {loss_type!r}")
        correct, pop = per_class_stats(logits, hard, num_classes,
                                       sample_weight=w["sample_weight"])
        metrics = {
            "classerror": class_error(logits, hard, **w),
            "class_correct": correct,
            "class_pop": pop,
        }
        return loss, metrics

    return loss_fn


# Dev-checkpoint registry (ferPlusZoo.m:63-92): development model names
# pinned to training epochs inside their experiment directories, resolved
# to the checkpoints of this framework's experiment directories (the port's
# net-epoch-N.pt, or the JAX package's .msgpack, which
# ``exp.ferplus_baselines.load_teacher_from_exp`` also reads).
DEV_CHECKPOINTS = {
    "resnet50_ft-dag-dropout-0.1":
        ("grimaces/resnet50_ft-dag-dropout-0.1", 17),
    "resnet50_ft-dag-dropout-0.5":
        ("grimaces/resnet50_ft-dag-dropout-0.5", 122),
    "senet50_ft-dag-distributions-dropout-0.5-aug":
        ("grimaces/senet50_ft-dag-distributions-dropout-0.5-aug", 98),
    "senet50_ft-dag-distributions-CNTK-dropout-0.5-aug":
        ("grimaces/senet50_ft-dag-distributions-CNTK-dropout-0.5-aug", 90),
}


def _resolve_dev(name: str) -> Tuple[str, int]:
    """(exp subdir, pinned epoch) of a dev model name, or KeyError."""
    if name not in DEV_CHECKPOINTS:
        raise KeyError(f"unknown dev checkpoint {name!r}; known: "
                       f"{sorted(DEV_CHECKPOINTS)}")
    return DEV_CHECKPOINTS[name]


def dev_checkpoint_path(name: str, exps_root: str | Path) -> Path:
    """The port's checkpoint file of a dev model name at its pinned epoch
    (ferPlusZoo.m:63-92 'net-epoch-N')."""
    from mcncrossmodalemotions_torch.train.checkpoints import checkpoint_path

    subdir, epoch = _resolve_dev(name)
    return checkpoint_path(Path(exps_root) / subdir, epoch)


def load_dev_checkpoint(name: str, exps_root: str | Path,
                        device: torch.device | str = "cuda"):
    """A dev teacher by name at its pinned epoch (name -> exp dir + epoch
    -> the restored pipeline, losses stripped): ``(model, state_dict)``
    from ``exp.ferplus_baselines.load_teacher_from_exp``."""
    from mcncrossmodalemotions_torch.exp.ferplus_baselines import (
        load_teacher_from_exp,
    )

    subdir, epoch = _resolve_dev(name)
    return load_teacher_from_exp(Path(exps_root) / subdir, epoch=epoch,
                                 device=device)
