"""The port's zoo (``mcncrossmodalemotions_tpu/zoo/registry.py``): the student's
``build_student`` (emoVoxZoo.m:25-31, scratch init :202-243),
``load_pretrained_student`` (the released weights, emoVoxZoo.m:25-44) and
``student_loss_fn`` (emoVoxZoo.m:137-169); the ResNet/SENet teachers'
``build_teacher`` (ferPlusZoo.m:37-92), ``load_pretrained_teacher``
(ferPlusZoo.m:103-114), ``release_mean_rgb`` and
``fold_teacher_conv_biases``. The classic VGG face teachers are not ported
yet (ROADMAP.md queue 1).

Released ``.mat`` files are read by the port's own copy of the MatConvNet
importer (``zoo/matconvnet.py``) and reach the model through the weight
bridge (``zoo/bridge.py``). The port takes a path: it has no release
registry and downloads nothing.
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
    euclidean_loss,
    huber_loss,
    per_class_stats,
    softmax_ce,
)
from mcncrossmodalemotions_torch.models.pipeline import AudioStudentPipeline
from mcncrossmodalemotions_torch.models.resnet import ResNet, ResNet50, SENet50
from mcncrossmodalemotions_torch.models.teacher_pipeline import (
    FaceTeacherPipeline,
)
from mcncrossmodalemotions_torch.models.vggm import VGGMStudent
from mcncrossmodalemotions_torch.ops.spectrogram import DEFAULT_SPEC, SpecConfig
from mcncrossmodalemotions_torch.utils.device import resolve_device
from mcncrossmodalemotions_torch.zoo.bridge import (
    student_state_dict_from_flax,
    teacher_state_dict_from_flax,
)

STUDENT_MODELS = ("emovoxceleb-student",)
TEACHER_MODELS = ("resnet50-ferplus", "senet50-ferplus")
# VGGFace2-pretrained bases (ferPlusZoo.m:37-42): the same architectures
VGGFACE2_MODELS = ("resnet50_ft-dag", "resnet50_scratch-dag",
                   "senet50_ft-dag", "senet50_scratch-dag")
# classic pre-ResNet face models (ferPlusZoo.m:44-59): not ported yet
CLASSIC_MODELS = ("vgg_face", "vgg-vd-face", "vgg-vd-face-fer",
                  "vgg-vd-face-sfew", "vgg-vd-face-sfew-dag",
                  "vgg-m-face-bn", "vgg-m-face-bn-fer")


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
    ``mat_path`` is a path; nothing is downloaded.
    """
    from mcncrossmodalemotions_torch.zoo.matconvnet import (
        import_vggm_student,
        mat_cache_scope,
    )

    device = resolve_device(device, "load_pretrained_student")
    if not Path(mat_path).is_file():
        raise FileNotFoundError(f"{mat_path}: no such release file (the port "
                                "takes a path and downloads nothing)")
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
                  tiny: bool = False) -> ResNet:
    """Teacher zoo (ferPlusZoo.m:37-92 registry, 8-way CNTK head): the
    ResNet/SENet names build ``models.resnet.ResNet``; ``tiny`` gives the
    JAX zoo's test variant (``stage_sizes=(1, 1)``, ``width=8``). ``dropout``
    is the single pooled-embedding dropout (inactive at inference). The
    classic VGG face names raise ``NotImplementedError``."""
    if name in CLASSIC_MODELS:
        raise NotImplementedError(
            f"{name!r} is a classic VGG face teacher (models/vggface.py of the "
            "JAX package), not ported yet; see ROADMAP.md queue 1")
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


def release_mean_rgb(mat_path: str | Path) -> Optional[Tuple[float, ...]]:
    """Per-channel mean from a release's ``normalization.averageImage``, an
    RGB 3-tuple, or None without one. A full HxWx3 average image (the
    classic releases) is reduced to its per-channel means; the VGGFace2
    dags store a 3-vector."""
    from mcncrossmodalemotions_torch.zoo.matconvnet import (
        load_mat_meta,
        mat_cache_scope,
    )

    with mat_cache_scope():
        avg = load_mat_meta(mat_path).get("averageImage")
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
    ``normalization.averageImage`` where it has one, and the keys carry
    its ``teacher.`` prefix. The ResNet computes in bf16; an fp32 caller
    sets its ``dtype`` (the pipeline's ``teacher.dtype``). ``mat_path`` is
    a path; nothing is downloaded.
    """
    from mcncrossmodalemotions_torch.zoo.matconvnet import (
        import_teacher,
        mat_cache_scope,
    )

    device = resolve_device(device, "load_pretrained_teacher")
    if not Path(mat_path).is_file():
        raise FileNotFoundError(f"{mat_path}: no such release file (the port "
                                "takes a path and downloads nothing)")
    with mat_cache_scope():  # params and meta from one parse
        arch, variables = import_teacher(mat_path)
        fold_teacher_conv_biases(arch, variables)
        model: nn.Module = ResNet(stage_sizes=arch["stage_sizes"],
                                  use_se=arch["use_se"], width=arch["width"],
                                  num_outputs=arch["num_outputs"])
        if with_pipeline:
            mean = release_mean_rgb(mat_path)
            kw = {"mean_rgb": mean} if mean is not None else {}
            model = FaceTeacherPipeline(model, input_size=input_size, **kw)
            variables = {"params": {"teacher": variables["params"]},
                         "batch_stats": {"teacher": variables["batch_stats"]}}
    state = teacher_state_dict_from_flax(variables)
    model.load_state_dict(state, strict=True)
    return (model.to(device).eval(),
            {k: v.to(device) for k, v in state.items()})


def student_loss_fn(loss_type: str = "hot-cross-ent", *,
                    temperature: float = 2.0,
                    num_classes: int = 8) -> Callable:
    """Student distillation loss stack: ``loss_fn(logits, batch) ->
    (loss, metrics)``, metrics ``classerror`` (against the teacher's max
    label), ``class_correct`` and ``class_pop`` (ErrorStats). Rows with
    ``batch['pad_mask'] == 0`` drop out of loss and metrics."""

    def loss_fn(logits, batch):
        labels = batch["max_label"]
        w = batch.get("pad_mask")
        if loss_type == "hot-cross-ent":
            loss = distillation_ce(logits, batch["logit_target"], temperature,
                                   sample_weight=w)
        elif loss_type == "euclidean":
            loss = euclidean_loss(logits, batch["logit_target"],
                                  batch.get("instance_weights"),
                                  sample_weight=w)
        elif loss_type == "huber":
            loss = huber_loss(logits, batch["logit_target"], sigma=1.0,
                              instance_weights=batch.get("instance_weights"),
                              sample_weight=w)
        elif loss_type == "softmaxlog":
            loss = softmax_ce(logits, labels, sample_weight=w)
        else:
            raise ValueError(f"unknown loss_type {loss_type!r}")
        correct, pop = per_class_stats(logits, labels, num_classes,
                                       sample_weight=w)
        metrics = {
            "classerror": class_error(logits, labels, sample_weight=w),
            "class_correct": correct,
            "class_pop": pop,
        }
        return loss, metrics

    return loss_fn
