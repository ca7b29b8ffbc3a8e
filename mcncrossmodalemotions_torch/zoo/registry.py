"""Student zoo, the student half of ``mcncrossmodalemotions_tpu/zoo/registry.py``:
``build_student`` (emoVoxZoo.m:25-31, scratch init :202-243) and
``student_loss_fn`` (emoVoxZoo.m:137-169).

Released weights are not loaded here yet: the JAX package's ``.mat``
importer sits behind ``zoo/__init__.py``, which imports flax.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from mcncrossmodalemotions_torch.losses import (
    class_error,
    distillation_ce,
    euclidean_loss,
    huber_loss,
    per_class_stats,
    softmax_ce,
)
from mcncrossmodalemotions_torch.models.pipeline import AudioStudentPipeline
from mcncrossmodalemotions_torch.models.vggm import VGGMStudent
from mcncrossmodalemotions_torch.ops.spectrogram import DEFAULT_SPEC, SpecConfig

STUDENT_MODELS = ("emovoxceleb-student",)


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
