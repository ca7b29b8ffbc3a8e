"""Student zoo, the half of ``mcncrossmodalemotions_tpu/zoo/registry.py``
that the extraction slice needs (``build_student``, emoVoxZoo.m:25-31).

Released weights are not loaded here yet: the JAX package's ``.mat``
importer sits behind ``zoo/__init__.py``, which imports flax.
"""

from __future__ import annotations

import torch

from mcncrossmodalemotions_torch.models.pipeline import AudioStudentPipeline
from mcncrossmodalemotions_torch.models.vggm import VGGMStudent
from mcncrossmodalemotions_torch.ops.spectrogram import DEFAULT_SPEC, SpecConfig

STUDENT_MODELS = ("emovoxceleb-student",)


def build_student(name: str = "emovoxceleb-student", *,
                  num_outputs: int = 8,
                  spec: SpecConfig = DEFAULT_SPEC,
                  with_frontend: bool = True,
                  tiny: bool = False,
                  dtype: torch.dtype = torch.bfloat16):
    """The waveform->logits pipeline (``with_frontend``) or the bare
    spectrogram-input VGG-M. ``tiny`` gives the JAX zoo's width-reduced
    test variant (fc6 64, fc7 32)."""
    if name not in STUDENT_MODELS:
        raise KeyError(f"unknown student {name!r}; known: {STUDENT_MODELS}")
    kw = dict(num_outputs=num_outputs, dtype=dtype)
    if tiny:
        kw.update(fc6_features=64, fc7_features=32)
    if with_frontend:
        return AudioStudentPipeline(spec=spec, **kw)
    return VGGMStudent(**kw)
