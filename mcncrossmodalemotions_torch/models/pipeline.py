"""Waveform -> spectrogram -> student logits, as one module.

Port of ``mcncrossmodalemotions_tpu/models/pipeline.py``
(``AudioStudentPipeline``): the frontend has no parameters and passes no
gradient; the student is registered as ``net``, so its ``state_dict`` keys
carry the ``net.`` prefix, as the JAX variables nest under ``'net'``.
"""

from __future__ import annotations

import torch
from torch import nn

from mcncrossmodalemotions_torch.models.vggm import VGGMStudent
from mcncrossmodalemotions_torch.ops.spectrogram import (
    DEFAULT_SPEC,
    SpecConfig,
    waveform_to_input,
)


class AudioStudentPipeline(nn.Module):
    """Frontend + VGG-M student. Input: [B, N] waveforms (float32, int16
    PCM or uint8 mu-law)."""

    def __init__(self, spec: SpecConfig = DEFAULT_SPEC, num_outputs: int = 8,
                 fc6_features: int = 4096, fc7_features: int = 1024,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.spec = spec
        self.net = VGGMStudent(num_outputs=num_outputs,
                               fc6_features=fc6_features,
                               fc7_features=fc7_features, dtype=dtype)

    def frontend(self, x: torch.Tensor, valid_frames=None) -> torch.Tensor:
        with torch.no_grad():
            return waveform_to_input(x, self.spec, valid_frames=valid_frames)

    def forward(self, x: torch.Tensor, valid_frames=None,
                return_embedding: bool = False):
        feats = self.frontend(x, valid_frames=valid_frames)
        return self.net(feats, valid_frames=valid_frames,
                        return_embedding=return_embedding)
