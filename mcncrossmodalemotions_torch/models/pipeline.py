"""Waveform -> spectrogram -> student logits, as one module.

Port of ``mcncrossmodalemotions_tpu/models/pipeline.py``
(``AudioStudentPipeline``): the frontend has no parameters and passes no
gradient (it runs under ``torch.no_grad()``, as the JAX frontend sits
behind ``jax.lax.stop_gradient``); the student is registered as ``net``,
so its ``state_dict`` keys carry the ``net.`` prefix, as the JAX variables
nest under ``'net'``.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from mcncrossmodalemotions_torch.models.vggm import VGGMStudent
from mcncrossmodalemotions_torch.ops.spectrogram import (
    DEFAULT_SPEC,
    SpecConfig,
    waveform_to_input,
)
from mcncrossmodalemotions_torch.parallel.mesh import DataMesh


class AudioStudentPipeline(nn.Module):
    """Frontend + VGG-M student. Input: [B, N] waveforms (float32, int16
    PCM or uint8 mu-law). ``conv1_s2d`` is the student's
    (``VGGMStudent``; the JAX default is True, the port's False)."""

    def __init__(self, spec: SpecConfig = DEFAULT_SPEC, num_outputs: int = 8,
                 dropout_rate: float = 0.0, fc6_features: int = 4096,
                 fc7_features: int = 1024, head_init_scale: float = 1e-4,
                 dtype: torch.dtype = torch.bfloat16,
                 generator: Optional[torch.Generator] = None,
                 conv1_s2d: bool = False):
        super().__init__()
        self.spec = spec
        self.net = VGGMStudent(num_outputs=num_outputs,
                               fc6_features=fc6_features,
                               fc7_features=fc7_features,
                               dropout_rate=dropout_rate,
                               head_init_scale=head_init_scale, dtype=dtype,
                               generator=generator, conv1_s2d=conv1_s2d)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """The student's scratch init (``VGGMStudent.reset_parameters``)."""
        self.net.reset_parameters(generator)

    def frontend(self, x: torch.Tensor, valid_frames=None,
                 use_kernels: bool = True) -> torch.Tensor:
        with torch.no_grad():
            return waveform_to_input(x, self.spec, valid_frames=valid_frames,
                                     use_kernel=use_kernels)

    def forward(self, x: torch.Tensor, train: bool = False, valid_frames=None,
                return_embedding: bool = False,
                pad_mask: Optional[torch.Tensor] = None, *,
                use_kernels: bool = True,
                generator: Optional[torch.Generator] = None,
                remat_policy: Optional[str] = None,
                mesh: Optional[DataMesh] = None):
        """``use_kernels`` runs the spectrogram through K1 and pool1/pool2
        through K2 on the card; False runs their plain versions.
        ``remat_policy`` and ``mesh`` apply to the student (the frontend
        keeps no activations for the backward and normalises each row on
        its own)."""
        feats = self.frontend(x, valid_frames=valid_frames,
                              use_kernels=use_kernels)
        return self.net(feats, train=train, valid_frames=valid_frames,
                        return_embedding=return_embedding, pad_mask=pad_mask,
                        use_kernels=use_kernels, generator=generator,
                        remat_policy=remat_policy, mesh=mesh)
