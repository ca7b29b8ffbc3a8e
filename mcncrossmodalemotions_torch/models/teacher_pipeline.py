"""Face-image pipeline: uint8 grayscale -> teacher logits (inference).

Port of ``FaceTeacherPipeline`` (``mcncrossmodalemotions_tpu/models/
teacher_pipeline.py:35-67``), its inference half (getImageBatch,
fetch_emovoxceleb_imdb.m:152-193):

    uint8 grayscale [B, H, W, 1] -> float32
    -> align-corners bilinear resize to ``input_size`` if the size differs
       (``ops/warp.resize_separable``)
    -> replicate to 3 channels -> subtract ``mean_rgb``
    -> the ResNet/SENet teacher.

The random fliplr of training waits with teacher training (ROADMAP.md
queue 1, item 13); ``train=True`` raises.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from mcncrossmodalemotions_torch.models.resnet import _TRAIN_LATER, ResNet
from mcncrossmodalemotions_torch.ops.warp import resize_separable

VGGFACE2_MEAN_RGB = (131.0912, 103.8827, 91.4953)


class FaceTeacherPipeline(nn.Module):
    """Device preprocessing + ResNet/SENet teacher as one module; the
    teacher's ``state_dict`` keys carry the ``teacher.`` prefix and are the
    whole ``state_dict`` (``mean_rgb`` is a constant, not a buffer).
    ``mean_rgb`` is the dataset mean subtracted after channel replication
    (the released models' ``normalization.averageImage``)."""

    def __init__(self, teacher: ResNet, input_size: int = 224,
                 mean_rgb: Sequence[float] = VGGFACE2_MEAN_RGB):
        super().__init__()
        self.teacher = teacher
        self.input_size = input_size
        self.mean_rgb = tuple(float(v) for v in mean_rgb)
        self._means: dict = {}  # (device, mean_rgb) -> the mean there

    def mean_on(self, device: torch.device) -> torch.Tensor:
        """``mean_rgb`` as a float32 tensor on ``device``, made once: a copy
        from pageable host memory at every forward would make the host wait
        there for the card to finish all it was given."""
        key = (torch.device(device), self.mean_rgb)
        if key not in self._means:
            with torch.inference_mode(False):  # usable outside it too
                self._means[key] = torch.tensor(self.mean_rgb,
                                                dtype=torch.float32,
                                                device=device)
        return self._means[key]

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        """[B, H, W, 1] uint8 (or float) grayscale -> logits [B, C] fp32."""
        if train:
            raise NotImplementedError(_TRAIN_LATER)
        x = x.float()
        if x.shape[1] != self.input_size or x.shape[2] != self.input_size:
            x = resize_separable(x, self.input_size, self.input_size)
        x = x.expand(-1, -1, -1, 3) - self.mean_on(x.device)  # gray -> 3 channels
        return self.teacher(x)
