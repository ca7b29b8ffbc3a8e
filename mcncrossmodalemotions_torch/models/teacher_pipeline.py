"""Face-image pipeline: uint8 grayscale -> teacher logits.

Port of ``FaceTeacherPipeline`` (``mcncrossmodalemotions_tpu/models/
teacher_pipeline.py``), the reference's preprocessing chain (getBatchFerPlus,
ferplus_baselines.m:181-213; getImageBatch, fetch_emovoxceleb_imdb.m:152-193):

    uint8 grayscale [B, H, W, 1] [-> host affine augmentation, train only]
    -> float32 -> random fliplr (train with ``augment``)
    -> align-corners bilinear resize to ``input_size`` if the size differs
       (``ops/warp.resize_separable``)
    -> replicate to 3 channels -> subtract ``mean_rgb``
    -> the teacher (``models/resnet.ResNet`` or ``models/vggface.VGGFace``).

The zoom/rotate/skew affine warp runs on the host at 48x48 inside the batch
loader (``data/ferplus.ferplus_batches(augment=True)``,
``ops/warp.augment_batch_np``), as in the JAX package: microseconds an
image there, and the host ships uint8. The fliplr draws its mask from the
caller's ``torch.Generator`` (``random_flip``); ``fliplr`` takes the mask
itself, so a test can hand both packages the same one (their random
streams cannot agree).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from mcncrossmodalemotions_torch.models.vggm import global_rows
from mcncrossmodalemotions_torch.ops.warp import (
    resize_separable,
    resize_weights,
)
from mcncrossmodalemotions_torch.parallel.mesh import DataMesh

VGGFACE2_MEAN_RGB = (131.0912, 103.8827, 91.4953)


def random_flip(batch: int, prob: float,
                generator: Optional[torch.Generator],
                mesh: Optional[DataMesh] = None) -> torch.Tensor:
    """[B] bool mask, True with probability ``prob``, drawn from
    ``generator`` (required) on its device; under ``mesh`` drawn for the
    global batch, this rank's rows kept (``models.vggm.global_rows``)."""
    if generator is None:
        raise ValueError("train-mode fliplr needs an explicit torch.Generator")
    total, rows = global_rows(batch, mesh)
    return torch.rand(total, generator=generator,
                      device=generator.device)[rows] < prob


def fliplr(x: torch.Tensor, flip: torch.Tensor) -> torch.Tensor:
    """Mirror the rows of NHWC ``x`` along the width where ``flip`` [B]."""
    return torch.where(flip.to(x.device)[:, None, None, None],
                       x.flip(2), x)


class FaceTeacherPipeline(nn.Module):
    """Device preprocessing + face teacher as one module; the teacher's
    ``state_dict`` keys carry the ``teacher.`` prefix and are the whole
    ``state_dict`` (``mean_rgb`` is a constant, not a buffer).
    ``mean_rgb`` is the dataset mean subtracted after channel replication
    (the released models' ``normalization.averageImage``); ``augment``
    turns on the train-mode fliplr, with probability ``flip_prob``."""

    def __init__(self, teacher: nn.Module, input_size: int = 224,
                 mean_rgb: Sequence[float] = VGGFACE2_MEAN_RGB,
                 augment: bool = True, flip_prob: float = 0.5):
        super().__init__()
        self.teacher = teacher
        self.input_size = input_size
        self.mean_rgb = tuple(float(v) for v in mean_rgb)
        self.augment = augment
        self.flip_prob = flip_prob
        self._means: dict = {}  # (device, mean_rgb) -> the mean there
        self._resizes: dict = {}  # (device, h, w, size) -> resize matrices

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """The teacher's scratch init."""
        self.teacher.reset_parameters(generator)

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

    def resize_on(self, height: int, width: int, device: torch.device):
        """The matrices resizing ``height`` x ``width`` frames to
        ``input_size`` on ``device``, made once (``mean_on``'s reason)."""
        key = (torch.device(device), height, width, self.input_size)
        if key not in self._resizes:
            with torch.inference_mode(False):
                self._resizes[key] = resize_weights(
                    height, width, self.input_size, self.input_size, device)
        return self._resizes[key]

    def forward(self, x: torch.Tensor, train: bool = False,
                return_embedding: bool = False,
                pad_mask: Optional[torch.Tensor] = None, *,
                generator: Optional[torch.Generator] = None,
                flip: Optional[torch.Tensor] = None,
                mesh: Optional[DataMesh] = None):
        """[B, H, W, 1] uint8 (or float) grayscale -> logits [B, C] fp32
        (and the teacher's embedding with ``return_embedding``). In train
        mode with ``augment`` the rows in ``flip`` (drawn from
        ``generator`` when not given) are mirrored; ``generator`` also
        feeds the teacher's dropout. Under ``mesh`` ``x`` is this rank's
        shard, and the draws and BatchNorm statistics the global batch's."""
        x = x.float()
        if train and self.augment:
            if flip is None:
                flip = random_flip(x.shape[0], self.flip_prob, generator,
                                   mesh)
            x = fliplr(x, flip)
        if x.shape[1] != self.input_size or x.shape[2] != self.input_size:
            x = resize_separable(x, self.input_size, self.input_size,
                                 self.resize_on(x.shape[1], x.shape[2],
                                                x.device))
        x = x.expand(-1, -1, -1, 3) - self.mean_on(x.device)  # gray -> 3 channels
        return self.teacher(x, train=train, return_embedding=return_embedding,
                            pad_mask=pad_mask, generator=generator, mesh=mesh)
