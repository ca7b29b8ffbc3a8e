"""Online (fused) distillation: the frozen teacher inside the student step.

Port of ``mcncrossmodalemotions_tpu/train/distill.py``. The reference
distils offline: the dense teacher build writes ``wav_logits``
(fetch_emovoxceleb_imdb.m:119-136) and the student trains on them
(getBatchEmoVoxCeleb.m:179-188). In the fused mode each step runs the face
teacher over the crop's K face frames on the card, aggregates its logits
over the frames by max or mean (getBatchEmoVoxCeleb.m:179-185) and trains
the student on those targets, with no round trip through the host.

The teacher is frozen: eval mode, no parameter requires grad, and its
forward runs under ``torch.no_grad()``, so autograd keeps none of its
activations (SENet50's over 256 frames would dwarf the student's). The
student's half is the standard step (``train.state.make_train_step``: the
same dropout, ``pad_mask``, remat policy and SGD), so the two steps cannot
drift apart. Under a data-parallel ``mesh`` each rank's frozen teacher
scores its own shard's frames, with no collective (eval mode reads the
running statistics), and the student's half is the data-parallel step.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from mcncrossmodalemotions_torch.parallel.mesh import DataMesh
from mcncrossmodalemotions_torch.train.state import (
    SGDConfig,
    TrainState,
    make_train_step,
)
from mcncrossmodalemotions_torch.zoo.registry import student_loss_fn


def aggregate_frame_logits(logits: torch.Tensor, aggregator: str) -> torch.Tensor:
    """[B, K, C] per-frame teacher logits -> [B, C] crop targets."""
    if aggregator == "max":
        return logits.amax(dim=1)
    if aggregator == "mean":
        return logits.mean(dim=1)
    raise ValueError(f"unknown aggregator {aggregator!r}")


def frozen(teacher: nn.Module) -> nn.Module:
    """``teacher`` in eval mode with no parameter requiring grad."""
    return teacher.eval().requires_grad_(False)


def teacher_targets(teacher: nn.Module, frames: torch.Tensor,
                    num_classes: int, aggregator: str) -> torch.Tensor:
    """[B, K, S, S, 1] uint8 face frames -> [B, num_classes] fp32 targets:
    the teacher's logits of the B x K frames in one forward, without
    autograd, truncated to ``num_classes`` and aggregated over K."""
    b, k = frames.shape[:2]
    with torch.no_grad():
        logits = teacher(frames.reshape((b * k,) + frames.shape[2:]),
                         train=False)
    return aggregate_frame_logits(
        logits.float().reshape(b, k, -1)[..., :num_classes], aggregator)


def make_online_distill_step(teacher: nn.Module,
                             loss_type: str = "hot-cross-ent",
                             temperature: float = 2.0,
                             aggregator: str = "max",
                             num_classes: int = 8,
                             sgd: SGDConfig = SGDConfig(weight_decay=0.0),
                             remat_policy: Optional[str] = None,
                             mesh: Optional[DataMesh] = None):
    """Fused step ``step(state, batch, lr) -> (state, metrics)``: ``batch``
    holds ``data`` ([B, N] waveforms) and ``frames`` ([B, K, H, W, 1]
    uint8). ``teacher`` (a ``FaceTeacherPipeline``, weights loaded, on the
    batch's device) is frozen in place. The student's step is
    ``make_train_step``'s with the distillation loss of ``loss_type`` at
    ``temperature`` and ``remat_policy``; a batch's ``pad_mask`` reaches
    the student's BatchNorm and the loss. The targets' ``max_label`` is
    their argmax and their ``instance_weights`` ones. ``mesh`` as in
    ``make_train_step``: ``batch`` is this rank's shard.
    """
    teacher = frozen(teacher)
    loss_fn = student_loss_fn(loss_type, temperature=temperature,
                              num_classes=num_classes)
    inner_step = make_train_step(loss_fn, sgd, remat_policy=remat_policy,
                                 pass_pad_mask=True, mesh=mesh)

    def step(state: TrainState, batch: Dict[str, torch.Tensor], lr):
        target = teacher_targets(teacher, batch["frames"], num_classes,
                                 aggregator)
        inner_batch = {
            "data": batch["data"],
            "logit_target": target,
            "max_label": target.argmax(dim=-1),
            "instance_weights": torch.ones_like(target),
        }
        if "pad_mask" in batch:  # padded rows stay out of BN and the loss
            inner_batch["pad_mask"] = batch["pad_mask"]
        return inner_step(state, inner_batch, lr)

    return step
