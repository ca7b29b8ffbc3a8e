"""Loss and metric library (mcnExtraLayers equivalents), PyTorch.

Port of ``mcncrossmodalemotions_tpu/losses/__init__.py``, function for
function and with the same semantics:

- ``distillation_ce``      SoftmaxCELoss(temperature, logitTargets=true):
                           the 'hot-cross-ent' distillation loss.
- ``distribution_ce``      cross-entropy against probability targets.
- ``softmax_ce``           one-hot 'softmaxlog' classification loss.
- ``euclidean_loss``       dagnn.EuclideanLoss (0.5 * sum of squares).
- ``huber_loss``           dagnn.HuberLoss(sigma).
- ``class_error``          'classerror' top-1 error metric.
- ``per_class_stats``      ErrorStats: per-class correct counts and
                           populations.
- ``softmax_t`` / ``log_softmax_t``  temperature (log-)softmax.

Batch-mean reductions; ``sample_weight`` ([B]) gives the weighted mean
``sum(w * x) / max(sum(w), 1)``, so that padded rows (weight 0) drop out
exactly. Under data parallelism each rank holds some rows of the batch:
``total_weight``, the ``sum(w)`` of the whole batch (all-reduced by the
step), replaces the local one in the denominator, so each rank's value is
its share of the global mean and the shares sum to it.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def softmax_t(logits: torch.Tensor, temperature: float = 1.0,
              axis: int = -1) -> torch.Tensor:
    """Temperature softmax (vl_nnsoftmaxt equivalent)."""
    return torch.softmax(logits / temperature, dim=axis)


def log_softmax_t(logits: torch.Tensor, temperature: float = 1.0,
                  axis: int = -1) -> torch.Tensor:
    return torch.log_softmax(logits / temperature, dim=axis)


def _wmean(per_row: torch.Tensor, sample_weight: Optional[torch.Tensor],
           total_weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean of per-row terms, optionally weighted by [B] weights, over
    ``total_weight`` (the whole batch's summed weight) where given."""
    if sample_weight is None and total_weight is None:
        return per_row.mean()
    num = (per_row if sample_weight is None
           else per_row * sample_weight.to(per_row.dtype)).sum()
    den = (sample_weight.to(per_row.dtype).sum() if total_weight is None
           else total_weight.to(per_row.dtype))
    return num / torch.clamp(den, min=1.0)


def distillation_ce(student_logits: torch.Tensor, teacher_logits: torch.Tensor,
                    temperature: float = 2.0,
                    sample_weight: Optional[torch.Tensor] = None,
                    total_weight: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """-sum softmax(teacher/T) * log_softmax(student/T), batch mean; not
    rescaled by T^2 (the MATLAB convention)."""
    targets = softmax_t(teacher_logits, temperature)
    logp = log_softmax_t(student_logits, temperature)
    return -_wmean((targets * logp).sum(dim=-1), sample_weight, total_weight)


def distribution_ce(logits: torch.Tensor, target_probs: torch.Tensor,
                    sample_weight: Optional[torch.Tensor] = None,
                    total_weight: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """Cross-entropy against probability-distribution targets."""
    logp = torch.log_softmax(logits, dim=-1)
    return -_wmean((target_probs * logp).sum(dim=-1), sample_weight,
                   total_weight)


def softmax_ce(logits: torch.Tensor, labels: torch.Tensor,
               sample_weight: Optional[torch.Tensor] = None,
               total_weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One-hot cross-entropy ('softmaxlog'); ``labels`` are int class ids."""
    logp = torch.log_softmax(logits, dim=-1)
    per_row = -logp.gather(-1, labels.long()[:, None])[:, 0]
    return _wmean(per_row, sample_weight, total_weight)


def euclidean_loss(pred: torch.Tensor, target: torch.Tensor,
                   instance_weights: Optional[torch.Tensor] = None,
                   sample_weight: Optional[torch.Tensor] = None,
                   total_weight: Optional[torch.Tensor] = None
                   ) -> torch.Tensor:
    """0.5 * per-sample sum of squares, batch mean; optional per-element
    instance weights."""
    diff = pred - target
    sq = diff * diff
    if instance_weights is not None:
        sq = sq * instance_weights
    return 0.5 * _wmean(sq.sum(dim=-1), sample_weight, total_weight)


def huber_loss(pred: torch.Tensor, target: torch.Tensor, sigma: float = 1.0,
               instance_weights: Optional[torch.Tensor] = None,
               sample_weight: Optional[torch.Tensor] = None,
               total_weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Elementwise 0.5*(sigma*d)^2 for |d| < 1/sigma^2, else
    |d| - 0.5/sigma^2; summed per sample, batch mean."""
    d = pred - target
    abs_d = d.abs()
    quad = 0.5 * (sigma * d) ** 2
    lin = abs_d - 0.5 / (sigma ** 2)
    per_elem = torch.where(abs_d < 1.0 / (sigma ** 2), quad, lin)
    if instance_weights is not None:
        per_elem = per_elem * instance_weights
    return _wmean(per_elem.sum(dim=-1), sample_weight, total_weight)


def class_error(logits: torch.Tensor, labels: torch.Tensor,
                sample_weight: Optional[torch.Tensor] = None,
                total_weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Top-1 classification error in [0, 1]."""
    pred = logits.argmax(dim=-1)
    return _wmean((pred != labels.long()).float(), sample_weight,
                  total_weight)


def per_class_stats(logits: torch.Tensor, labels: torch.Tensor,
                    num_classes: int,
                    sample_weight: Optional[torch.Tensor] = None):
    """(correct[num_classes], population[num_classes]), float32."""
    labels = labels.long()
    pred = logits.argmax(dim=-1)
    one_hot = F.one_hot(labels, num_classes).float()
    if sample_weight is not None:
        one_hot = one_hot * sample_weight[:, None].float()
    correct = one_hot * (pred == labels)[:, None].float()
    return correct.sum(dim=0), one_hot.sum(dim=0)
